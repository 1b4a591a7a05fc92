"""Trees of tensors: the few ``jax.tree`` operations the training slice
needs, on nested dicts (and lists or tuples) with tensor or array leaves.

Leaves come in the reference's order -- a dict's keys sorted, a list's
items by index -- so a walk of a tree here visits its leaves as
``jax.tree.leaves`` does, and a leaf's path is the reference's
(``("body", "0", "attn", "wq")``).  ``None`` is an empty subtree, as in
JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_items", "tree_unflatten"]


def _children(tree) -> List[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in the reference's leaf order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield path, tree
        return
    for k, v in _children(tree):
        yield from tree_items(v, path + (k,))


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    return _build(like, iter(leaves))


def _build(t, it):
    # module level, not a closure over itself: a self-referencing closure
    # is a cycle that would keep ``leaves`` (gradients) alive until the
    # garbage collector runs
    if t is None:
        return None
    if not _is_node(t):
        return next(it)
    built = {k: _build(v, it) for k, v in _children(t)}
    if isinstance(t, dict):
        return {k: built[k] for k in t}
    return type(t)(built[i] for i in range(len(t)))
