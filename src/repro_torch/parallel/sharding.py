"""Logical-axis sharding: one source of truth for parameter placement.

The port of :mod:`repro.parallel.sharding`.  Every parameter is declared
as a :class:`ParamSpec` carrying its *logical* axis names; a tree of
specs (nested dicts, the reference's pytree paths as keys) yields the
initialised parameters, the parameter count, meta-tensor stand-ins
(:func:`abstract_params`) and, through the rule table, each parameter's
placement on a mesh.

A placement ("spec") is what the reference's ``PartitionSpec`` holds: a
tuple with one entry per dimension, each ``None`` (replicated), a mesh
axis name, or a tuple of names.  A mesh is anything with
``mesh_dim_names`` and ``shape`` -- a ``torch.distributed.DeviceMesh``,
or an :class:`AbstractMesh` where only the axis sizes matter (specs,
dry runs) -- and the spec functions read only those.

On a mesh each process is one rank.  :func:`mesh_groups` gives its
place on the ``data`` axes (``pod`` folded in, as ``LOGICAL_RULES
["batch"]`` does) and on ``model``; :func:`shard_params` takes the
rank's shard of each whole leaf by its spec and :func:`gather_params`
puts the whole leaves back together on the host.  The layers split
their work over ``model`` themselves (:mod:`repro_torch.parallel.
tensor`), and each data rank holds its own rows of the batch, so
:func:`shard_act` is the identity on values, mesh or not: the reference
uses it to constrain GSPMD's layout of activations, and the port has no
compiler to constrain.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .tensor import AxisGroup

__all__ = [
    "ParamSpec", "LOGICAL_RULES", "AbstractMesh", "mesh_axis_sizes",
    "logical_to_pspec", "param_pspecs", "prune_pspec", "param_shardings",
    "init_params", "abstract_params", "stack_specs", "shard_act",
    "activate_mesh", "active_mesh", "MeshGroups", "mesh_groups",
    "shard_leaf", "shard_params", "gather_params", "local_shape",
    "count_params", "map_specs",
]

# logical axis -> mesh axis (None = replicated).  DP batch over pod+data,
# TP over model for heads / ffn / vocab, EP: experts over model.
LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_group": ("pod", "data"),
    "inner": "model",       # mamba d_inner / rg-lru width
    "state": None,
    "conv": None,
    "lora": None,           # MLA compressed dims stay replicated
    "layers": None,         # stacked-layers leading axis
    "zero": "data",         # ZeRO-1 optimizer-state sharding axis
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices behind them (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} vs axes "
                             f"{self.mesh_dim_names}")


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """This rank's groups on a mesh: ``data`` (the batch's axes, ``pod``
    and ``data`` flattened), ``zero`` (the ``data`` axis alone, over
    which ``zero1_shardings`` slices the AdamW moments) and ``model``."""
    data: AxisGroup
    zero: AxisGroup
    model: AxisGroup


_ONE = AxisGroup(None, 0, 1)
_MESH_AXES = ("pod", "data", "model")


def _axis_group(mesh, axes) -> AxisGroup:
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not axes:
        return _ONE
    size = int(np.prod([sizes[a] for a in axes]))
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    if len(axes) > 1:
        sub = sub._flatten()
    group = sub.get_group()
    if dist.get_world_size(group) != size:
        raise RuntimeError(f"mesh axes {axes} of {size} ranks; their "
                           f"process group has {dist.get_world_size(group)}")
    return AxisGroup(group, sub.get_local_rank(), size)


def mesh_groups(mesh) -> MeshGroups:
    """This process's :class:`MeshGroups` on ``mesh`` (every group of one
    rank without a mesh).

    Raises ``ValueError`` for an axis other than ``pod``, ``data`` and
    ``model`` of size > 1, and for an axis of size > 1 on a mesh with no
    process group behind it (an :class:`AbstractMesh`); a group whose
    size differs from its axis's raises ``RuntimeError``."""
    if mesh is None:
        return MeshGroups(_ONE, _ONE, _ONE)
    sizes = mesh_axis_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a not in _MESH_AXES and n > 1}
    if other:
        raise ValueError(f"mesh axes {other}: the port runs on pod, data "
                         f"and model axes only")
    wide = {a: n for a, n in sizes.items() if n > 1}
    if wide and not hasattr(mesh, "get_group"):
        raise ValueError(f"mesh axes {wide} (model axis "
                         f"{sizes.get('model', 1)}) on a mesh with no "
                         f"process group: open one and build a DeviceMesh")
    return MeshGroups(data=_axis_group(mesh, ("pod", "data")),
                      zero=_axis_group(mesh, ("data",)),
                      model=_axis_group(mesh, ("model",)))


def _coords(mesh, coords) -> Dict[str, int]:
    """Each axis's index of this rank (``coords`` overrides; an
    :class:`AbstractMesh` is at index 0 of each axis)."""
    sizes = mesh_axis_sizes(mesh)
    if coords is not None:
        return {a: int(coords.get(a, 0)) for a in sizes}
    if not hasattr(mesh, "get_local_rank"):
        return {a: 0 for a in sizes}
    return {a: (mesh.get_local_rank(a) if n > 1 else 0)
            for a, n in sizes.items()}


def _dim_split(s, sizes, at) -> Tuple[int, int]:
    """``(index, count)`` of this rank among a dimension's shards for one
    entry of a spec (a mesh axis, a tuple of them row-major, or None)."""
    if s is None:
        return 0, 1
    index, count = 0, 1
    for a in (s if isinstance(s, tuple) else (s,)):
        index = index * sizes[a] + at[a]
        count *= sizes[a]
    return index, count


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One rank's shape of a leaf of ``shape`` placed by ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    at = {a: 0 for a in sizes}
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _dim_split(s, sizes, at)[1]
                 for n, s in zip(shape, spec))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _map_leaves(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, shardings[k]) for k, v in tree.items()}
    if not _is_spec(shardings):
        raise ValueError(f"a subtree of specs {shardings!r} where a leaf "
                         f"lies")
    return fn(tree, shardings)


def shard_leaf(x, spec, mesh, coords=None):
    """This rank's shard of one whole leaf (a view): along each dimension
    ``spec`` names, the slice at this rank's index on those axes.
    ``coords`` ({axis: index}) places the rank by hand (default: the
    mesh's own rank)."""
    sizes = mesh_axis_sizes(mesh)
    at = _coords(mesh, coords)
    for dim, s in enumerate(spec):
        index, count = _dim_split(s, sizes, at)
        if count > 1:
            if x.shape[dim] % count:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does "
                                 f"not split into {count}")
            n = x.shape[dim] // count
            x = x.narrow(dim, index * n, n)
    return x


def shard_params(tree, shardings, mesh, coords=None):
    """This rank's shard of each whole leaf of ``tree`` (views), each
    placed by its spec (``param_shardings``) as :func:`shard_leaf`
    does."""
    return _map_leaves(lambda x, spec: shard_leaf(x, spec, mesh, coords),
                       tree, shardings)


def gather_params(tree, shardings, mesh):
    """The whole leaves of a tree of this rank's shards, on the host:
    each sharded dimension put together by an ``all_reduce`` of a
    zero-filled whole buffer over the process group of its axis (on the
    leaves' device), then copied to the CPU.  Every rank of the mesh
    calls it and every rank gets the whole tree."""
    sizes = mesh_axis_sizes(mesh)
    at = _coords(mesh, None)

    def one(x, spec):
        for dim, s in enumerate(spec):
            index, count = _dim_split(s, sizes, at)
            if count == 1:
                continue
            if isinstance(s, tuple):
                raise ValueError(f"spec {spec}: a leaf split over several "
                                 f"axes at once is not gathered")
            shape = list(x.shape)
            shape[dim] *= count
            whole = x.new_zeros(shape)
            whole.narrow(dim, index * x.shape[dim],
                         x.shape[dim]).copy_(x)
            dist.all_reduce(whole, group=mesh.get_group(s))
            x = whole
        return x.detach().cpu()

    return _map_leaves(one, tree, shardings)


def logical_to_pspec(logical, rules=None, mesh=None) -> Tuple:
    """The spec of one parameter from its logical axis names: each name's
    mesh axis by the rules, dropped where the mesh lacks it or where an
    earlier dimension took it (a mesh axis appears at most once)."""
    rules = rules or LOGICAL_RULES
    mesh_axes = set(mesh.mesh_dim_names) if mesh is not None else None
    axes = []
    used = set()
    for name in logical:
        ax = rules.get(name) if name is not None else None
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax
                       if a not in used
                       and (mesh_axes is None or a in mesh_axes))
            ax = ax if ax else None
        elif ax is not None and mesh_axes is not None and ax not in mesh_axes:
            ax = None
        if ax is None:
            axes.append(None)
        else:
            flat = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in flat):
                axes.append(None)      # a mesh axis may appear only once
                continue
            used.update(flat)
            axes.append(ax)
    return tuple(axes)


def param_pspecs(specs, rules=None, mesh=None):
    return map_specs(lambda _p, s: logical_to_pspec(s.logical, rules, mesh),
                     specs)


def prune_pspec(spec: Tuple, shape, mesh) -> Tuple:
    """Drop mesh axes from dims they don't divide (the reference prefers
    replication to GSPMD's padded uneven shards)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None or i >= len(shape):
            out.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(s if (n > 0 and shape[i] % n == 0) else None)
    return tuple(out)


def param_shardings(specs, mesh, rules=None):
    """Each parameter's spec on ``mesh``, pruned to the dims it divides."""
    return map_specs(
        lambda _p, s: prune_pspec(logical_to_pspec(s.logical, rules, mesh),
                                  s.shape, mesh), specs)


def map_specs(fn: Callable, specs, path: Tuple[str, ...] = ()):
    """``fn(path, spec)`` over every leaf of a spec tree (nested dicts);
    ``path`` is the tuple of keys from the root, as the reference's
    pytree paths."""
    if isinstance(specs, ParamSpec):
        return fn(path, specs)
    return {k: map_specs(fn, v, path + (k,)) for k, v in specs.items()}


def _path_seed(path) -> int:
    s = "/".join(str(k) for k in path)
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:4], "little")


def init_params(specs, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", mesh=None):
    """Materialise a spec tree as a tree of tensors on ``device``.

    Each leaf draws from its own ``torch.Generator`` on ``device``, seeded
    from the leaf's path (:func:`_path_seed`, the reference's per-leaf
    fold) offset by ``seed``, so a leaf's values do not depend on the rest
    of the tree.  The values are the port's own (torch's generators, not JAX's
    threefry), and a CUDA generator draws other values than the CPU's:
    to run two devices on the same weights, initialise on one and copy.

    With ``mesh``, each leaf is this rank's shard of that whole leaf (its
    ``param_shardings`` spec), cut as soon as the leaf is drawn: at most
    one whole leaf is alive at a time.
    """
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    device = torch.device(device)

    def one(path, spec: ParamSpec):
        x = whole(path, spec)
        if mesh is None:
            return x
        pspec = prune_pspec(logical_to_pspec(spec.logical, None, mesh),
                            spec.shape, mesh)
        part = shard_leaf(x, pspec, mesh)
        # a copy of a proper slice, so the whole leaf is freed
        return x if part.numel() == x.numel() else part.clone(
            memory_format=torch.contiguous_format)

    def whole(path, spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        # 32 bits: the CPU generator keeps only the low word of a seed
        gen.manual_seed((_path_seed(path) + seed * 0x9E3779B1) % 2 ** 32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)

    return map_specs(one, specs)


def abstract_params(specs, dtype=torch.bfloat16):
    """The spec tree as ``device="meta"`` tensors (shapes and dtypes, no
    storage; the reference's ``ShapeDtypeStruct``s)."""
    return map_specs(
        lambda _p, s: torch.empty(s.shape, dtype=dtype, device="meta"),
        specs)


def stack_specs(specs, n_layers: int):
    """Prepend a stacked-layers axis to every leaf (the body's layers)."""
    return map_specs(
        lambda _p, s: ParamSpec((n_layers,) + s.shape,
                                ("layers",) + s.logical,
                                init=s.init, scale=s.scale), specs)


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return int(np.prod(specs.shape))
    return sum(count_params(v) for v in specs.values())


# ---------------------------------------------------------------------------
# active mesh context (per thread, as the reference's)
# ---------------------------------------------------------------------------
_STATE = threading.local()


class activate_mesh:
    """``with activate_mesh(mesh):`` makes ``mesh`` this thread's active
    mesh (:func:`active_mesh`) for the block."""

    def __init__(self, mesh, rules=None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self.prev = (getattr(_STATE, "mesh", None),
                     getattr(_STATE, "rules", None))
        _STATE.mesh, _STATE.rules = self.mesh, self.rules
        return self

    def __exit__(self, *exc):
        _STATE.mesh, _STATE.rules = self.prev
        return False


def active_mesh():
    return getattr(_STATE, "mesh", None)


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """An activation's sharding constraint by logical axis names: the
    identity on values, with or without an active mesh.  The reference's
    constraint guides GSPMD's layout and never changes a value; the port
    has no such compiler, and its data-parallel ranks each hold their
    own rows already."""
    return x
