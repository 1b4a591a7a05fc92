"""Tensor parallelism over the mesh's ``model`` axis: the collectives.

The reference lets GSPMD split heads, FFN, vocabulary, experts and the
recurrent width over ``model`` by ``LOGICAL_RULES`` and inserts the
collectives itself.  The port places each rank's shard of every leaf
(:func:`repro_torch.parallel.sharding.shard_params`) and writes the
collectives into the layers, Megatron style.  Every activation between
two layers is whole and equal on every model rank ("replicated"), and so
is its gradient.  A layer that splits its work enters a *partial* region
with :func:`enter` and leaves it with :func:`leave`:

* :func:`enter` -- the identity forward and an ``all_reduce`` backward:
  each rank's share of the gradient of a replicated value is summed;
* :func:`leave` -- an ``all_reduce`` forward (each rank's partial sum,
  as after a row-parallel product) and the identity backward;
* :func:`gather` -- a leaf's whole value from its shards, for a layer
  whose split does not fall on whole units (heads, experts, blocks): an
  ``all_reduce`` of a zero-filled whole buffer that holds this rank's
  shard in place.  Its backward is this rank's slice of the gradient,
  so a gathered leaf used in a partial region goes through
  :func:`enter` as well (the sum, then the slice);
* :func:`all_max` -- an ``all_reduce`` with ``MAX``, no gradient (the
  vocabulary-parallel cross entropy's stabiliser).

So a step dispatches no collective but ``all_reduce``.  :data:`GATHERED`
counts the gathers by the name each call site gives (``attn.wk``,
``mamba.in_proj``, ``cache.conv``, ``logits``, ...): the dry run reports
which leaves a configuration gathers.  Each takes the
:class:`AxisGroup` explicitly; ``None`` (or a group of one rank) makes
every function the identity, so a model with no mesh runs exactly the
code it ran before the split.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "enter", "leave", "gather", "all_max", "shard",
           "splits", "part", "span", "GATHERED"]

#: gathers since the last ``GATHERED.clear()``, by call-site name
GATHERED: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's place on one mesh axis (``model``, or the data axes):
    the axis's process group (``None`` for one rank), this rank's index
    on it and its size."""
    group: Any
    rank: int
    size: int

    def splits(self, n: int) -> bool:
        """Whether the axis splits a dimension of ``n`` (``prune_pspec``'s
        rule: it must divide ``n``)."""
        return self.size > 1 and n % self.size == 0

    def part(self, n: int) -> int:
        """This rank's share of a dimension of ``n``."""
        return n // self.size if self.splits(n) else n

    def span(self, n: int) -> slice:
        """This rank's indices of a dimension of ``n``."""
        if not self.splits(n):
            return slice(0, n)
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _on(tp: Optional[AxisGroup]) -> bool:
    return tp is not None and tp.size > 1


def splits(tp: Optional[AxisGroup], n: int) -> bool:
    return _on(tp) and tp.splits(n)


def part(tp: Optional[AxisGroup], n: int) -> int:
    return tp.part(n) if _on(tp) else n


def span(tp: Optional[AxisGroup], n: int) -> slice:
    return tp.span(n) if _on(tp) else slice(0, n)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, lo, n):
        ctx.dim, ctx.lo, ctx.k = dim, lo, x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n
        whole = x.new_zeros(shape)
        whole.narrow(dim, lo, x.shape[dim]).copy_(x)
        dist.all_reduce(whole, group=group)
        return whole

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.k), None, None, None, None


def enter(x: torch.Tensor, tp: Optional[AxisGroup]) -> torch.Tensor:
    """Enter a partial region: identity forward, ``all_reduce`` backward."""
    return _Enter.apply(x, tp.group) if _on(tp) else x


def leave(x: torch.Tensor, tp: Optional[AxisGroup]) -> torch.Tensor:
    """Leave a partial region: ``all_reduce`` forward, identity backward."""
    return _Leave.apply(x, tp.group) if _on(tp) else x


def gather(x: torch.Tensor, tp: Optional[AxisGroup], dim: int,
           n: int, name: str = "") -> torch.Tensor:
    """The whole of a dimension of ``n`` from each rank's shard along
    ``dim`` (``x`` itself where the axis does not split ``n``); ``name``
    is counted in :data:`GATHERED`."""
    if not splits(tp, n):
        return x
    GATHERED[name] += 1
    dim = dim % x.dim()
    if x.shape[dim] != n // tp.size:
        raise ValueError(f"a shard of {x.shape[dim]} along dim {dim}; the "
                         f"model axis of {tp.size} splits {n} into "
                         f"{n // tp.size}")
    return _Gather.apply(x, tp.group, dim, tp.span(n).start, n)


def shard(x: torch.Tensor, tp: Optional[AxisGroup], dim: int,
          n: Optional[int] = None) -> torch.Tensor:
    """This rank's slice along ``dim`` of a whole dimension of ``n``
    (default: ``x``'s); ``x`` itself where the axis does not split it."""
    n = x.shape[dim] if n is None else n
    if not splits(tp, n):
        return x
    s = tp.span(n)
    return x.narrow(dim, s.start, s.stop - s.start)


def all_max(x: torch.Tensor, tp: Optional[AxisGroup]) -> torch.Tensor:
    """The elementwise maximum over the model ranks, with no gradient."""
    x = x.detach()
    return _all_reduce(x, tp.group, dist.ReduceOp.MAX) if _on(tp) else x
