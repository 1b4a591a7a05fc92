"""The counted cost of a step: the aten and c10d operations one call
dispatches.

The port of :mod:`repro.launch.hlo_cost`, under the same name so the two
modules pair one to one.  The reference walks XLA's optimized HLO text
and multiplies each ``while`` body by its trip count.  There is no HLO
here: eager PyTorch dispatches one aten operation per kernel, and
:func:`analyze_step` counts those operations as a call runs them, under
a ``TorchDispatchMode``.  Given ``device="meta"`` arguments -- the step
builders' structs, at full width -- nothing is computed and no memory is
taken.  It accumulates:

* ``flops`` -- products at 2 * MACs by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm`` -- the lowerings of
  ``einsum`` and ``matmul`` -- convolution and scaled-dot-product
  attention, when dispatched); elementwise operations (aten's
  ``pointwise`` tag, copies and fills aside) one per output element, as
  the reference's ``_ELEMENTWISE``; reductions, as there, none;
* ``bytes`` -- an HBM traffic model: operand plus result bytes of every
  operation, since each eager operation is its own kernel and nothing is
  fused.  Views and metadata operations count 0 (the reference's
  ``_ZERO_BYTES_OPS``); gathers (``index_select``, ``gather``,
  ``embedding``, advanced indexing) twice their result and in-place
  scatters (``index_put_``, ``scatter_``, ``index_add_``, ...) twice
  their update window (``_WINDOW_READ_OPS`` / ``_WINDOW_WRITE_OPS``);
  an out-of-place scatter copies its whole input and counts as any op;
* ``coll_bytes`` -- the c10d collectives by class, under the reference's
  ``parse_collectives`` conventions (:mod:`repro_torch.launch.roofline`):
  an all-reduce or all-to-all counts its tensor, an all-gather its
  operand (result over the group size), a reduce-scatter its operand
  (result times the group size) -- each the tensor the op reads, so
  the group size of the op's process group is in it -- and a ``send``
  (with its ``recv``) is a ``collective-permute``.

There is no trip-count multiplier: a Python loop runs every layer, so
each operation is counted as often as it runs (a remat recompute too).
``compiled_cost_dict`` has no counterpart: there is no compiled
executable whose own cost analysis could be read.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["analyze_step", "COLL_CLASSES"]

COLL_CLASSES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_aten = torch.ops.aten
#: pointwise-tagged operations that move values and compute nothing
_NO_FLOP = {_aten.clone, _aten._to_copy, _aten.copy_, _aten.copy,
            _aten.fill_, _aten.fill, _aten.lift_fresh_copy}
#: operations that allocate or read metadata: no bytes
_ZERO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten._unsafe_view,
               _aten._local_scalar_dense, _aten.lift_fresh, _aten.set_,
               _aten.resize_, _aten.sym_size, _aten.sym_stride,
               _aten.sym_numel, _aten.is_same_size}
#: operations that read a result-sized window of their operand
_WINDOW_READ = {_aten.index_select, _aten.gather, _aten.embedding,
                _aten.index, _aten.take}
#: in-place operations that write an update-sized window: (op, position
#: of the update operand)
_WINDOW_WRITE = {_aten.index_put_: 2, _aten.scatter_: 3,
                 _aten.scatter_add_: 3, _aten.index_add_: 3,
                 _aten.index_copy_: 3, _aten.masked_scatter_: 2}
#: c10d operations: class and the position of the tensor they read
_COLLECTIVES = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _is_view(func) -> bool:
    """The op returns an alias of an input that it does not write."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = self.dot_flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: Dict[str, float] = defaultdict(float)
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.coll = {c: 0 for c in COLL_CLASSES}
        self.coll_count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite op (``matmul``, ``einsum`` under inference
            # mode) is counted as the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        name = f"{func.namespace}.{packet.__name__}"
        f = 0
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.dot_flops += f
        elif torch.Tag.pointwise in func.tags and packet not in _NO_FLOP:
            f = sum(t.numel() for t in _tensors(out))
        self.flops += f
        self.flops_by_op[name] += f
        if name in _COLLECTIVES:
            cls, pos = _COLLECTIVES[name]
            self.coll[cls] += _nbytes(args[pos])
            self.coll_count += 1
        if packet in _ZERO_BYTES or _is_view(func):
            nb = 0
        elif packet in _WINDOW_READ:
            nb = 2 * _nbytes(out)
        elif packet in _WINDOW_WRITE:
            pos = _WINDOW_WRITE[packet]
            upd = args[pos] if len(args) > pos else None
            nb = 2 * (_nbytes(upd) if upd is not None else _nbytes(out))
        else:
            nb = _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        self.bytes += nb
        self.by_op[name] += nb
        return out


def analyze_step(fn, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched:
    the reference's ``analyze_hlo`` keys (``flops``, ``bytes``,
    ``coll_bytes``, ``coll_<class>`` for each class seen, ``entry``,
    ``bytes_by_op_unscaled``: the 12 operations of most bytes), plus
    ``dot_flops`` (the products' share), ``flops_by_op`` (the 12
    operations of most flops), ``ops`` (operations dispatched) and
    ``collectives``, the reference's ``parse_collectives`` dict."""
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    coll = dict(counter.coll)
    coll["count"] = counter.coll_count
    coll["total"] = sum(counter.coll[c] for c in COLL_CLASSES)

    def top(by_op):
        return dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:12])

    out = {"flops": float(counter.flops),
           "dot_flops": float(counter.dot_flops),
           "bytes": float(counter.bytes), "coll_bytes": float(coll["total"]),
           "entry": getattr(fn, "__qualname__", repr(fn)),
           "ops": counter.ops, "bytes_by_op_unscaled": top(counter.by_op),
           "flops_by_op": top(counter.flops_by_op),
           "collectives": coll}
    for c in COLL_CLASSES:
        if counter.coll[c]:
            out[f"coll_{c}"] = float(counter.coll[c])
    return out
