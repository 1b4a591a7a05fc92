"""Transform plans: the single dispatch point for every DPRT in the port.

The port of :mod:`repro.core.plan`.  Two layers:

1. **Backend registry.**  Each transform strategy registers a
   :class:`Backend` declaring its capabilities plus uniform callables
   for the skew-sum core and the full forward/inverse transforms:
   ``gather`` / ``horner`` / ``strips`` (plain torch, any device) and
   ``cuda`` -- the hand-written Hopper kernel K1, in the reference's
   ``pallas`` slot (priority 100, batched-native, takes ``m_block``).
   ``method="pallas"`` is accepted as an alias of ``cuda``, so reference
   call sites keep working.  ``method="auto"`` picks the highest-priority
   backend for the dtype; plans are device-agnostic, and on a CPU tensor
   the ``cuda`` backend runs K1's plain version.

2. **RadonPlan.**  A cached, frozen plan for ``(H, W)`` or ``(B, H, W)``
   inputs: zero-embed into the smallest prime ``P >= max(H, W)``,
   transform, and crop back in the inverse, so
   ``plan.inverse(plan.forward(f)) == f`` bit-exactly for integer
   images.  ``stream_rows`` streams the image through ONE launch of the
   streamed kernel (K5) in strips on backends that declare
   ``takes_stream_rows`` (``cuda``); on the others it degrades to the
   ``block_rows`` scan at the same strip height.  ``block_rows`` runs the
   strip decomposition one strip at a time (one K1 launch per strip with
   its ``row_offset`` on the ``cuda`` backend, a torch Horner scan
   elsewhere); ``block_batch`` runs a stack through the backend in
   chunks.

``RadonPlan.pipeline`` runs forward -> per-direction op -> inverse as
one call of the fused pipeline kernel K2 on backends that declare the
``pipeline`` capability (``cuda``), and as the staged fallback --
forward, exact 1-D stage, inverse -- everywhere else and under
``block_rows`` or ``stream_rows``; both give the same integers.

Under a ``mesh`` (a ``torch.distributed`` DeviceMesh, one process per
rank) ``method="auto"`` resolves to the mesh-aware ``sharded_cuda``
backend (``sharded_pallas`` is its alias): every rank runs K1 on its
rows with one ``all_reduce`` per transform, and the pipeline runs K1,
one ``reduce_scatter`` and K3 (:mod:`repro_torch.core.distributed`).
The legacy ``sharded`` backend scans each rank's rows in torch.  Plan
datapaths pin ``reduce="psum"`` and return whole tensors on every rank.

Plans are cached by (shape, dtype, method, knobs, mesh) in a bounded LRU
(``REPRO_PLAN_CACHE_MAXSIZE``, default 512) with hit/miss/eviction
counters; building one is pure Python shape math.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import re
import threading
from typing import Callable, Optional, Tuple

import torch

from . import geometry as G
from .dprt import (_skew_sum_gather, _skew_sum_horner, _skew_sum_strips,
                   accum_dtype_for, align_partial, as_dtype, dtype_kind,
                   dtype_name, strip_partial)
from ..kernels.tuning import check_strip_knobs, resolve_blocks

__all__ = [
    "Backend",
    "register_backend",
    "get_backend",
    "available_backends",
    "backend_capabilities",
    "select_backend",
    "RadonPlan",
    "get_plan",
    "plan_from_description",
    "plan_cache_info",
    "plan_cache_entries",
    "plan_cache_clear",
    "plan_cache_discard",
    "set_plan_cache_maxsize",
    "dispatch_skew_sum",
    "METHOD_ALIASES",
]

#: reference method names that resolve to a port backend
METHOD_ALIASES = {"pallas": "cuda", "sharded_pallas": "sharded_cuda"}


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Backend:
    """One transform strategy and its declared capabilities.

    All callables share the keyword surface
    ``(x, *, strip_rows=None, m_block=None, mesh=None)`` (plus ``sign``
    for ``skew_sum``, and ``stream_rows`` on backends that declare
    ``takes_stream_rows``); adapters ignore knobs they do not use.  Every
    callable takes ``(…, N, N)`` stacks; ``batched_native`` marks the
    backends that transform a whole stack in one kernel launch.
    """

    name: str
    skew_sum: Callable
    forward: Callable
    inverse: Callable
    forward_batched: Optional[Callable] = None
    inverse_batched: Optional[Callable] = None
    skew_batched: Optional[Callable] = None  # (B, N, N) stacks in one call
    #: fused projection-domain pipeline (forward -> per-direction op ->
    #: inverse without writing the projections out): callable
    #: ``(fp, op, operand, operand_form, *, strip_rows, m_block, mesh)``
    #: on prime-domain inputs.  ``None``: the plan runs the STAGED
    #: fallback (forward, 1-D stage, inverse as separate steps).
    pipeline: Optional[Callable] = None
    #: partial skew-sum of a row strip at global row ``row_offset``:
    #: ``(x, sign, *, row_offset, strip_rows, m_block)``; the ``block_rows``
    #: scan runs it once per strip.  ``None``: the plain torch Horner.
    skew_strip: Optional[Callable] = None
    batched_native: bool = False
    needs_strip_rows: bool = False
    takes_m_block: bool = False
    takes_stream_rows: bool = False
    mesh_aware: bool = False
    dtype_kinds: Optional[Tuple[str, ...]] = None  # None = any dtype
    priority: int = 0  # higher wins under method="auto"
    note: str = ""

    def supports_dtype(self, dtype) -> bool:
        if self.dtype_kinds is None:
            return True
        return dtype_kind(as_dtype(dtype)) in self.dtype_kinds


_REGISTRY: dict = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or replace) a backend; returns it for chaining."""
    _REGISTRY[backend.name] = backend
    if "_PLAN_CACHE" in globals():  # cached plans may pin a stale choice
        plan_cache_clear()
    return backend


def _canonical_method(name: str) -> str:
    return METHOD_ALIASES.get(name, name)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[_canonical_method(name)]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered backends: "
            f"{available_backends()} (or 'auto', or an alias "
            f"{tuple(METHOD_ALIASES)})") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def backend_capabilities() -> list:
    """Capability rows (dicts) for docs, ``serve --list-backends``, tests."""
    rows = []
    for name in available_backends():
        b = _REGISTRY[name]
        rows.append({
            "name": b.name,
            "batched_native": b.batched_native,
            "needs_strip_rows": b.needs_strip_rows,
            "takes_m_block": b.takes_m_block,
            "pipeline": b.pipeline is not None,
            "stream": b.takes_stream_rows,
            "mesh_aware": b.mesh_aware,
            "dtypes": "any" if b.dtype_kinds is None
                      else ",".join(b.dtype_kinds),
            "priority": b.priority,
            "note": b.note,
        })
    return rows


def select_backend(n: int, dtype, batch: Optional[int] = None,
                   mesh=None) -> str:
    """``method="auto"``: the highest-priority backend supporting the
    dtype -- among the mesh-aware ones under a mesh (``sharded_cuda``
    for every int/float image, else the legacy ``sharded``), among the
    others without one (``cuda``, else ``horner``)."""
    best = None
    for name in available_backends():
        b = _REGISTRY[name]
        if b.mesh_aware != (mesh is not None) or not b.supports_dtype(dtype):
            continue
        if best is None or b.priority > best.priority:
            best = b
    if best is None:
        raise ValueError(f"no registered backend supports dtype {dtype}"
                         + (" under a mesh" if mesh is not None else ""))
    return best.name


def _mesh_names_sizes(mesh) -> tuple:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs dim names, e.g. ('data', 'model')")
    return tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)


def _topology_token(mesh) -> Optional[str]:
    """The mesh's part of a plan-cache key: dim names and sizes, the
    device type and the global ranks of the mesh (so of every dim's
    groups).  None without a mesh."""
    if mesh is None:
        return None
    names, sizes = _mesh_names_sizes(mesh)
    return ("mesh_" + "_".join(f"{a}{s}" for a, s in zip(names, sizes))
            + f"_{mesh.device_type}_ranks{mesh.mesh.flatten().tolist()}")


def _mesh_repr(mesh) -> Optional[str]:
    """``describe()``'s mesh entry, in the reference's ``Mesh`` repr
    terms: the dim sizes and names."""
    if mesh is None:
        return None
    names, sizes = _mesh_names_sizes(mesh)
    return f"DeviceMesh(axis_sizes={sizes}, axis_names={names})"


def _mesh_for_description(desc: dict, mesh):
    """The mesh to build a described plan on: ``mesh`` must have the dim
    names and sizes the description's ``mesh`` entry gives (a reference
    ``Mesh`` repr or the port's own), and be given exactly when the
    description names one."""
    want = desc.get("mesh")
    if want is None:
        if mesh is not None:
            raise ValueError("the description has no mesh; pass mesh=None")
        return None
    if mesh is None:
        raise ValueError(f"the description's plan lives on a mesh ({want}): "
                         f"pass mesh= a DeviceMesh of the same shape")
    sizes = re.search(r"axis_sizes=\(([^)]*)\)", want)
    names = re.search(r"axis_names=\(([^)]*)\)", want)
    if sizes is None or names is None:
        raise ValueError(f"cannot read the mesh description {want!r}")
    shape = (tuple(n.strip().strip("'\"") for n in names.group(1).split(",")
                   if n.strip()),
             tuple(int(v) for v in sizes.group(1).split(",") if v.strip()))
    if shape != _mesh_names_sizes(mesh):
        raise ValueError(f"the description's mesh {want} does not match "
                         f"{_mesh_repr(mesh)}")
    return mesh


# ---------------------------------------------------------------------------
# shared transform epilogues (rank-polymorphic: (N+1, N) or (…, N+1, N))
# ---------------------------------------------------------------------------
def _floor_or_true_div(x: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``x // n`` (floor) for integers, ``x / n`` else."""
    if x.dtype.is_floating_point:
        return x / n
    return torch.div(x, n, rounding_mode="floor")


def _attach_row_sum(core: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Append the R(N, d) = sum_j f(d, j) projection row."""
    last = f.to(core.dtype).sum(-1, dtype=core.dtype)[..., None, :]
    return torch.cat([core, last], dim=-2)


def _inverse_epilogue(z: torch.Tensor, r: torch.Tensor,
                      n: int) -> torch.Tensor:
    """-S + R(N, i) correction and the exact divide-by-N (paper eq. 3-4)."""
    acc = z.dtype
    s = r[..., 0, :].to(acc).sum(-1, dtype=acc)[..., None, None]
    num = z - s + r[..., n, :].to(acc)[..., :, None]
    return _floor_or_true_div(num, n)


def _make_forward(skew: Callable) -> Callable:
    def fwd(f, *, strip_rows=None, m_block=None, mesh=None):
        core = skew(f, +1, strip_rows=strip_rows, m_block=m_block, mesh=mesh)
        return _attach_row_sum(core, f)
    return fwd


def _make_inverse(skew: Callable) -> Callable:
    def inv(r, *, strip_rows=None, m_block=None, mesh=None):
        n = r.shape[-1]
        z = skew(r[..., :n, :], -1, strip_rows=strip_rows, m_block=m_block,
                 mesh=mesh)
        return _inverse_epilogue(z, r, n)
    return inv


# ---------------------------------------------------------------------------
# exact transposes (adjoints) of the two transforms -- the algebra of the
# reference's plan layer:
#
#   (A^T r)[i, j] = skew_sum(r[:N], -1)[i, j] + r(N, i)
#   (B^T g)       = ( A g - total(g) * (e_0 1^T) ) / N      (B = A^-1)
# ---------------------------------------------------------------------------
def _adjoint_epilogue(z: torch.Tensor, r: torch.Tensor,
                      n: int) -> torch.Tensor:
    """z = skew_sum(r[..., :N, :], -1); add the row-sum row's transpose."""
    return z + r[..., n, :].to(z.dtype)[..., :, None]


def _inverse_adjoint_epilogue(core: torch.Tensor, g: torch.Tensor,
                              n: int) -> torch.Tensor:
    """core = skew_sum(g, +1); build (A g - total(g) E00) / N."""
    acc = core.dtype
    ga = g.to(acc)
    rowsum = ga.sum(-1, dtype=acc)[..., None, :]             # (…, 1, N)
    out = torch.cat([core, rowsum], dim=-2)                   # = A g
    total = ga.sum((-2, -1), dtype=acc)
    out[..., 0, :] -= total[..., None]
    # integers follow the inverse's floor-division convention
    return _floor_or_true_div(out, n)


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------
def _gather_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None):
    return _skew_sum_gather(g, sign)


def _horner_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None):
    return _skew_sum_horner(g, sign)


def _strips_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None):
    if strip_rows is None:
        itemsize = accum_dtype_for(g.dtype, g.shape[-1]).itemsize
        strip_rows = resolve_blocks(g.shape[-1], itemsize)[0]
    return _skew_sum_strips(g, sign, strip_rows)


# the kernels package imports core, so the cuda adapters import it lazily
def _cuda_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None,
               stream_rows=None):
    from ..kernels.ops import skew_sum_cuda
    return skew_sum_cuda(g, sign, strip_rows=strip_rows, m_block=m_block,
                         stream_rows=stream_rows)


def _cuda_skew_strip(g, sign, *, row_offset, strip_rows=None, m_block=None):
    from ..kernels.ops import skew_sum_cuda_strip
    return skew_sum_cuda_strip(g, sign, row_offset=row_offset,
                               strip_rows=strip_rows, m_block=m_block)


def _cuda_forward(f, *, strip_rows=None, m_block=None, mesh=None,
                  stream_rows=None):
    from ..kernels.ops import dprt_cuda
    return dprt_cuda(f, strip_rows=strip_rows, m_block=m_block,
                     stream_rows=stream_rows)


def _cuda_inverse(r, *, strip_rows=None, m_block=None, mesh=None,
                  stream_rows=None):
    from ..kernels.ops import idprt_cuda
    return idprt_cuda(r, strip_rows=strip_rows, m_block=m_block,
                      stream_rows=stream_rows)


def _cuda_pipeline(fp, op, operand, operand_form, *, strip_rows=None,
                   m_block=None, mesh=None, stream_rows=None):
    # m_block here would be the PIPELINE direction block (its own tune
    # table), distinct from K1's m_block; the plan passes none through
    from ..kernels.ops import projection_pipeline_cuda
    return projection_pipeline_cuda(fp, op, operand,
                                    operand_form=operand_form)


def _require_mesh(mesh):
    if mesh is None:
        raise ValueError(
            "the 'sharded' backends need mesh= (a torch.distributed "
            "DeviceMesh); pass it explicitly or through radon.config(mesh=)")
    return mesh


# the mesh adapters return whole tensors on every rank: the plan
# datapaths pin reduce="psum" (a batch sharded over the data axes is
# gathered back); the direction-sharded layout, which a round trip
# consumes in place, lives on the raw core.distributed functions
def _sharded_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None):
    from .distributed import _row_axis, _skew_sum_sharded
    mesh = _require_mesh(mesh)
    return _skew_sum_sharded(g, mesh, axis=_row_axis(mesh),
                             sign=sign).full_tensor()


def _sharded_forward(f, *, strip_rows=None, m_block=None, mesh=None):
    from .distributed import _row_axis, dprt_sharded
    mesh = _require_mesh(mesh)
    return dprt_sharded(f, mesh, axis=_row_axis(mesh)).full_tensor()


def _sharded_inverse(r, *, strip_rows=None, m_block=None, mesh=None):
    from .distributed import _row_axis, idprt_sharded
    mesh = _require_mesh(mesh)
    return idprt_sharded(r, mesh, axis=_row_axis(mesh)).full_tensor()


def _sharded_forward_batched(fb, *, strip_rows=None, m_block=None,
                             mesh=None):
    from .distributed import dprt_batch_sharded
    return dprt_batch_sharded(fb, _require_mesh(mesh)).full_tensor()


def _sharded_inverse_batched(rb, *, strip_rows=None, m_block=None,
                             mesh=None):
    from .distributed import idprt_batch_sharded
    return idprt_batch_sharded(rb, _require_mesh(mesh)).full_tensor()


def _sharded_cuda_skew(g, sign, *, strip_rows=None, m_block=None, mesh=None,
                       stream_rows=None):
    from .distributed import skew_sum_sharded_pallas
    return skew_sum_sharded_pallas(
        g, _require_mesh(mesh), sign=sign, reduce="psum",
        strip_rows=strip_rows, m_block=m_block,
        stream_rows=stream_rows).full_tensor()


def _sharded_cuda_forward(f, *, strip_rows=None, m_block=None, mesh=None,
                          stream_rows=None):
    from .distributed import dprt_sharded_pallas
    return dprt_sharded_pallas(
        f, _require_mesh(mesh), reduce="psum", strip_rows=strip_rows,
        m_block=m_block, stream_rows=stream_rows).full_tensor()


def _sharded_cuda_inverse(r, *, strip_rows=None, m_block=None, mesh=None,
                          stream_rows=None):
    from .distributed import idprt_sharded_pallas
    return idprt_sharded_pallas(
        r, _require_mesh(mesh), reduce="psum", strip_rows=strip_rows,
        m_block=m_block, stream_rows=stream_rows).full_tensor()


def _sharded_cuda_pipeline(fp, op, operand, operand_form, *, strip_rows=None,
                           m_block=None, mesh=None, stream_rows=None):
    from .distributed import projection_pipeline_sharded
    return projection_pipeline_sharded(
        fp, _require_mesh(mesh), op=op, operand=operand,
        strip_rows=strip_rows, m_block=m_block,
        stream_rows=stream_rows).full_tensor()


register_backend(Backend(
    name="gather",
    skew_sum=_gather_skew,
    forward=_make_forward(_gather_skew),
    inverse=_make_inverse(_gather_skew),
    priority=10,
    note="per-direction shear oracle (systolic analog)",
))
register_backend(Backend(
    name="horner",
    skew_sum=_horner_skew,
    forward=_make_forward(_horner_skew),
    inverse=_make_inverse(_horner_skew),
    priority=50,
    note="paper Sec. III-B shift-and-add dataflow",
))
register_backend(Backend(
    name="strips",
    skew_sum=_strips_skew,
    forward=_make_forward(_strips_skew),
    inverse=_make_inverse(_strips_skew),
    needs_strip_rows=True,
    priority=30,
    note="scalable SFDPRT strip decomposition (eq. 5-8)",
))
register_backend(Backend(
    name="cuda",
    skew_sum=_cuda_skew,
    forward=_cuda_forward,
    inverse=_cuda_inverse,
    forward_batched=_cuda_forward,   # the same wrappers take (B, N, N)
    inverse_batched=_cuda_inverse,
    skew_batched=_cuda_skew,
    skew_strip=_cuda_skew_strip,
    pipeline=_cuda_pipeline,
    batched_native=True,
    takes_m_block=True,
    takes_stream_rows=True,
    dtype_kinds=("i", "u", "f"),
    priority=100,
    note="hand-written Hopper kernels: SFDPRT K1 (one launch per stack), "
         "streamed K4/K5 (stream_rows) and pipeline K2; plain torch "
         "versions on CPU tensors",
))
register_backend(Backend(
    name="sharded",
    skew_sum=_sharded_skew,
    forward=_sharded_forward,
    inverse=_sharded_inverse,
    forward_batched=_sharded_forward_batched,
    inverse_batched=_sharded_inverse_batched,
    mesh_aware=True,
    priority=0,  # mesh-only; sharded_cuda outranks it under auto
    note="legacy row super-strips (torch Horner scan) + one all_reduce",
))
register_backend(Backend(
    name="sharded_cuda",
    skew_sum=_sharded_cuda_skew,
    forward=_sharded_cuda_forward,
    inverse=_sharded_cuda_inverse,
    forward_batched=_sharded_cuda_forward,   # the same wrappers take (B, …)
    inverse_batched=_sharded_cuda_inverse,
    skew_batched=_sharded_cuda_skew,
    pipeline=_sharded_cuda_pipeline,
    batched_native=True,
    takes_m_block=True,
    takes_stream_rows=True,
    mesh_aware=True,
    dtype_kinds=("i", "u", "f"),
    priority=20,  # mesh-only: beats legacy "sharded" under method="auto"
    note="per-shard K1 (K4/K5 with stream_rows) + one all_reduce; "
         "pipeline: K1, one reduce_scatter, K3 (core/distributed.py)",
))


# ---------------------------------------------------------------------------
# blocked (resource-fitting) execution helpers
# ---------------------------------------------------------------------------
def _blocked_skew_sum(gmat: torch.Tensor, sign: int, block_rows: int,
                      acc_dtype, strip_fn: Optional[Callable] = None
                      ) -> torch.Tensor:
    """Strip decomposition one strip at a time (bounded memory): the
    algebra of ``method="strips"`` -- partial skew-sum per strip aligned
    to its global rows, accumulated (eq. 7-8) -- with one partial live.

    ``strip_fn(strip, sign, row_offset=...)`` computes an aligned
    partial in one call (K1 with ``row_offset`` for the ``cuda``
    backend); without it, a torch Horner scan plus one alignment roll.
    """
    n = gmat.shape[-1]
    h = int(block_rows)
    if h < 1:
        raise ValueError(f"block_rows must be >= 1, got {h}")
    acc = torch.zeros((*gmat.shape[:-2], n, n), dtype=acc_dtype,
                      device=gmat.device)
    for off in range(0, gmat.shape[-2], h):
        strip = gmat[..., off:off + h, :]
        if strip_fn is not None:
            acc += strip_fn(strip, sign, row_offset=off).to(acc_dtype)
        else:
            u = strip_partial(strip, n, sign=sign, acc_dtype=acc_dtype)
            acc += align_partial(u, off, sign)
    return acc


def _map_chunk_pairs(fn: Callable, xb: torch.Tensor, wb: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """:func:`_map_chunks` for a paired (image stack, batched operand):
    both chunk together, so a fused conv against per-image operands
    keeps the ``block_batch`` memory bound."""
    b = xb.shape[0]
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"block_batch must be >= 1, got {chunk}")
    if chunk >= b:
        return fn(xb, wb)
    return torch.cat([fn(xb[i:i + chunk], wb[i:i + chunk])
                      for i in range(0, b, chunk)])


def _map_chunks(fn: Callable, xb: torch.Tensor, chunk: int) -> torch.Tensor:
    """Apply a stack-level ``fn`` over batch chunks of ``chunk`` images
    (bounds live memory to one chunk-sized stack plus the output)."""
    b = xb.shape[0]
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"block_batch must be >= 1, got {chunk}")
    if chunk >= b:
        return fn(xb)
    return torch.cat([fn(xb[i:i + chunk]) for i in range(0, b, chunk)])


# ---------------------------------------------------------------------------
# RadonPlan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RadonPlan:
    """A resolved, cached recipe for transforming one input geometry.

    ``forward`` embeds into the prime domain and returns the
    ``(…, P+1, P)`` projections; ``inverse`` reconstructs and crops back
    to ``(…, H, W)``.  Outputs live on the input's device.
    """

    geometry: G.Geometry
    method: str                      # resolved backend name (never "auto")
    requested_method: str            # what the caller asked for
    strip_rows: Optional[int] = None
    m_block: Optional[int] = None
    batch_impl: str = "auto"
    block_rows: Optional[int] = None
    #: stream strips of this height through ONE launch of the streamed
    #: kernel on backends declaring ``takes_stream_rows``; other backends
    #: degrade to the ``block_rows`` scan with the same strip height
    stream_rows: Optional[int] = None
    block_batch: Optional[int] = None
    #: the torch.distributed DeviceMesh of a mesh plan (None otherwise)
    mesh: Optional[object] = None
    dtype_name: Optional[str] = None

    @property
    def backend(self) -> Backend:
        return get_backend(self.method)

    def _knobs(self) -> dict:
        knobs = {"strip_rows": self.strip_rows, "m_block": self.m_block,
                 "mesh": self.mesh}
        if self.backend.takes_stream_rows:
            knobs["stream_rows"] = self.stream_rows
        return knobs

    @property
    def _scan_rows(self) -> Optional[int]:
        """Strip height when the scan-of-launches fallback must run:
        ``block_rows`` always scans; ``stream_rows`` scans on a backend
        without the streamed kernel.  ``None``: the backend runs
        natively (one launch, streamed or not)."""
        if self.block_rows is not None:
            return self.block_rows
        if self.stream_rows is not None \
                and not self.backend.takes_stream_rows:
            return self.stream_rows
        return None

    # -- prime domain; every helper takes (N, N) or (…, N, N) ------------
    def _blocked(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        strip = self.backend.skew_strip
        strip_fn = None if strip is None else functools.partial(
            strip, strip_rows=self.strip_rows, m_block=self.m_block)
        return _blocked_skew_sum(x, sign, self._scan_rows,
                                 accum_dtype_for(x.dtype, x.shape[-1]),
                                 strip_fn)

    def _forward_prime(self, fp: torch.Tensor) -> torch.Tensor:
        if self._scan_rows is not None:
            return _attach_row_sum(self._blocked(fp, +1), fp)
        return self.backend.forward(fp, **self._knobs())

    def _inverse_prime(self, r: torch.Tensor) -> torch.Tensor:
        if self._scan_rows is not None:
            n = r.shape[-1]
            return _inverse_epilogue(self._blocked(r[..., :n, :], -1), r, n)
        return self.backend.inverse(r, **self._knobs())

    def _skew_prime(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        if self._scan_rows is not None:
            return self._blocked(x, sign)
        return self.backend.skew_sum(x, sign, **self._knobs())

    def _adjoint_prime(self, r: torch.Tensor) -> torch.Tensor:
        n = self.geometry.prime
        return _adjoint_epilogue(self._skew_prime(r[..., :n, :], -1), r, n)

    def _inverse_adjoint_prime(self, g: torch.Tensor) -> torch.Tensor:
        return _inverse_adjoint_epilogue(self._skew_prime(g, +1), g,
                                         self.geometry.prime)

    # -- batched stacks ----------------------------------------------------
    def _stack(self, xb: torch.Tensor, native: Optional[Callable],
               one: Callable) -> torch.Tensor:
        """A (B, …) stack: the backend's one-launch batched path when it
        has one, else ``batch_impl`` -- ``map`` loops image by image,
        ``vmap``/``auto`` hand the whole stack to the rank-polymorphic
        prime-domain path (the batch dimension written out)."""
        if native is not None and self._scan_rows is None:
            fn = lambda chunk: native(chunk, **self._knobs())  # noqa: E731
        elif self.batch_impl == "map":
            fn = lambda chunk: torch.stack([one(x) for x in chunk])  # noqa
        else:
            fn = one
        if self.block_batch is not None:
            return _map_chunks(fn, xb, self.block_batch)
        return fn(xb)

    def _check(self, x: torch.Tensor, want: tuple, what: str) -> None:
        if tuple(x.shape) != want:
            raise ValueError(f"plan {what} expects {want}, got "
                             f"{tuple(x.shape)}")

    # -- public ------------------------------------------------------------
    def forward(self, f: torch.Tensor) -> torch.Tensor:
        """(…, H, W) image(s) -> (…, P+1, P) exact projections."""
        g = self.geometry
        self._check(f, g.image_shape, "forward")
        fp = G.embed(f, g)
        if not g.batched:
            return self._forward_prime(fp)
        be = self.backend
        native = (be.forward_batched
                  if be.batched_native or be.mesh_aware else None)
        return self._stack(fp, native, self._forward_prime)

    def inverse(self, r: torch.Tensor) -> torch.Tensor:
        """(…, P+1, P) projections -> (…, H, W) exact reconstruction."""
        g = self.geometry
        self._check(r, g.transform_shape, "inverse")
        if not g.batched:
            return G.crop(self._inverse_prime(r), g)
        be = self.backend
        native = (be.inverse_batched
                  if be.batched_native or be.mesh_aware else None)
        return G.crop(self._stack(r, native, self._inverse_prime), g)

    def adjoint(self, r: torch.Tensor) -> torch.Tensor:
        """Exact transpose of :meth:`forward`: (…, P+1, P) -> (…, H, W).
        Distinct from :meth:`inverse` (A^T A != I)."""
        g = self.geometry
        self._check(r, g.transform_shape, "adjoint")
        if not g.batched:
            return G.crop(self._adjoint_prime(r), g)
        be = self.backend
        native = None
        if be.skew_batched is not None:
            n = g.prime

            def native(rb, **knobs):
                z = be.skew_batched(rb[:, :n], -1, **knobs)
                return _adjoint_epilogue(z, rb, n)

        return G.crop(self._stack(r, native, self._adjoint_prime), g)

    def inverse_adjoint(self, f: torch.Tensor) -> torch.Tensor:
        """Exact transpose of :meth:`inverse`: (…, H, W) -> (…, P+1, P),
        realized as (A g - total(g) E00) / N from the same skew-sum.
        Integer inputs follow the inverse's floor-division convention;
        use floats for the true adjoint (autograd always does)."""
        g = self.geometry
        self._check(f, g.image_shape, "inverse_adjoint")
        fp = G.embed(f, g)
        if not g.batched:
            return self._inverse_adjoint_prime(fp)
        be = self.backend
        native = None
        if be.skew_batched is not None:
            n = g.prime

            def native(fb, **knobs):
                return _inverse_adjoint_epilogue(
                    be.skew_batched(fb, +1, **knobs), fb, n)

        return self._stack(fp, native, self._inverse_adjoint_prime)

    # -- projection-domain pipeline ----------------------------------------
    def pipeline(self, f: torch.Tensor, op: str = "conv",
                 operand: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused ``inverse(per_direction_op(forward(f)))``.

        ``op``: ``"conv"`` (per-direction 1-D circular convolution
        against a second operand -- exact 2-D circular convolution),
        ``"mul"`` (pointwise projection-domain multiply: the
        ``inv @ pointwise @ fwd`` fusion) or ``"none"`` (the round
        trip).  ``operand`` is the conv operand as a prime-domain image
        (``(P, P)`` shared or matching ``f``'s batch) or as
        projections/weights (``(…, P+1, P)``), the form inferred from
        its trailing shape.

        Backends with the ``pipeline`` capability run it as one kernel
        call (K2 on ``cuda``); every other backend, and any plan with
        ``block_rows`` or ``stream_rows``, takes the STAGED fallback --
        forward, exact 1-D stage, inverse through the same registry (on a
        streamed ``cuda`` plan: K5 forward, the 1-D stage, K5 inverse) --
        with the same integers.  ``"conv"`` needs native prime geometry (embedding
        would change the convolution's torus; :mod:`repro_torch.core.
        conv` folds other geometries before it gets here);
        ``"mul"``/``"none"`` fuse the literal embed -> transform ->
        weight -> inverse -> crop composition, so any geometry works.
        """
        g = self.geometry
        if op not in ("none", "mul", "conv"):
            raise ValueError(f"pipeline op must be none|mul|conv: {op!r}")
        if tuple(f.shape) != g.image_shape:
            raise ValueError(f"plan built for {g.image_shape}, got image "
                             f"{tuple(f.shape)}")
        if op == "conv" and not g.native:
            raise ValueError(
                f"conv pipeline needs native square prime geometry, plan "
                f"is {g.image_shape} embedded in P={g.prime}")
        p = g.prime
        operand_form = None
        if op != "none":
            if operand is None:
                raise ValueError(f"pipeline op {op!r} needs an operand")
            if op == "conv" and tuple(operand.shape[-2:]) == (p, p):
                operand_form = "image"
            elif tuple(operand.shape[-2:]) == (p + 1, p):
                operand_form = "proj"
            else:
                raise ValueError(
                    f"pipeline operand must be (…, {p}, {p}) images or "
                    f"(…, {p + 1}, {p}) projections/weights for "
                    f"op={op!r}, got {tuple(operand.shape)}")
            if operand.ndim == 3 and g.batch not in (None, operand.shape[0]) \
                    and operand.shape[0] != 1:
                raise ValueError(
                    f"batched pipeline operand {tuple(operand.shape)} does "
                    f"not match plan batch {g.batch}")

        be = self.backend
        if be.pipeline is not None and self.block_rows is None \
                and self.stream_rows is None:
            fp = G.embed(f, g)
            if g.batched and self.block_batch is not None:
                if (operand is None or operand.ndim == 2
                        or operand.shape[0] == 1):
                    out = _map_chunks(
                        lambda chunk: be.pipeline(chunk, op, operand,
                                                  operand_form,
                                                  **self._knobs()),
                        fp, self.block_batch)
                else:   # batched operand: chunk image and operand together
                    out = _map_chunk_pairs(
                        lambda chunk, wch: be.pipeline(chunk, op, wch,
                                                       operand_form,
                                                       **self._knobs()),
                        fp, operand, self.block_batch)
            else:
                out = be.pipeline(fp, op, operand, operand_form,
                                  **self._knobs())
            return G.crop(out, g)

        # staged fallback: the same three stages, separate launches
        rf = self.forward(f)
        if op == "conv":
            if operand_form == "image":
                if tuple(operand.shape) == g.image_shape:
                    rg = self.forward(operand)
                else:  # one shared (P, P) operand for a batched plan
                    rg = get_plan((p, p), self.dtype_name, self.method,
                                  strip_rows=self.strip_rows,
                                  m_block=self.m_block,
                                  stream_rows=self.stream_rows,
                                  mesh=self.mesh).forward(operand)
            else:
                rg = operand
            from .conv import circ_conv1d_exact
            rc = circ_conv1d_exact(rf, rg)
        elif op == "mul":
            rc = rf * operand.to(rf.dtype)
        else:
            rc = rf
        return self.inverse(rc.to(rf.dtype))

    def describe(self) -> dict:
        g = self.geometry
        return {
            "image_shape": g.image_shape,
            "prime": g.prime,
            "pad": (g.pad_rows, g.pad_cols),
            "native": g.native,
            "dtype": self.dtype_name,
            "method": self.method,
            "requested_method": self.requested_method,
            "strip_rows": self.strip_rows,
            "m_block": self.m_block,
            "block_rows": self.block_rows,
            "stream_rows": self.stream_rows,
            "block_batch": self.block_batch,
            "mesh": _mesh_repr(self.mesh),
        }


# ---------------------------------------------------------------------------
# plan construction + cache (bounded LRU)
# ---------------------------------------------------------------------------
PlanCacheInfo = collections.namedtuple(
    "PlanCacheInfo", ["hits", "misses", "maxsize", "currsize", "evictions"])


def _env_cache_maxsize() -> Optional[int]:
    """``REPRO_PLAN_CACHE_MAXSIZE``: plans kept live (<= 0 => unbounded)."""
    raw = os.environ.get("REPRO_PLAN_CACHE_MAXSIZE", "512")
    try:
        size = int(raw)
    except ValueError:
        raise ValueError(
            f"REPRO_PLAN_CACHE_MAXSIZE must be an integer, got {raw!r}")
    return None if size <= 0 else size


class _PlanLRU:
    """A small LRU with an eviction counter.  Build hooks see every newly
    built plan (the radon layer counts them as retraces); evict hooks
    release per-plan state in lockstep with the cache."""

    def __init__(self, maxsize: Optional[int]):
        self.maxsize = maxsize
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._evict_hooks: list = []
        self._build_hooks: list = []
        self.hits = self.misses = self.evictions = 0

    def add_evict_hook(self, fn: Callable) -> None:
        self._evict_hooks.append(fn)

    def add_build_hook(self, fn: Callable) -> None:
        self._build_hooks.append(fn)

    def _shrink_locked(self) -> list:
        dropped = []
        while self.maxsize is not None and len(self._data) > self.maxsize:
            dropped.append(self._data.popitem(last=False)[1])
            self.evictions += 1
        return dropped

    def _fire(self, dropped: list) -> None:
        for plan in dropped:        # outside the lock: hooks may be slow
            for fn in self._evict_hooks:
                fn(plan)

    def get_or_build(self, key, builder: Callable):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
        value = builder()          # build outside the lock (pure python)
        with self._lock:
            if key in self._data:  # racer built it first: keep theirs
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
            self._data[key] = value
            dropped = self._shrink_locked()
        for fn in self._build_hooks:
            fn(value)
        self._fire(dropped)
        return value

    def info(self) -> PlanCacheInfo:
        with self._lock:
            return PlanCacheInfo(self.hits, self.misses, self.maxsize,
                                 len(self._data), self.evictions)

    def values(self) -> list:
        with self._lock:
            return list(self._data.values())

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._data.values())
            self._data.clear()
        self._fire(dropped)

    def discard(self, plans) -> int:
        wanted = {id(p) for p in plans}
        with self._lock:
            keys = [k for k, v in self._data.items() if id(v) in wanted]
            dropped = [self._data.pop(k) for k in keys]
            self.evictions += len(dropped)
        self._fire(dropped)
        return len(dropped)

    def resize(self, maxsize: Optional[int]) -> None:
        with self._lock:
            self.maxsize = maxsize
            dropped = self._shrink_locked()
        self._fire(dropped)


_PLAN_CACHE = _PlanLRU(_env_cache_maxsize())


def add_plan_evict_hook(fn: Callable) -> None:
    """Register ``fn(plan)`` to run whenever a plan leaves the cache."""
    _PLAN_CACHE.add_evict_hook(fn)


def add_plan_build_hook(fn: Callable) -> None:
    """Register ``fn(plan)`` to run whenever a plan is built (a miss)."""
    _PLAN_CACHE.add_build_hook(fn)


def set_plan_cache_maxsize(maxsize: Optional[int]) -> None:
    """Re-bound the plan cache (None or <= 0 => unbounded)."""
    if maxsize is not None and maxsize <= 0:
        maxsize = None
    _PLAN_CACHE.resize(maxsize)


def _build_plan(shape: tuple, dtype_name_: str, method: str,
                strip_rows: Optional[int], m_block: Optional[int],
                batch_impl: str, block_rows: Optional[int],
                stream_rows: Optional[int],
                block_batch: Optional[int], mesh) -> RadonPlan:
    geom = G.normalize_geometry(shape)
    dtype = as_dtype(dtype_name_)
    requested = method
    if method == "auto":
        method = select_backend(geom.prime, dtype, batch=geom.batch,
                                mesh=mesh)
    be = get_backend(method)
    if not be.supports_dtype(dtype):
        raise ValueError(
            f"backend {be.name!r} does not support dtype {dtype_name_} "
            f"(kinds: {be.dtype_kinds})")
    if batch_impl not in ("auto", "map", "vmap"):
        raise ValueError(f"batch_impl must be auto|map|vmap: {batch_impl!r}")
    itemsize = accum_dtype_for(dtype, geom.prime).itemsize
    th, tm = resolve_blocks(geom.prime, itemsize, strip_rows, m_block,
                            block_rows=block_rows, stream_rows=stream_rows)
    if be.needs_strip_rows or be.takes_m_block:
        strip_rows = th
        m_block = tm if be.takes_m_block else None
    return RadonPlan(geometry=geom, method=be.name,
                     requested_method=requested, strip_rows=strip_rows,
                     m_block=m_block, batch_impl=batch_impl,
                     block_rows=block_rows, stream_rows=stream_rows,
                     block_batch=block_batch, mesh=mesh,
                     dtype_name=dtype_name(dtype))


def get_plan(shape, dtype, method: str = "auto", *,
             strip_rows: Optional[int] = None,
             m_block: Optional[int] = None,
             batch_impl: str = "auto",
             block_rows: Optional[int] = None,
             stream_rows: Optional[int] = None,
             block_batch: Optional[int] = None,
             mesh=None) -> RadonPlan:
    """Cached :class:`RadonPlan` for an input shape/dtype and knobs.

    The ``block_rows`` / ``stream_rows`` ValueErrors fire first, for
    every backend.  ``mesh`` (a DeviceMesh with named dims) enters the
    cache key as its topology token -- dim names, sizes, device type and
    ranks -- so a plan built for one mesh is never returned for
    another, nor without one."""
    check_strip_knobs(block_rows, stream_rows)
    shape = tuple(int(s) for s in shape)
    key = (shape, dtype_name(as_dtype(dtype)), method,
           None if strip_rows is None else int(strip_rows),
           None if m_block is None else int(m_block), batch_impl,
           None if block_rows is None else int(block_rows),
           None if stream_rows is None else int(stream_rows),
           None if block_batch is None else int(block_batch),
           _topology_token(mesh))
    return _PLAN_CACHE.get_or_build(key,
                                    lambda: _build_plan(*key[:-1], mesh))


def plan_from_description(desc: dict, mesh=None) -> RadonPlan:
    """The port's plan for a reference ``RadonPlan.describe()`` dict.

    ``plan_from_description(d).describe() == d`` except that ``method``
    reads ``cuda`` where ``d`` says ``pallas`` (``sharded_cuda`` for
    ``sharded_pallas``) and ``mesh`` is the port's repr of a mesh with
    the described dim names and sizes: a described mesh plan needs
    ``mesh=``, a DeviceMesh of that shape."""
    mesh = _mesh_for_description(desc, mesh)
    plan = get_plan(desc["image_shape"], desc["dtype"],
                    desc["requested_method"],
                    strip_rows=desc.get("strip_rows"),
                    m_block=desc.get("m_block"),
                    block_rows=desc.get("block_rows"),
                    stream_rows=desc.get("stream_rows"),
                    block_batch=desc.get("block_batch"),
                    mesh=mesh)
    want = _canonical_method(desc["method"])
    if plan.method != want:
        raise ValueError(f"description resolved to {desc['method']!r}, the "
                         f"port resolves {desc['requested_method']!r} to "
                         f"{plan.method!r}")
    return plan


def plan_cache_info() -> PlanCacheInfo:
    """(hits, misses, maxsize, currsize, evictions) of the plan cache."""
    return _PLAN_CACHE.info()


def plan_cache_entries() -> list:
    """``describe()`` dicts for every live cached plan, LRU-oldest first."""
    return [plan.describe() for plan in _PLAN_CACHE.values()]


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()


def plan_cache_discard(plans) -> int:
    """Evict exactly the given plans, firing the evict hooks."""
    return _PLAN_CACHE.discard(plans)


def dispatch_skew_sum(g: torch.Tensor, sign: int, method: str = "horner",
                      strip_rows: Optional[int] = None,
                      m_block: Optional[int] = None,
                      mesh=None) -> torch.Tensor:
    """Registry-routed skew-sum primitive (prime-domain input)."""
    n = g.shape[-1]
    if method == "auto":
        method = select_backend(n, g.dtype, mesh=mesh)
    be = get_backend(method)
    if be.needs_strip_rows and strip_rows is None:
        itemsize = accum_dtype_for(g.dtype, n).itemsize
        strip_rows = resolve_blocks(n, itemsize, None, None)[0]
    return be.skew_sum(g, sign, strip_rows=strip_rows, m_block=m_block,
                       mesh=mesh)
