"""Distributed DPRT: the paper's strip decomposition on a device mesh.

The port of :mod:`repro.core.distributed` onto ``torch.distributed``: a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose dims are named
``("data", "model")`` or ``("model",)`` (``"pod"`` may lead), one
process per rank.  Each rank owns a contiguous block of image rows (a
"super-strip") along the row axis (``"model"`` if present, else the
mesh's last dim), runs one kernel over it with its first global row as
``row_offset`` (K1, or K4/K5 with ``stream_rows``), and one collective
combines the partials (eq. 8):

* ``psum``          -> ``all_reduce``: every rank holds the whole
                       transform;
* ``psum_scatter``  -> ``reduce_scatter_tensor`` over the row dim: each
                       rank keeps its chunk of directions (1/devices the
                       collective bytes);
* ``ring``          -> the same direction-sharded result from an explicit
                       ``batch_isend_irecv`` ring, one chunk per step.

A batched stack also shards over the data axes (``"pod"``, ``"data"``).
The inverse consumes the forward's direction-sharded layout in place,
and :func:`projection_pipeline_sharded` runs two kernel launches per
rank -- K1 on its rows, then K3 (the pipeline tail) on its directions --
with one ``reduce_scatter`` between them.

**The convention of this module.**  Every function runs on every rank
of the mesh with the same arguments.  Inputs are plain tensors that
hold the whole global array on every rank, or DTensors on the same
mesh: a DTensor already laid out as this rank's work needs it (the
direction-sharded forward that feeds the inverse) is used in place, any
other is gathered first.  The functions return a
:class:`~torch.distributed.tensor.DTensor` whose placements mirror the
reference's ``PartitionSpec``: ``Shard(0)`` over the data axes for a
batched stack, ``Shard`` of the row dim over the row axis for
``psum_scatter`` / ``ring`` (and the pipeline), ``Replicate`` elsewhere;
``.full_tensor()`` is the global array.  Rows and batches split as a
DTensor splits (``torch.chunk``: chunks of the rounded-up size, the last
ones shorter or empty), which for rows is the reference's
pad-to-a-multiple layout.  Collectives run in the accumulator dtype, so
int32 sums wrap mod 2**32 as JAX's ``psum`` does.  The tensors stay on
the mesh's device: an NCCL mesh takes CUDA tensors, a gloo mesh CPU
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .dprt import accum_dtype_for, align_partial, is_prime, strip_partial
from .plan import _floor_or_true_div, get_plan

__all__ = [
    "dprt_sharded",
    "idprt_sharded",
    "dprt_batch_sharded",
    "idprt_batch_sharded",
    "skew_sum_sharded_pallas",
    "dprt_sharded_pallas",
    "idprt_sharded_pallas",
    "projection_pipeline_sharded",
    "batch_partition_spec",
    "BATCH_AXES",
    "REDUCES",
]

Reduce = Literal["psum", "psum_scatter", "ring"]
REDUCES = ("psum", "psum_scatter", "ring")

#: axes a batch may shard over (leading mesh axes of the standard
#: production meshes); the row super-strips take the remaining axis.
BATCH_AXES = ("pod", "data")


def _dim_names(mesh) -> tuple:
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs dim names, e.g. init_device_mesh("
                         "..., mesh_dim_names=('data', 'model'))")
    return tuple(mesh.mesh_dim_names)


def _row_axis(mesh) -> str:
    """Row-sharding axis: 'model' if present, else the mesh's last axis
    (leading axes are batch/data axes by convention)."""
    names = _dim_names(mesh)
    return "model" if "model" in names else names[-1]


def _batch_axes(mesh, row_axis: Optional[str]) -> tuple:
    """Data axes a batched stack shards over (never the row axis)."""
    names = _dim_names(mesh)
    return tuple(a for a in BATCH_AXES if a in names and a != row_axis)


def batch_partition_spec(mesh) -> tuple:
    """The mesh-natural placements of a (B, rows, N) stack, one per mesh
    dim: the batch sharded over the mesh's data axes (``Shard(0)``),
    replicated over the row axis -- the port of the reference's
    ``PartitionSpec(data_axes, None, None)``, and what
    :attr:`repro_torch.radon.RadonOperator.input_sharding` gives."""
    baxes = _batch_axes(mesh, _row_axis(mesh))
    return tuple(Shard(0) if a in baxes else Replicate()
                 for a in _dim_names(mesh))


def _chunk(size: int, parts: int, index: int) -> tuple:
    """[lo, hi) of chunk ``index`` of ``size`` split as ``torch.chunk``
    and DTensor split it: chunks of ceil(size / parts), the last ones
    shorter or empty."""
    c = -(-size // parts)
    return min(index * c, size), min((index + 1) * c, size)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """How a (…, rows, N) array lies on the mesh: rows over ``axis``
    (None: not sharded), a batch over ``baxes``."""

    mesh: object
    axis: Optional[str]
    baxes: tuple

    @property
    def devs(self) -> int:
        return 1 if self.axis is None else self.mesh.size(
            _dim_names(self.mesh).index(self.axis))

    @property
    def rank(self) -> int:
        return 0 if self.axis is None else self.mesh.get_local_rank(
            self.axis)

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    def rows(self, size: int) -> tuple:
        return _chunk(size, self.devs, self.rank)

    def batch(self, b: int) -> tuple:
        """This rank's images: the batch chunked over each data axis in
        turn, as a DTensor with ``Shard(0)`` on each of them is."""
        lo, hi = 0, b
        for a in self.baxes:
            k = self.mesh.size(_dim_names(self.mesh).index(a))
            c_lo, c_hi = _chunk(hi - lo, k, self.mesh.get_local_rank(a))
            lo, hi = lo + c_lo, lo + c_hi
        return lo, hi

    def placements(self, batched: bool, rows_sharded: bool,
                   row_dim: int) -> tuple:
        out = []
        for name in _dim_names(self.mesh):
            if batched and name in self.baxes:
                out.append(Shard(0))
            elif rows_sharded and name == self.axis:
                out.append(Shard(row_dim))
            else:
                out.append(Replicate())
        return tuple(out)

    def holds(self, x, batched: bool, rows: bool = True) -> bool:
        """Whether ``x`` is a DTensor laid out as this layout's blocks."""
        return (isinstance(x, DTensor) and x.device_mesh == self.mesh
                and tuple(x.placements)
                == self.placements(batched, rows, x.ndim - 2))

    def take(self, x, batched: bool, rows: bool = True) -> torch.Tensor:
        """This rank's block of the global array ``x``: its batch chunk
        and (``rows``) its row chunk.  A DTensor laid out that way
        already is used in place."""
        if self.holds(x, batched, rows):
            return x.to_local()
        x = _global(x)
        if rows and self.axis is not None:
            lo, hi = self.rows(x.shape[-2])
            x = x[..., lo:hi, :]
        if batched and self.baxes:
            lo, hi = self.batch(x.shape[0])
            x = x[lo:hi]
        return x

    def wrap(self, local: torch.Tensor, shape: tuple, batched: bool,
             rows_sharded: bool) -> DTensor:
        """The global DTensor of shape ``shape`` whose block on this rank
        is ``local``."""
        stride, acc = [], 1
        for s in reversed(shape):
            stride.insert(0, acc)
            acc *= s
        return DTensor.from_local(
            local, self.mesh,
            self.placements(batched, rows_sharded, len(shape) - 2),
            run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def _shard_layout(g, mesh, axis: Optional[str],
                  batch_axes: Optional[tuple]) -> _Layout:
    """The single convention point for laying a (…, rows, N) input onto
    the mesh: the row axis and the batch axes, for every per-shard
    datapath, so the layout rules cannot diverge."""
    _check_mesh_device(g, mesh)
    if axis is None:
        axis = _row_axis(mesh)
    if g.ndim != 3:
        baxes = ()
    elif batch_axes is None:
        baxes = _batch_axes(mesh, axis)
    else:
        names = _dim_names(mesh)
        baxes = tuple(a for a in batch_axes if a in names and a != axis)
    return _Layout(mesh, axis, baxes)


def _check_mesh_device(x, mesh) -> None:
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh takes "
                         f"{mesh.device_type} tensors, got one on "
                         f"{x.device}")


def _global(x) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _ring_reduce_scatter(x: torch.Tensor, lay: _Layout,
                         rows: int) -> torch.Tensor:
    """Reduce-scatter ``x`` (padded rows leading) over the row axis with
    an explicit send/receive ring instead of ``reduce_scatter_tensor``.

    Rank r ends holding the fully reduced chunk r (the layout of
    ``psum_scatter``).  Each of the devs-1 steps moves ONE chunk of
    ``rows`` rows to the right neighbour and adds the local share of
    the chunk's eventual owner -- the reference's chunk order.
    """
    devs, r, group = lay.devs, lay.rank, lay.group
    right = dist.get_global_rank(group, (r + 1) % devs)
    left = dist.get_global_rank(group, (r - 1) % devs)

    def chunk(i):
        return x[i * rows:(i + 1) * rows]

    buf = chunk((r - 1) % devs).clone()
    for t in range(devs - 1):
        nxt = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, buf, right, group),
                dist.P2POp(dist.irecv, nxt, left, group)]):
            req.wait()
        buf = nxt + chunk((r - t - 2) % devs)
    return buf


def _reduce_partial(part: torch.Tensor, lay: _Layout, out_rows: int,
                    reduce: str, trim: bool = True) -> torch.Tensor:
    """Apply the configured collective to a per-rank partial
    (…, out_rows, N).  ``psum`` returns the whole sum; ``psum_scatter``
    and ``ring`` this rank's chunk of rows (``trim=False``: padded to
    the chunk size, rows past ``out_rows`` zero)."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    devs = lay.devs
    if devs == 1:           # this rank's chunk is every row
        return part
    if reduce == "psum":
        if part.numel():    # a rank's group shares its batch chunk
            dist.all_reduce(part, group=lay.group)
        return part
    rows = -(-out_rows // devs)
    pad = rows * devs - part.shape[-2]
    if pad:
        part = torch.cat([part, part.new_zeros(
            (*part.shape[:-2], pad, part.shape[-1]))], dim=-2)
    # reduce_scatter_tensor splits dim 0: move the row dim there and back
    # (scattering a batched partial as it stands would scatter the batch)
    lead = part.movedim(-2, 0).contiguous()
    if lead.numel() == 0:
        out = lead.new_zeros((rows, *lead.shape[1:]))
    elif reduce == "ring":
        out = _ring_reduce_scatter(lead, lay, rows)
    else:
        out = lead.new_empty((rows, *lead.shape[1:]))
        dist.reduce_scatter_tensor(out, lead, group=lay.group)
    out = out.movedim(0, -2)
    if trim:
        lo, hi = lay.rows(out_rows)
        out = out[..., :hi - lo, :]
    return out.contiguous()


# ---------------------------------------------------------------------------
# legacy "sharded" backend: per-rank Horner scan + alignment gather
# ---------------------------------------------------------------------------
def _skew_sum_sharded(g, mesh, axis: str = "model", reduce: Reduce = "psum",
                      sign: int = 1, forward: bool = False) -> DTensor:
    """Skew-sum of (…, rows, N) with rows sharded over ``axis``: each rank
    scans its rows with the torch Horner recurrence and aligns them to
    their global offset; ``forward`` adds the row-sum row R(N, d) of the
    rank's rows at their global positions, so one collective assembles
    the whole forward transform."""
    n = g.shape[-1]
    _check_mesh_device(g, mesh)
    lay = _Layout(mesh, axis, ())
    gl = lay.take(g, batched=False)
    lo, hi = lay.rows(g.shape[-2])
    acc = accum_dtype_for(g.dtype, n)
    out_rows = n + 1 if forward else n
    part = torch.zeros((*gl.shape[:-2], out_rows, n), dtype=acc,
                       device=gl.device)
    if hi > lo:
        part[..., :n, :] = align_partial(
            strip_partial(gl, n, sign=sign, acc_dtype=acc), lo, sign)
        if forward:
            keep = min(hi, n) - lo
            part[..., n, lo:lo + keep] = gl[..., :keep, :].to(acc).sum(
                -1, dtype=acc)
    local = _reduce_partial(part, lay, out_rows, reduce)
    return lay.wrap(local, (*g.shape[:-2], out_rows, n), False,
                    reduce != "psum")


def dprt_sharded(f, mesh, axis: str = "model",
                 reduce: Reduce = "psum") -> DTensor:
    """Forward DPRT of (N, N) -- or a (B, N, N) stack, every rank holding
    the whole batch -- with the image rows sharded over ``axis``.

    Returns the (…, N+1, N) transform; its direction rows are sharded
    over ``axis`` unless ``reduce='psum'`` (replicated)."""
    n = f.shape[-1]
    if f.shape[-2] != n or not is_prime(n):
        raise ValueError(f"DPRT needs prime N, got {n}")
    return _skew_sum_sharded(f, mesh, axis, reduce, sign=1, forward=True)


def idprt_sharded(r, mesh, axis: str = "model",
                  reduce: Reduce = "psum") -> DTensor:
    """Inverse DPRT with the projection rows sharded over ``axis``."""
    n = r.shape[-1]
    if r.shape[-2] != n + 1 or not is_prime(n):
        raise ValueError(f"iDPRT input must be (N+1, N), N prime: "
                         f"{tuple(r.shape)}")
    rg = _global(r)
    z = _skew_sum_sharded(rg[..., :n, :], mesh, axis, reduce, sign=-1)
    return _inverse_epilogue_sharded(z, rg, n, _Layout(mesh, axis, ()),
                                     batched=False)


def _batch_sharded(xb, mesh, batch_axes, method: str, datapath: str,
                   out_rows: int) -> DTensor:
    _check_mesh_device(xb, mesh)
    lay = _Layout(mesh, None,
                  tuple(a for a in batch_axes if a in _dim_names(mesh)))
    xl = lay.take(xb, batched=True, rows=False)
    n = xb.shape[-1]
    if xl.shape[0]:
        plan = get_plan((xl.shape[0], n, n), xl.dtype, method)
        out = getattr(plan, datapath)(xl)
    else:
        out = torch.empty((0, out_rows, n), dtype=accum_dtype_for(
            xl.dtype, n), device=xl.device)
    return lay.wrap(out, (xb.shape[0], out_rows, n), True, False)


def dprt_batch_sharded(fb, mesh, batch_axes=BATCH_AXES,
                       method: str = "horner") -> DTensor:
    """DPRT of a batch of images, batch sharded over the data axes.

    This is the FPGA-coprocessor service pattern of Sec. V-B scaled out:
    every rank transforms its own images; no collectives at all.  A mesh
    without a data axis leaves the batch whole on every rank."""
    n = fb.shape[-1]
    if fb.ndim != 3 or fb.shape[-2] != n:
        raise ValueError(f"dprt_batch_sharded needs (B, N, N): "
                         f"{tuple(fb.shape)}")
    return _batch_sharded(fb, mesh, batch_axes, method, "forward", n + 1)


def idprt_batch_sharded(rb, mesh, batch_axes=BATCH_AXES,
                        method: str = "horner") -> DTensor:
    """Inverse DPRT of a (B, N+1, N) stack, batch sharded over the data
    axes: every rank reconstructs its own images, no collectives."""
    n = rb.shape[-1]
    if rb.ndim != 3 or rb.shape[-2] != n + 1 or not is_prime(n):
        raise ValueError(
            f"idprt_batch_sharded needs (B, N+1, N), N prime: "
            f"{tuple(rb.shape)}")
    return _batch_sharded(rb, mesh, batch_axes, method, "inverse", n)


# ---------------------------------------------------------------------------
# "sharded_cuda" backend: per-shard kernel + one collective
# ---------------------------------------------------------------------------
def _sharded_partials(g, mesh, mode: str = "core", sign: int = 1,
                      axis: Optional[str] = None,
                      batch_axes: Optional[tuple] = None,
                      reduce: Reduce = "psum",
                      strip_rows: Optional[int] = None,
                      m_block: Optional[int] = None,
                      stream_rows: Optional[int] = None,
                      mask_rows_from: Optional[int] = None) -> DTensor:
    """Shared mesh datapath: per-rank kernel + one collective.

    Rows of ``g`` (…, rows, N) shard over the mesh's row axis, a batch
    over its data axes.  Every rank runs ONE kernel call over its local
    (B_local, rows_local, N) block with its first global row as
    ``row_offset``: K1 (or K4/K5 with ``stream_rows``) in core mode for
    the skew-sum partial, in forward mode with the R(N, d) row-sum row
    at global positions for the forward.  ``mask_rows_from`` drops the
    rank's rows of global index >= the bound before the kernel -- how
    the inverse consumes a direction-sharded (N+1)-row forward layout in
    place.  A rank left with no rows (or images) launches nothing and
    adds zeros.
    """
    from ..kernels.ops import dprt_cuda_strip, skew_sum_cuda_strip

    n = g.shape[-1]
    out_rows = n + 1 if mode == "forward" else n
    batched = g.ndim == 3
    lay = _shard_layout(g, mesh, axis, batch_axes)
    gl = lay.take(g, batched)
    lo, hi = lay.rows(g.shape[-2])
    if mask_rows_from is not None:
        gl = gl[..., :max(0, min(hi, mask_rows_from) - lo), :]
    if gl.shape[-2] == 0 or gl.numel() == 0:
        part = torch.zeros((*gl.shape[:-2], out_rows, n),
                           dtype=accum_dtype_for(g.dtype, n),
                           device=gl.device)
    elif mode == "forward":
        part = dprt_cuda_strip(gl, row_offset=lo, strip_rows=strip_rows,
                               m_block=m_block, stream_rows=stream_rows)
    else:
        part = skew_sum_cuda_strip(gl, sign, row_offset=lo,
                                   strip_rows=strip_rows, m_block=m_block,
                                   stream_rows=stream_rows)
    local = _reduce_partial(part, lay, out_rows, reduce)
    return lay.wrap(local, (*g.shape[:-2], out_rows, n), batched,
                    reduce != "psum")


def skew_sum_sharded_pallas(g, mesh, sign: int = 1,
                            axis: Optional[str] = None,
                            batch_axes: Optional[tuple] = None,
                            reduce: Reduce = "psum",
                            strip_rows: Optional[int] = None,
                            m_block: Optional[int] = None,
                            stream_rows: Optional[int] = None) -> DTensor:
    """skew_sum of (rows, N) -- or a (B, rows, N) stack -- with rows
    sharded over the mesh's row axis and the batch over its data axes;
    one kernel call per rank, one collective."""
    return _sharded_partials(g, mesh, mode="core", sign=sign, axis=axis,
                             batch_axes=batch_axes, reduce=reduce,
                             strip_rows=strip_rows, m_block=m_block,
                             stream_rows=stream_rows)


def dprt_sharded_pallas(f, mesh, reduce: Reduce = "psum_scatter",
                        strip_rows: Optional[int] = None,
                        m_block: Optional[int] = None,
                        stream_rows: Optional[int] = None) -> DTensor:
    """Forward DPRT of (N, N) -- or a (B, N, N) stack -- via the
    per-shard kernel: the R(N, d) row-sum row is made in-kernel at
    global positions, so the whole distributed forward is one kernel
    call per rank plus one collective.  The default layout is
    direction-sharded (``psum_scatter``): each rank keeps only its chunk
    of directions, 1/devices the collective bytes of an ``all_reduce``
    (``reduce="psum"``; ``"ring"`` builds the sharded layout from
    explicit sends)."""
    n = f.shape[-1]
    if f.shape[-2] != n or not is_prime(n):
        raise ValueError(f"DPRT needs prime (…, N, N), got "
                         f"{tuple(f.shape)}")
    return _sharded_partials(f, mesh, mode="forward", reduce=reduce,
                             strip_rows=strip_rows, m_block=m_block,
                             stream_rows=stream_rows)


def _inverse_epilogue_sharded(z: DTensor, r, n: int, lay: _Layout,
                              batched: bool) -> DTensor:
    """-S + R(N, i) and the exact divide by N on this rank's block of
    ``z``; needs the global rows 0 and N of ``r``, gathered with one
    2-row ``all_reduce`` when ``r`` is direction-sharded in place."""
    zl = z.to_local()
    rows_sharded = any(isinstance(p, Shard) and p.dim == z.ndim - 2
                       for p in z.placements)
    lo, hi = lay.rows(n) if rows_sharded else (0, n)
    acc = zl.dtype
    if lay.holds(r, batched):
        # direction-sharded in place: rows 0 and N live on their owners
        rl = r.to_local()
        rlo, rhi = lay.rows(n + 1)
        edge = torch.zeros((*rl.shape[:-2], 2, n), dtype=acc,
                           device=rl.device)
        if rlo == 0 < rhi:
            edge[..., 0, :] = rl[..., 0, :]
        if rlo <= n < rhi:
            edge[..., 1, :] = rl[..., n - rlo, :]
        if lay.devs > 1 and edge.numel():
            dist.all_reduce(edge, group=lay.group)
    else:
        rb = _global(r)
        if batched and lay.baxes:
            blo, bhi = lay.batch(rb.shape[0])
            rb = rb[blo:bhi]
        edge = rb[..., [0, n], :].to(acc)
    s = edge[..., 0, :].sum(-1, dtype=acc)[..., None, None]
    num = zl - s + edge[..., 1, lo:hi][..., :, None]
    return lay.wrap(_floor_or_true_div(num, n), tuple(z.shape), batched,
                    rows_sharded)


def idprt_sharded_pallas(r, mesh, reduce: Reduce = "psum_scatter",
                         strip_rows: Optional[int] = None,
                         m_block: Optional[int] = None,
                         stream_rows: Optional[int] = None) -> DTensor:
    """Inverse DPRT of (N+1, N) -- or a (B, N+1, N) stack -- via the
    per-shard kernel path.

    Consumes the forward's direction-sharded layout IN PLACE: the full
    (N+1)-row input (not a [:N] slice) shards over the row axis in the
    same chunks ``psum_scatter`` produced, and rows of global index >= N
    (the R(N, d) row) are dropped in-shard before the kernel --
    algebraically the slice, with no re-shard between a forward and its
    inverse.  The -S + R(N, i) and exact divide-by-N epilogue needs the
    global sums, so it runs after the collective: O(N^2) elementwise."""
    n = r.shape[-1]
    if r.shape[-2] != n + 1 or not is_prime(n):
        raise ValueError(
            f"iDPRT input must be (…, N+1, N), N prime: {tuple(r.shape)}")
    z = _sharded_partials(r, mesh, mode="core", sign=-1, reduce=reduce,
                          strip_rows=strip_rows, m_block=m_block,
                          stream_rows=stream_rows, mask_rows_from=n)
    lay = _shard_layout(r, mesh, None, None)
    return _inverse_epilogue_sharded(z, r, n, lay, r.ndim == 3)


# ---------------------------------------------------------------------------
# mesh-composed projection-domain pipeline (fused conv / filter)
# ---------------------------------------------------------------------------
def projection_pipeline_sharded(f, mesh, op: str = "conv", operand=None,
                                axis: Optional[str] = None,
                                batch_axes: Optional[tuple] = None,
                                strip_rows: Optional[int] = None,
                                m_block: Optional[int] = None,
                                stream_rows: Optional[int] = None
                                ) -> DTensor:
    """The fused projection pipeline on a mesh: per rank, TWO kernel
    launches with a SINGLE collective between forward and inverse.

    Every O(N^3) stage shards: rank r forward-transforms its row
    super-strip (K1 with its global row offset), a ``reduce_scatter``
    re-shards the summed projections over *directions* -- the one
    collective between forward and inverse -- and K3, the pipeline tail,
    applies the per-direction op (1-D circular convolution / pointwise
    multiply) and the inverse for the rank's direction chunk only.  A
    ``reduce_scatter`` over *image rows* (each rank keeps its output row
    chunk) and an ``all_reduce`` of the 2 aux rows feed the
    -S + R'(N, i) / N correction, which runs on each rank's rows.

    ``operand``: the conv operand as an (N, N) image (its projections
    come from one :func:`dprt_sharded_pallas` with ``psum``) or as
    projections/weights (…, N+1, N); a batched operand shards with the
    image batch.  Exact for integers.  Returns the (…, N, N) result as
    a DTensor: batch over the data axes, rows over the row axis.
    """
    from ..kernels.ops import dprt_cuda_strip, pipeline_tail_cuda
    from ..kernels.pipeline import PIPELINE_OPS

    if op not in PIPELINE_OPS:
        raise ValueError(f"pipeline op must be one of {PIPELINE_OPS}: {op!r}")
    n = f.shape[-1]
    if f.shape[-2] != n or not is_prime(n):
        raise ValueError(f"pipeline needs prime (…, N, N), got "
                         f"{tuple(f.shape)}")
    acc = accum_dtype_for(f.dtype, n)
    batched = f.ndim == 3
    lay = _shard_layout(f, mesh, axis, batch_axes)
    devs, r = lay.devs, lay.rank
    dirs_loc = math.ceil((n + 1) / devs)

    wl = None
    if op != "none":
        if operand is None:
            raise ValueError(f"pipeline op {op!r} needs an operand")
        if op == "conv" and tuple(operand.shape[-2:]) == (n, n):
            # one sharded forward (kernel + all_reduce) turns the image
            # operand into its replicated projections
            operand = dprt_sharded_pallas(operand, mesh, reduce="psum",
                                          strip_rows=strip_rows,
                                          m_block=m_block,
                                          stream_rows=stream_rows)
        wp = _global(operand).to(acc)
        w_batched = wp.ndim == 3 and batched and wp.shape[0] == f.shape[0]
        if w_batched:
            blo, bhi = lay.batch(wp.shape[0])
            wl = wp[blo:bhi]
        elif wp.ndim == 3:
            if wp.shape[0] != 1:    # same contract as the unsharded path
                raise ValueError(
                    f"batched pipeline operand must match the stack batch "
                    f"({f.shape[0] if batched else 'unbatched'}), got "
                    f"{tuple(operand.shape)}")
            wl = wp[0]
        else:
            wl = wp

    gl = lay.take(f, batched)
    gl = gl if batched else gl[None]
    lo, hi = lay.rows(n)
    if hi > lo and gl.shape[0]:
        part = dprt_cuda_strip(gl, row_offset=lo, strip_rows=strip_rows,
                               m_block=m_block, stream_rows=stream_rows)
    else:
        part = torch.zeros((gl.shape[0], n + 1, n), dtype=acc,
                           device=gl.device)
    # collective ONE of two: re-shard the summed projections over
    # directions; the shard keeps its padding rows (> N), which K3 zeroes
    rc_loc = _reduce_partial(part, lay, n + 1, "psum_scatter", trim=False)
    if gl.shape[0]:
        z, aux = pipeline_tail_cuda(rc_loc, op, wl, row_offset=r * dirs_loc,
                                    n=n)
    else:
        z = torch.zeros((0, n, n), dtype=acc, device=gl.device)
        aux = torch.zeros((0, 2, n), dtype=acc, device=gl.device)
    # collective TWO: scatter the reconstruction over image rows (the aux
    # rows the deferred correction needs are global sums, but 2 rows)
    z_loc = _reduce_partial(z, lay, n, "psum_scatter")
    if devs > 1 and aux.numel():
        dist.all_reduce(aux, group=lay.group)
    s = aux[:, 0].sum(-1, dtype=acc)[:, None, None]
    out = _floor_or_true_div(z_loc - s + aux[:, 1, lo:hi][:, :, None], n)
    return lay.wrap(out if batched else out[0], tuple(f.shape), batched,
                    True)
