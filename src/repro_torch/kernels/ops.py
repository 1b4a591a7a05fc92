"""Public wrappers around K1, the fused SFDPRT kernel, K4/K5, the
streamed kernel, and K2, the fused projection-domain pipeline.

The port of :mod:`repro.kernels.ops`: the layer the plan's ``cuda``
backend dispatches to.  Each wrapper takes a single (N, N) image or a
batched (B, N, N) stack (one kernel call per stack), resolves block
shapes through :mod:`.tuning` when not given, and returns
:func:`repro_torch.core.dprt.accum_dtype_for` (the forward and the bare
skew-sum sum in :func:`repro_torch.core.dprt.forward_sum_dtype_for`,
and the kernels' tiles follow that width).  The forward/inverse
epilogues run inside K1; :func:`projection_pipeline_cuda` runs forward,
per-direction op and inverse in one K2 call.

``stream_rows`` on the five transform wrappers streams the image
through the streamed kernel (:mod:`.stream`, K5 -- the reference's
compiled default ``stream_impl="dma"``) in one launch instead of K1.

A CUDA tensor always goes through the kernel (or raises); a CPU tensor
takes the kernel's plain version (:func:`.sfdprt.sfdprt_plain`,
:func:`.stream.stream_plain`, :func:`.pipeline.pipeline_plain`,
:func:`.pipeline.pipeline_tail_plain`).  :func:`pipeline_tail_cuda` is
the shard-local tail of the mesh pipeline, K3
(:func:`repro_torch.core.distributed.projection_pipeline_sharded`).

The reference's names (``dprt_pallas``, ``idprt_pallas``,
``skew_sum_pallas``, ``skew_sum_pallas_strip``, ``dprt_pallas_strip``,
``projection_pipeline_pallas``, ``pipeline_tail_pallas``) are thin
wrappers over the ``*_cuda`` functions with the reference's signatures:
their ``interpret`` argument, a TPU-only knob, is accepted and changes
nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dprt import accum_dtype_for, forward_sum_dtype_for, is_prime
from .pipeline import PIPELINE_OPS, pipeline_raw, pipeline_tail_raw
from .sfdprt import _rows_contiguous, dprt_raw, idprt_raw, skew_sum_raw
from .tuning import resolve_blocks, resolve_pipeline_blocks

__all__ = ["dprt_cuda", "idprt_cuda", "skew_sum_cuda",
           "skew_sum_cuda_strip", "dprt_cuda_strip",
           "projection_pipeline_cuda", "pipeline_tail_cuda",
           "dprt_pallas", "idprt_pallas", "skew_sum_pallas",
           "skew_sum_pallas_strip", "dprt_pallas_strip",
           "projection_pipeline_pallas", "pipeline_tail_pallas"]


def _resolve_blocks(n: int, strip_rows: Optional[int],
                    m_block: Optional[int], operand: torch.dtype,
                    stream_rows: Optional[int] = None) -> tuple[int, int]:
    """(strip_rows, m_block) for a kernel that sums in ``operand``."""
    return resolve_blocks(n, operand.itemsize, strip_rows, m_block,
                          stream_rows=stream_rows)


def skew_sum_cuda(g: torch.Tensor, sign: int = 1,
                  strip_rows: Optional[int] = None,
                  m_block: Optional[int] = None,
                  stream_rows: Optional[int] = None) -> torch.Tensor:
    """Bare skew-sum: (N, N), or a (B, N, N) stack in one launch.

    Counterpart of ``repro.kernels.ops.skew_sum_pallas``; serves the
    plan's batched adjoint datapaths (exact gradients through the
    kernel)."""
    n = g.shape[-1]
    h, mb = _resolve_blocks(n, strip_rows, m_block,
                            forward_sum_dtype_for(g.dtype, n), stream_rows)
    return skew_sum_raw(g, sign=sign, strip_rows=h, m_block=mb,
                        stream_rows=stream_rows)


def skew_sum_cuda_strip(g: torch.Tensor, sign: int = 1, *,
                        row_offset: int = 0,
                        strip_rows: Optional[int] = None,
                        m_block: Optional[int] = None,
                        stream_rows: Optional[int] = None) -> torch.Tensor:
    """Partial skew-sum of a (rows, N) or (B, rows, N) row strip whose
    first global image row is ``row_offset``: the (…, N, N) partial
    aligned to global rows.  Counterpart of
    ``repro.kernels.ops.skew_sum_pallas_strip``; summing the partials of
    all strips gives the full skew-sum."""
    n = g.shape[-1]
    h, mb = _resolve_blocks(n, strip_rows, m_block,
                            forward_sum_dtype_for(g.dtype, n), stream_rows)
    return skew_sum_raw(g, sign=sign, strip_rows=h, m_block=mb,
                        row_offset=row_offset,
                        stream_rows=stream_rows)


def dprt_cuda_strip(g: torch.Tensor, *, row_offset: int = 0,
                    strip_rows: Optional[int] = None,
                    m_block: Optional[int] = None,
                    stream_rows: Optional[int] = None) -> torch.Tensor:
    """Partial forward DPRT of a row strip starting at global image row
    ``row_offset``: (…, N+1, N), the row-sum row placed at the strip's
    global positions.  Counterpart of
    ``repro.kernels.ops.dprt_pallas_strip``."""
    n = g.shape[-1]
    single = g.ndim == 2
    gb = g[None] if single else g
    h, mb = _resolve_blocks(n, strip_rows, m_block,
                            forward_sum_dtype_for(g.dtype, n), stream_rows)
    out = dprt_raw(gb, strip_rows=h, m_block=mb, row_offset=row_offset,
                   stream_rows=stream_rows)
    return out[0] if single else out


def dprt_cuda(f: torch.Tensor, strip_rows: Optional[int] = None,
              m_block: Optional[int] = None,
              stream_rows: Optional[int] = None) -> torch.Tensor:
    """Forward DPRT via K1: (N, N) -> (N+1, N), or batched
    (B, N, N) -> (B, N+1, N) in one launch.  Counterpart of
    ``repro.kernels.ops.dprt_pallas``."""
    single = f.ndim == 2
    fb = f[None] if single else f
    if fb.ndim != 3 or fb.shape[-1] != fb.shape[-2]:
        raise ValueError(f"DPRT needs (B, N, N) or (N, N), got "
                         f"{tuple(f.shape)}")
    n = fb.shape[-1]
    if not is_prime(n):
        raise ValueError(f"DPRT needs prime N, got {n}")
    h, mb = _resolve_blocks(n, strip_rows, m_block,
                            forward_sum_dtype_for(fb.dtype, n), stream_rows)
    out = dprt_raw(fb, strip_rows=h, m_block=mb,
                   stream_rows=stream_rows)
    return out[0] if single else out


def idprt_cuda(r: torch.Tensor, strip_rows: Optional[int] = None,
               m_block: Optional[int] = None,
               stream_rows: Optional[int] = None) -> torch.Tensor:
    """Inverse DPRT via K1: (N+1, N) -> (N, N), or batched
    (B, N+1, N) -> (B, N, N) in one launch; exact for integers.
    Counterpart of ``repro.kernels.ops.idprt_pallas``."""
    single = r.ndim == 2
    rb = r[None] if single else r
    n = rb.shape[-1]
    if rb.ndim != 3 or rb.shape[-2] != n + 1 or not is_prime(n):
        raise ValueError(
            f"iDPRT input must be (B, N+1, N) or (N+1, N) with N prime: "
            f"{tuple(r.shape)}")
    h, mb = _resolve_blocks(n, strip_rows, m_block,
                            accum_dtype_for(rb.dtype, n), stream_rows)
    out = idprt_raw(rb, strip_rows=h, m_block=mb,
                    stream_rows=stream_rows)
    return out[0] if single else out


def projection_pipeline_cuda(f: torch.Tensor, op: str = "conv",
                             operand: Optional[torch.Tensor] = None,
                             operand_form: Optional[str] = None,
                             m_block: Optional[int] = None,
                             group: Optional[int] = None,
                             lane_batch: Optional[int] = None
                             ) -> torch.Tensor:
    """Fused projection-domain pipeline: inverse(op(forward(f))) in one
    K2 call -- the projections never reach device memory.
    Counterpart of ``repro.kernels.ops.projection_pipeline_pallas``.

    ``f``: (N, N) or a (B, N, N) stack, N prime.  ``op``:

    * ``"conv"`` -- per-direction 1-D circular convolution against the
      second operand, i.e. exact 2-D circular convolution.  ``operand``
      is the other image ((N, N) shared or (B, N, N) matched; its
      forward runs in-kernel) or its projections ((N+1, N) /
      (B, N+1, N)), the form inferred from the trailing shape unless
      ``operand_form`` says.
    * ``"mul"``  -- pointwise projection-domain multiply by (N+1, N) /
      (B, N+1, N) weights (the ``inv @ pointwise @ fwd`` fusion).
    * ``"none"`` -- inverse(forward(f)): the fused round trip.

    Returns the (…, N, N) result in the accumulator dtype, bit-exact for
    integers.  ``group`` and ``lane_batch`` are validated and change no
    output on Hopper.
    """
    if op not in PIPELINE_OPS:
        raise ValueError(f"pipeline op must be one of {PIPELINE_OPS}: {op!r}")
    single = f.ndim == 2
    fb = f[None] if single else f
    if fb.ndim != 3 or fb.shape[-1] != fb.shape[-2]:
        raise ValueError(f"pipeline needs (B, N, N) or (N, N), got "
                         f"{tuple(f.shape)}")
    n = fb.shape[-1]
    if not is_prime(n):
        raise ValueError(f"pipeline needs prime N, got {n}")
    acc = accum_dtype_for(fb.dtype, n)
    wb = None
    if op != "none":
        if operand is None:
            raise ValueError(f"pipeline op {op!r} needs an operand")
        wb = operand[None] if operand.ndim == 2 else operand
        if operand_form is None:
            operand_form = "image" if (op == "conv"
                                       and wb.shape[-2] == n) else "proj"
        want = (n, n) if (op == "conv" and operand_form == "image") \
            else (n + 1, n)
        if wb.ndim != 3 or tuple(wb.shape[-2:]) != want:
            raise ValueError(
                f"pipeline operand for op={op!r}/{operand_form} must be "
                f"(…, {want[0]}, {want[1]}), got {tuple(operand.shape)}")
        if wb.shape[0] not in (1, fb.shape[0]):
            raise ValueError(
                f"batched pipeline operand must match the stack batch "
                f"({fb.shape[0]}), got {tuple(operand.shape)}")
        wb = _rows_contiguous(wb.to(acc))
    mb, grp = resolve_pipeline_blocks(n, acc.itemsize, m_block, group)
    lb = 1 if lane_batch is None else int(lane_batch)
    out, _aux = pipeline_raw(_rows_contiguous(fb.to(acc)), wb, op=op,
                             operand_form=operand_form or "proj",
                             m_block=mb, group=grp, lane_batch=lb)
    return out[0] if single else out


def pipeline_tail_cuda(rows, op: str = "conv", operand=None, *,
                       row_offset: int = 0, n: Optional[int] = None,
                       m_block: Optional[int] = None,
                       group: Optional[int] = None,
                       lane_batch: Optional[int] = None):
    """Shard-local pipeline tail (K3): already-assembled projection rows
    in, per-direction op + inverse out, correction deferred.
    Counterpart of ``repro.kernels.ops.pipeline_tail_pallas``.

    ``rows``: (dirs_local, N) or (B, dirs_local, N) -- one shard of
    direction rows, first global direction ``row_offset``; rows of
    global index > N (the padding of the direction space) count as
    zero.  ``operand``: the full (N+1, N) or (B|1, N+1, N) projections
    (``conv``) or weights (``mul``), read at the shard's global
    directions; None for ``op="none"``.  Returns ``(z, aux)`` partials in
    the accumulator dtype -- summing both over every shard and applying
    the -S + R'(N, i) / N correction reconstructs exactly; see
    :func:`repro_torch.core.distributed.projection_pipeline_sharded`.
    ``m_block`` (directions per thread block) comes from the pipeline
    table and is capped at the shard's row count; ``group`` and
    ``lane_batch`` change no output.
    """
    if op not in PIPELINE_OPS:
        raise ValueError(f"pipeline op must be one of {PIPELINE_OPS}: {op!r}")
    single = rows.ndim == 2
    rb = rows[None] if single else rows
    if n is None:
        n = rb.shape[-1]
    if rb.ndim != 3 or rb.shape[-1] != n:
        raise ValueError(f"pipeline tail rows must be (…, rows, {n}), got "
                         f"{tuple(rows.shape)}")
    acc = accum_dtype_for(rb.dtype, n)
    mb, _grp = resolve_pipeline_blocks(n, acc.itemsize, m_block, group)
    mb = min(mb, rb.shape[-2])
    if lane_batch is not None and int(lane_batch) < 1:
        raise ValueError(f"lane_batch must be >= 1, got {lane_batch}")
    wb = None
    if op != "none":
        if operand is None:
            raise ValueError(f"pipeline op {op!r} needs an operand")
        wb = _rows_contiguous((operand[None] if operand.ndim == 2
                               else operand).to(acc))
    z, aux = pipeline_tail_raw(_rows_contiguous(rb.to(acc)), wb, op=op,
                               row_offset=int(row_offset), m_block=mb)
    if single:
        return z[0], aux[0]
    return z, aux


# ---------------------------------------------------------------------------
# the reference's public names, with its signatures (``interpret`` ignored)
# ---------------------------------------------------------------------------
def skew_sum_pallas(g: torch.Tensor, sign: int = 1,
                    strip_rows: Optional[int] = None,
                    m_block: Optional[int] = None,
                    interpret: Optional[bool] = None,
                    stream_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`skew_sum_cuda` under the reference's name."""
    return skew_sum_cuda(g, sign, strip_rows, m_block, stream_rows)


def skew_sum_pallas_strip(g: torch.Tensor, sign: int = 1, *,
                          row_offset: int = 0,
                          strip_rows: Optional[int] = None,
                          m_block: Optional[int] = None,
                          interpret: Optional[bool] = None,
                          stream_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`skew_sum_cuda_strip` under the reference's name."""
    return skew_sum_cuda_strip(g, sign, row_offset=row_offset,
                               strip_rows=strip_rows, m_block=m_block,
                               stream_rows=stream_rows)


def dprt_pallas_strip(g: torch.Tensor, *, row_offset: int = 0,
                      strip_rows: Optional[int] = None,
                      m_block: Optional[int] = None,
                      interpret: Optional[bool] = None,
                      stream_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`dprt_cuda_strip` under the reference's name."""
    return dprt_cuda_strip(g, row_offset=row_offset, strip_rows=strip_rows,
                           m_block=m_block, stream_rows=stream_rows)


def dprt_pallas(f: torch.Tensor, strip_rows: Optional[int] = None,
                m_block: Optional[int] = None,
                interpret: Optional[bool] = None,
                stream_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`dprt_cuda` under the reference's name."""
    return dprt_cuda(f, strip_rows, m_block, stream_rows)


def idprt_pallas(r: torch.Tensor, strip_rows: Optional[int] = None,
                 m_block: Optional[int] = None,
                 interpret: Optional[bool] = None,
                 stream_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`idprt_cuda` under the reference's name."""
    return idprt_cuda(r, strip_rows, m_block, stream_rows)


def projection_pipeline_pallas(f, op: str = "conv", operand=None,
                               operand_form: Optional[str] = None,
                               m_block: Optional[int] = None,
                               group: Optional[int] = None,
                               lane_batch: Optional[int] = None,
                               interpret: Optional[bool] = None):
    """:func:`projection_pipeline_cuda` under the reference's name."""
    return projection_pipeline_cuda(f, op, operand, operand_form, m_block,
                                    group, lane_batch)


def pipeline_tail_pallas(rows, op: str = "conv", operand=None, *,
                         row_offset: int = 0, n: Optional[int] = None,
                         m_block: Optional[int] = None,
                         group: Optional[int] = None,
                         lane_batch: Optional[int] = None,
                         interpret: Optional[bool] = None):
    """:func:`pipeline_tail_cuda` under the reference's name."""
    return pipeline_tail_cuda(rows, op, operand, row_offset=row_offset, n=n,
                              m_block=m_block, group=group,
                              lane_batch=lane_batch)
