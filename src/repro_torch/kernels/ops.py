"""Public wrappers around K1, the fused SFDPRT kernel.

The port of :mod:`repro.kernels.ops` (transform half): the layer the
plan's ``cuda`` backend dispatches to.  Each wrapper takes a single
(N, N) image or a batched (B, N, N) stack (one kernel launch per
stack), resolves block shapes through :mod:`.tuning` when not given,
and accumulates in :func:`repro_torch.core.dprt.accum_dtype_for`.  The
forward/inverse epilogues run inside the kernel.

A CUDA tensor always goes through the kernel (or raises); a CPU tensor
takes the kernel's plain version (:func:`.sfdprt.sfdprt_plain`).
``stream_rows`` (the streamed kernels K4/K5) is not ported yet and
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dprt import accum_dtype_for, is_prime
from .sfdprt import dprt_raw, idprt_raw, skew_sum_raw
from .tuning import resolve_blocks

__all__ = ["dprt_cuda", "idprt_cuda", "skew_sum_cuda",
           "skew_sum_cuda_strip", "dprt_cuda_strip"]


def _resolve_blocks(n: int, strip_rows: Optional[int],
                    m_block: Optional[int], dtype,
                    stream_rows: Optional[int] = None) -> tuple[int, int]:
    if stream_rows is not None:
        from ..core.plan import STREAM_ROWS_TODO
        raise NotImplementedError(STREAM_ROWS_TODO)
    return resolve_blocks(n, accum_dtype_for(dtype, n).itemsize,
                          strip_rows, m_block)


def skew_sum_cuda(g: torch.Tensor, sign: int = 1,
                  strip_rows: Optional[int] = None,
                  m_block: Optional[int] = None,
                  stream_rows: Optional[int] = None) -> torch.Tensor:
    """Bare skew-sum: (N, N), or a (B, N, N) stack in one launch.

    Counterpart of ``repro.kernels.ops.skew_sum_pallas``; serves the
    plan's batched adjoint datapaths (exact gradients through the
    kernel)."""
    h, mb = _resolve_blocks(g.shape[-1], strip_rows, m_block, g.dtype,
                            stream_rows)
    return skew_sum_raw(g, sign=sign, strip_rows=h, m_block=mb)


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
    h, mb = _resolve_blocks(n, strip_rows, m_block, g.dtype, stream_rows)
    return skew_sum_raw(g, sign=sign, strip_rows=h, m_block=mb,
                        row_offset=row_offset)


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
    h, mb = _resolve_blocks(n, strip_rows, m_block, g.dtype, stream_rows)
    out = dprt_raw(gb, strip_rows=h, m_block=mb, row_offset=row_offset)
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
    h, mb = _resolve_blocks(n, strip_rows, m_block, fb.dtype, stream_rows)
    out = dprt_raw(fb, strip_rows=h, m_block=mb)
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
    h, mb = _resolve_blocks(n, strip_rows, m_block, rb.dtype, stream_rows)
    out = idprt_raw(rb, strip_rows=h, m_block=mb)
    return out[0] if single else out
