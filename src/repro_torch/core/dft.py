"""2-D DFT via the discrete Fourier-slice theorem (Gertner / Grigoryan).

The port of :mod:`repro.core.dft`.  With R the DPRT of f and
``Rhat(m, k) = FFT_d R(m, d)``:

    Rhat(m, k) = Fhat(<-m*k>_N, k)      0 <= m < N      (skew slices)
    Rhat(N, k) = Fhat(k, 0)                             (the v=0 column)

where ``Fhat(u, v) = sum_{i,j} f(i,j) e^{-2pi i (u*i + v*j)/N}``.  N is
prime, so for every v != 0 the map m -> <-m*v>_N is a bijection and the
N+1 length-N 1-D FFTs cover the whole 2-D spectrum.  All O(N^3)
additions happen in exact integer arithmetic in the DPRT (K1 on the
card, one launch per stack); only the N+1 final FFTs (``torch.fft``)
are float.
"""
from __future__ import annotations

from typing import Optional

import torch

from .dprt import is_prime

__all__ = ["dft2_via_dprt", "dft2_via_dprt_batched", "dft2_reference"]


def _resolve_knobs(method, strip_rows, m_block, batch_impl=None) -> tuple:
    """Full ambient-knob snapshot; fallback ``"auto"`` (the ``cuda``
    backend for int/float images)."""
    from ..radon import ambient  # lazy: radon imports core
    return ambient.snapshot_knobs(method, strip_rows, m_block, batch_impl,
                                  fallback_method="auto")


def _dprt_stage(f: torch.Tensor, knobs: tuple) -> torch.Tensor:
    """The integer DPRT stage through the radon operator surface."""
    from ..radon import operator_for  # lazy: radon imports core
    return operator_for(tuple(f.shape), f.dtype, knobs)(f)


def _slice_scatter(rhat: torch.Tensor, n: int) -> torch.Tensor:
    """Assemble the (…, N, N) spectrum from (…, N+1, N) projection FFTs."""
    dev = rhat.device
    k = torch.arange(n, device=dev)
    m = torch.arange(n, device=dev)[:, None]
    u = torch.remainder(-m * k[None, :], n)     # Fhat(u[m,k], k) = Rhat[m,k]
    out = torch.zeros((*rhat.shape[:-2], n, n), dtype=rhat.dtype, device=dev)
    # the k=0 column is written N times with the DC value, then
    # overwritten by the m=N projection
    out[..., u, k.expand(n, n)] = rhat[..., :n, :]
    out[..., :, 0] = rhat[..., n, :]            # Fhat(u, 0) = FFT(R[N])[u]
    return out


def _proj_fft(r: torch.Tensor) -> torch.Tensor:
    dt = torch.float64 if r.dtype == torch.int64 else torch.float32
    return torch.fft.fft(r.to(dt), dim=-1)


def _dft2(f: torch.Tensor, knobs: tuple) -> torch.Tensor:
    r = _dprt_stage(f, knobs)                   # (…, N+1, N) exact ints
    return _slice_scatter(_proj_fft(r), f.shape[-1])


def dft2_via_dprt(f: torch.Tensor, method: Optional[str] = None,
                  strip_rows: Optional[int] = None,
                  m_block: Optional[int] = None) -> torch.Tensor:
    """(N, N) real/int image -> (N, N) complex 2-D DFT, via N+1 1-D FFTs.

    The DPRT stage runs through the :mod:`repro_torch.radon` operator
    surface; unset knobs resolve against the ambient
    :func:`repro_torch.radon.config` scope.
    """
    n = f.shape[0]
    if f.ndim != 2 or f.shape[1] != n or not is_prime(n):
        # the m -> <-m*v>_N bijection needs prime N; no embedding here
        raise ValueError(f"slice-theorem DFT needs a square prime-N image, "
                         f"got {tuple(f.shape)}")
    return _dft2(f, _resolve_knobs(method, strip_rows, m_block))


def dft2_via_dprt_batched(f: torch.Tensor, method: Optional[str] = None,
                          strip_rows: Optional[int] = None,
                          m_block: Optional[int] = None,
                          batch_impl: Optional[str] = None) -> torch.Tensor:
    """(B, N, N) stack -> (B, N, N) complex 2-D DFTs: one batched DPRT
    (one K1 launch on the ``cuda`` backend), batched FFTs and one
    scatter."""
    if f.ndim != 3:
        raise ValueError(f"dft2_via_dprt_batched needs (B, N, N), "
                         f"got {tuple(f.shape)}")
    n = f.shape[-1]
    if f.shape[-2] != n or not is_prime(n):
        raise ValueError(f"slice-theorem DFT needs prime N, got "
                         f"{tuple(f.shape)}")
    return _dft2(f, _resolve_knobs(method, strip_rows, m_block, batch_impl))


def dft2_reference(f: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(f.to(torch.float64 if f.dtype == torch.int64
                               else torch.float32))
