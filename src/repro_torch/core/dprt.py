"""Discrete Periodic Radon Transform (DPRT) primitives in PyTorch.

The port of :mod:`repro.core.dprt`: primes, the accumulator rules, the
skew-sum primitive in the paper's three software strategies, and the
numpy oracles.

* ``gather`` -- per-direction shear via ``torch.gather`` (the oracle),
* ``horner`` -- the paper's shift-and-add dataflow: a Horner recurrence
  over image rows, each step circularly shifting the (direction x d)
  accumulator and adding one row (Sec. III-B),
* ``strips`` -- the scalable SFDPRT: K = ceil(N/H) strips of H rows each
  give a partial skew-sum that is aligned (one circular roll) and
  accumulated, eq. (7)-(8).

The fused, batched kernel (``method="cuda"``, the port of the
``pallas`` backend) lives in :mod:`repro_torch.kernels`.  Every
primitive here is rank-polymorphic: ``(..., rows, N)`` in,
``(..., N, N)`` out, so a ``(B, N, N)`` stack is one call.

Definitions (N prime):

    R(m,d) = sum_i f(i, <d + m*i>_N)    0 <= m < N
    R(N,d) = sum_j f(d, j)

    f(i,j) = (1/N) [ sum_m R(m, <j - m*i>_N) - S + R(N,i) ]

Integer inputs are transformed exactly; the inverse divides by N with
floor division (the reference's ``//``), so ``idprt(dprt(f)) == f``.
"""
from __future__ import annotations

import sys
import types
from typing import Optional

import numpy as np
import torch

__all__ = [
    "is_prime",
    "next_prime",
    "skew_sum",
    "strip_partial",
    "align_partial",
    "accum_dtype_for",
    "forward_sum_dtype_for",
    "float_dtype_for",
    "int32_accum_exact",
    "dtype_kind",
    "dtype_name",
    "dprt_oracle_np",
    "idprt_oracle_np",
    "dprt",
    "idprt",
    "dprt_batched",
    "idprt_batched",
]


# ---------------------------------------------------------------------------
# primes
# ---------------------------------------------------------------------------
def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n."""
    while not is_prime(n):
        n += 1
    return n


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------
_INT32_MAX = 2**31 - 1


def dtype_kind(dtype: torch.dtype) -> str:
    """numpy-style kind letter: 'f' float, 'i' signed, 'u' unsigned,
    'b' bool, 'c' complex."""
    if dtype == torch.bool:
        return "b"
    if dtype.is_complex:
        return "c"
    if dtype.is_floating_point:
        return "f"
    return "i" if dtype.is_signed else "u"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.int32`` -> ``"int32"`` (the reference's dtype names)."""
    return str(dtype).rsplit(".", 1)[-1]


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name such as ``"int32"`` or a
    numpy dtype (the serving tier's requests are numpy arrays)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        try:
            dtype = np.dtype(dtype).name
        except TypeError:
            pass
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype!r}")
    return out


def int32_accum_exact(n: int, dtype) -> bool:
    """True when an int32 accumulator provably cannot overflow the
    inverse's ``v*N*(N+1)`` worst case for full-range pixels of this
    integer dtype at transform size N (prime).

    For uint8 (v=255) int32 stays exact up to prime N <= 2897 and fails
    at the next prime 2903; for int16 (v=32767) the cliff is at N=257.
    """
    dtype = as_dtype(dtype)
    if dtype_kind(dtype) not in "iu":
        raise TypeError(f"int32_accum_exact is an integer bound: {dtype}")
    info = torch.iinfo(dtype)
    v = max(int(info.max), -int(info.min))
    return v * n * (n + 1) <= _INT32_MAX


def accum_dtype_for(dtype, n: Optional[int] = None) -> torch.dtype:
    """Accumulator dtype with enough headroom for exact sums.

    The reference's rule with its x64 branch always taken (torch always
    has int64): narrow integers (itemsize < 4) promote to int64 when the
    int32 bound of :func:`int32_accum_exact` fails at transform size
    ``n`` (uint8 at N >= 2903, int16 at N >= 257); 32-bit integers keep
    int32, 64-bit integers int64; float64 stays float64 and every other
    float accumulates in float32.
    """
    dtype = as_dtype(dtype)
    kind = dtype_kind(dtype)
    if kind in "iu":
        if dtype.itemsize >= 8:
            return torch.int64
        if (n is not None and dtype.itemsize < 4
                and not int32_accum_exact(int(n), dtype)):
            return torch.int64
        return torch.int32
    if kind == "f":
        return torch.float64 if dtype == torch.float64 else torch.float32
    raise TypeError(f"DPRT has no accumulator for dtype {dtype}")


def forward_sum_dtype_for(dtype, n: int) -> torch.dtype:
    """The dtype the forward (and the bare skew-sum) of ``dtype`` data
    may sum in at transform size N: int32 for an integer dtype narrower
    than 4 bytes whenever ``v*N <= 2**31 - 1`` (v its largest
    magnitude), else :func:`accum_dtype_for`.

    The forward's counterpart of :func:`int32_accum_exact`: an output of
    the forward or of the skew-sum of N rows is a sum of at most N
    values, so its magnitude is at most ``v*N`` whatever the data, where
    the inverse's reaches ``v*N*(N+1)``.  uint8 and int8 stay int32 at
    every N the port runs, int16 up to N = 65521, uint16 up to 32768.
    The result is still returned in :func:`accum_dtype_for`.
    """
    dtype = as_dtype(dtype)
    if dtype_kind(dtype) in "iu" and dtype.itemsize < 4:
        info = torch.iinfo(dtype)
        if max(int(info.max), -int(info.min)) * int(n) <= _INT32_MAX:
            return torch.int32
    return accum_dtype_for(dtype, n)


def float_dtype_for(dtype) -> torch.dtype:
    """Float dtype for residual/solver arithmetic over ``dtype`` data:
    float64 and 64-bit integers solve in float64, all else in float32."""
    dtype = as_dtype(dtype)
    if dtype == torch.float64:
        return torch.float64
    if dtype_kind(dtype) in "iu" and dtype.itemsize >= 8:
        return torch.float64
    return torch.float32


# ---------------------------------------------------------------------------
# the skew-sum primitive
#
#   skew_sum(g, sign)[m, d] = sum_i g(i, <d + sign*m*i>_N)
#
# Forward DPRT core is sign=+1 applied to the image; the inverse core
# (sum over m of R(m, <j - i*m>)) is sign=-1 applied to R[:N].
# ---------------------------------------------------------------------------
def _roll_index(n: int, amount: torch.Tensor, device) -> torch.Tensor:
    """idx[m, d] = <d + amount[m]>_N for an (N,) per-direction amount."""
    d = torch.arange(n, device=device, dtype=torch.int64)
    return torch.remainder(d[None, :] + amount[:, None], n)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., m, d] = t[..., m, idx[m, d]]."""
    return torch.gather(t, -1, idx.expand(t.shape))


def _skew_sum_gather(g: torch.Tensor, sign: int,
                     block_m: int = 32) -> torch.Tensor:
    """Oracle: one shear (gather) per direction, then sum over rows."""
    rows, n = g.shape[-2:]
    gacc = g.to(accum_dtype_for(g.dtype, n))
    i = torch.arange(rows, device=g.device, dtype=torch.int64)
    d = torch.arange(n, device=g.device, dtype=torch.int64)
    out = []
    for m0 in range(0, n, block_m):
        ms = torch.arange(m0, min(m0 + block_m, n), device=g.device,
                          dtype=torch.int64)
        # idx[m, i, d] = <d + sign*m*i>_N ; gathered (…, M, rows, N)
        idx = torch.remainder(d[None, None, :]
                              + sign * ms[:, None, None] * i[None, :, None],
                              n)
        src = gacc.unsqueeze(-3).expand(*gacc.shape[:-2], len(ms), rows, n)
        out.append(torch.gather(src, -1, idx.expand(src.shape)).sum(
            -2, dtype=gacc.dtype))
    return torch.cat(out, dim=-2)


def _horner_scan(strip: torch.Tensor, n: int, sign: int,
                 acc_dtype) -> torch.Tensor:
    """Horner recurrence over the rows of ``strip`` (shape (…, H, N)).

    Returns U[m, d] = sum_{i<H} strip(i, <d + sign*m*i>_N) for all N
    directions m.  Each step is the paper's single clock cycle:
    circularly shift the (direction x d) accumulator by one step of m
    and add the next row.
    """
    ms = torch.arange(n, device=strip.device, dtype=torch.int64)
    idx = _roll_index(n, sign * ms, strip.device)
    rows = strip.to(acc_dtype)
    t = torch.zeros((*strip.shape[:-2], n, n), dtype=acc_dtype,
                    device=strip.device)
    for r in range(rows.shape[-2] - 1, -1, -1):   # bottom row first
        t = _gather_rows(t, idx) + rows[..., r, None, :]
    return t


def _skew_sum_horner(g: torch.Tensor, sign: int) -> torch.Tensor:
    n = g.shape[-1]
    return _horner_scan(g, n, sign, accum_dtype_for(g.dtype, n))


def strip_partial(strip: torch.Tensor, n: int, sign: int = 1,
                  acc_dtype=None) -> torch.Tensor:
    """Partial skew-sum of one strip (paper eq. (7), before alignment)."""
    if acc_dtype is None:
        acc_dtype = accum_dtype_for(strip.dtype, n)
    return _horner_scan(strip, n, sign, acc_dtype)


def align_partial(u: torch.Tensor, row_offset: int,
                  sign: int = 1) -> torch.Tensor:
    """Align a strip's partial result: R'(r,m,d) = U_r(<d + sign*m*rH>_N).

    ``row_offset`` is the strip's first global row (r*H)."""
    n = u.shape[-1]
    ms = torch.arange(n, device=u.device, dtype=torch.int64)
    idx = _roll_index(n, sign * ms * (int(row_offset) % n), u.device)
    return _gather_rows(u, idx)


def _skew_sum_strips(g: torch.Tensor, sign: int,
                     strip_rows: int) -> torch.Tensor:
    """The scalable strip decomposition (paper eq. (5)-(8))."""
    n = g.shape[-1]
    h = int(strip_rows)
    if not (1 <= h <= n):
        raise ValueError(f"strip_rows must be in [1, {n}], got {h}")
    acc_dtype = accum_dtype_for(g.dtype, n)
    acc = None
    for r0 in range(0, g.shape[-2], h):
        u = _horner_scan(g[..., r0:r0 + h, :], n, sign, acc_dtype)
        part = align_partial(u, r0, sign)
        acc = part if acc is None else acc + part  # MEM_OUT, eq. (8)
    return acc


def skew_sum(g: torch.Tensor, sign: int, method: str = "horner",
             strip_rows: Optional[int] = None,
             m_block: Optional[int] = None, mesh=None) -> torch.Tensor:
    """skew_sum(g, sign)[m, d] = sum_i g(i, <d + sign*m*i>_N).

    Routed through the backend registry (:mod:`repro_torch.core.plan`);
    any registered method name (or ``"auto"``) is accepted.
    """
    from .plan import dispatch_skew_sum  # lazy: plan imports this module
    return dispatch_skew_sum(g, sign, method=method, strip_rows=strip_rows,
                             m_block=m_block, mesh=mesh)


# ---------------------------------------------------------------------------
# legacy per-call-kwarg entry points: thin shims over the operator API
# (the same numerics, caches and exact autograd as `radon.DPRT(...)`).
# New code should build operators instead -- these wrappers warn once per
# process when the legacy knob plumbing is used.
# ---------------------------------------------------------------------------
_LEGACY_KNOB_WARNED = False


def _warn_legacy_knobs() -> None:
    global _LEGACY_KNOB_WARNED
    if _LEGACY_KNOB_WARNED:
        return
    _LEGACY_KNOB_WARNED = True
    import sys
    import warnings
    # point the warning at the caller's code: skip however many shim
    # frames (dprt -> dprt_batched etc.) sit between here and the first
    # frame outside this module
    stacklevel, frame = 1, sys._getframe()
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
        stacklevel += 1
    warnings.warn(
        "passing method=/strip_rows=/m_block=/... per call to "
        "repro_torch.core.dprt functions is deprecated: build an operator "
        "once with repro_torch.radon.DPRT(shape, dtype, method=..., ...) "
        "or set an ambient scope with repro_torch.radon.config(...). The "
        "kwargs keep working (this warns once per process).",
        DeprecationWarning, stacklevel=stacklevel)


def _legacy_operator(shape, dtype, method, strip_rows, m_block, batch_impl,
                     block_rows, block_batch, mesh, stream_rows=None):
    """Resolve legacy per-call knobs into a cached radon operator."""
    if any(k is not None for k in (method, strip_rows, m_block, block_rows,
                                   stream_rows, block_batch, mesh)
           ) or batch_impl not in (None, "auto"):
        _warn_legacy_knobs()
    from ..radon import DPRT, ambient  # lazy: radon imports this module
    # the legacy default is method="horner" -- except under a mesh
    # (explicit or ambient), where "auto" routes to the mesh-aware pick;
    # ambient scopes override either default
    mesh = ambient.resolve("mesh", mesh)
    fallback = "horner" if mesh is None else "auto"
    return DPRT(shape, dtype,
                method=ambient.resolve("method", method, fallback),
                strip_rows=strip_rows, m_block=m_block,
                batch_impl=batch_impl, block_rows=block_rows,
                stream_rows=stream_rows, block_batch=block_batch, mesh=mesh)


def dprt(f: torch.Tensor, method: Optional[str] = None,
         strip_rows: Optional[int] = None, m_block: Optional[int] = None,
         batch_impl: Optional[str] = None, block_rows: Optional[int] = None,
         block_batch: Optional[int] = None, mesh=None,
         stream_rows: Optional[int] = None) -> torch.Tensor:
    """Forward DPRT: (H, W) image (or a (B, H, W) stack) -> (…, P+1, P)
    projections, exact for integers.  Deprecation shim over
    ``repro_torch.radon.DPRT(f.shape, f.dtype, ...)``: any geometry
    (zero-embedded into the smallest prime P >= max(H, W)); unset knobs
    resolve against the ambient scope, then ``horner``."""
    op = _legacy_operator(tuple(f.shape), f.dtype, method, strip_rows,
                          m_block, batch_impl, block_rows, block_batch,
                          mesh, stream_rows=stream_rows)
    return op(f)


def idprt(r: torch.Tensor, method: Optional[str] = None,
          strip_rows: Optional[int] = None, m_block: Optional[int] = None,
          batch_impl: Optional[str] = None, block_rows: Optional[int] = None,
          block_batch: Optional[int] = None, mesh=None,
          stream_rows: Optional[int] = None) -> torch.Tensor:
    """Inverse DPRT: (N+1, N) projections (or a (B, N+1, N) stack) ->
    (…, N, N), exact for integers.  Deprecation shim over
    ``repro_torch.radon.DPRT((N, N), ...).inverse``; projections live in
    the prime domain (crop an embedded geometry with its operator's
    ``.inverse``)."""
    if r.ndim not in (2, 3) or r.shape[-2] != r.shape[-1] + 1:
        raise ValueError(f"iDPRT input must be (N+1, N) or (B, N+1, N), "
                         f"got {tuple(r.shape)}")
    n = r.shape[-1]
    if not is_prime(n):
        raise ValueError(f"iDPRT needs prime N, got N={n}")
    shape = (n, n) if r.ndim == 2 else (r.shape[0], n, n)
    op = _legacy_operator(shape, r.dtype, method, strip_rows, m_block,
                          batch_impl, block_rows, block_batch, mesh,
                          stream_rows=stream_rows)
    return op.inverse(r)


def dprt_batched(f: torch.Tensor, method: Optional[str] = None,
                 strip_rows: Optional[int] = None,
                 batch_impl: Optional[str] = None,
                 m_block: Optional[int] = None,
                 block_batch: Optional[int] = None,
                 mesh=None) -> torch.Tensor:
    """Batched :func:`dprt` over a leading axis (requires (B, H, W))."""
    if f.ndim != 3:
        raise ValueError(f"dprt_batched needs (B, H, W), got "
                         f"{tuple(f.shape)}")
    return dprt(f, method=method, strip_rows=strip_rows, m_block=m_block,
                batch_impl=batch_impl, block_batch=block_batch, mesh=mesh)


def idprt_batched(r: torch.Tensor, method: Optional[str] = None,
                  strip_rows: Optional[int] = None,
                  batch_impl: Optional[str] = None,
                  m_block: Optional[int] = None,
                  block_batch: Optional[int] = None,
                  mesh=None) -> torch.Tensor:
    """Batched :func:`idprt` over a leading axis (requires (B, N+1, N))."""
    if r.ndim != 3:
        raise ValueError(f"idprt_batched needs (B, N+1, N), got "
                         f"{tuple(r.shape)}")
    return idprt(r, method=method, strip_rows=strip_rows, m_block=m_block,
                 batch_impl=batch_impl, block_batch=block_batch, mesh=mesh)


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`dprt` (see ``repro_torch.core``)."""

    def __call__(self, *args, **kwargs):
        return dprt(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule


# ---------------------------------------------------------------------------
# numpy oracle (used by tests; deliberately independent of the torch paths)
# ---------------------------------------------------------------------------
def dprt_oracle_np(f: np.ndarray) -> np.ndarray:
    n = f.shape[0]
    assert f.shape == (n, n) and is_prime(n)
    out = np.zeros((n + 1, n), dtype=np.int64)
    cols = np.arange(n)
    for m in range(n):
        for i in range(n):
            out[m] += f[i, (cols + m * i) % n].astype(np.int64)
    out[n] = f.sum(axis=1)
    return out


def idprt_oracle_np(r: np.ndarray) -> np.ndarray:
    n = r.shape[1]
    assert r.shape == (n + 1, n) and is_prime(n)
    s = int(r[0].sum())
    f = np.zeros((n, n), dtype=np.int64)
    cols = np.arange(n)
    for i in range(n):
        z = np.zeros(n, dtype=np.int64)
        for m in range(n):
            z += r[m, (cols - m * i) % n].astype(np.int64)
        f[i] = (z - s + int(r[n, i]))
    assert (f % n == 0).all(), "inverse DPRT numerator must be divisible by N"
    return f // n
