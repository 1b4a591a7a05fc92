"""Exact fixed-point 2-D convolution via the DPRT convolution property.

The port of :mod:`repro.core.conv`.  The DPRT of a 2-D *circular*
convolution is the per-direction 1-D circular convolution of the DPRTs:

    R_{f ** g}(m, .) = R_f(m, .) (*)_N R_g(m, .)     for all N+1 directions m

so 2-D convolution = DPRT -> (N+1) independent 1-D circular convolutions
-> inverse DPRT, entirely in integer arithmetic (no floating-point FFT).

All DPRT work routes through the port's operators (:mod:`repro_torch.
radon`), so ``method`` may be any registered backend name (or
``"auto"``, or the alias ``"pallas"``).  On the ``cuda`` backend the
whole transform -> 1-D convolution -> inverse chain is one call of the
fused pipeline kernel K2 (:mod:`repro_torch.kernels.pipeline`);
``fuse=False`` forces the staged route (K1 forward, the exact 1-D
convolution below, K1 inverse), which gives the same integers.

* **Linear convolution** zero-pads both operands to the next prime
  P >= out_h/out_w, each axis on its own.
* **Blocked linear convolution** (``block_size=``): overlap-add on
  prime tiles -- every tile convolves against the small kernel at the
  tile prime q = next_prime(block + k - 1), one batched pipeline call
  over the whole tile stack, and the tiles overlap-add onto the canvas.
* **Circular convolution** of square prime operands takes the direct
  transform-domain route; any other (equal) geometry folds the exact
  prime-embedded linear convolution onto its (H, W) torus.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import geometry as G
from .dprt import accum_dtype_for, is_prime, next_prime

__all__ = [
    "circ_conv1d_exact",
    "circ_conv2d_dprt",
    "circ_conv2d_direct",
    "circ_conv2d_fft",
    "linear_conv2d_dprt",
    "linear_conv2d_direct",
    "prime_vs_pow2_padding",
]

#: elements of the gathered (rows, N, N) operand one chunk of the exact
#: 1-D convolution holds at a time
_CONV_CHUNK = 1 << 24


def circ_conv1d_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched exact 1-D circular convolution along the last axis.

    a, b: (..., N) with broadcastable leading dims;
    ``out[..., d] = sum_t a[..., t] * b[..., <d - t>_N]`` in the
    accumulator dtype.  A chunked broadcast multiply-and-sum (O(N^2)
    multiply-adds per row, integer-exact, wrapping as the reference's
    int32 does): no matmul, which CUDA does not offer for integers, and
    never a float product standing in for an integer one.
    """
    n = a.shape[-1]
    acc = accum_dtype_for(torch.promote_types(a.dtype, b.dtype))
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a2 = a.to(acc).expand(*lead, n).reshape(-1, n)
    b2 = b.to(acc).expand(*lead, n).reshape(-1, n)
    d = torch.arange(n, device=a.device)
    idx = torch.remainder(d[:, None] - d[None, :], n)   # idx[d, t] = <d-t>
    out = torch.empty_like(a2)
    step = max(1, _CONV_CHUNK // (n * n))
    for r in range(0, a2.shape[0], step):
        bc = b2[r:r + step][:, idx]                       # (rows, d, t)
        out[r:r + step] = (a2[r:r + step, None, :] * bc).sum(-1, dtype=acc)
    return out.reshape(*lead, n)


def _resolve_knobs(method, strip_rows, m_block) -> tuple:
    """Full ambient-knob snapshot (see ``ambient.snapshot_knobs``); the
    fallback method is ``"auto"``: the registry's best backend (the
    pipeline-capable ``cuda`` backend for int/float images)."""
    from ..radon import ambient  # lazy: radon imports core
    return ambient.snapshot_knobs(method, strip_rows, m_block,
                                  fallback_method="auto")


def _operator(shape, dtype, knobs: tuple):
    """The cached radon operator for one operand geometry."""
    from ..radon import operator_for  # lazy: radon imports core
    return operator_for(tuple(shape), dtype, knobs)


def _use_pipeline(plan, fuse: Optional[bool]) -> bool:
    """The staged-fallback rule: fuse when the backend declares the
    pipeline capability and no ``block_rows`` streaming is asked for;
    ``fuse=False`` forces the staged path, ``fuse=True`` asks for the
    pipeline dispatch (which itself stages on non-capable backends)."""
    if fuse is not None:
        return bool(fuse)
    return plan.backend.pipeline is not None and plan.block_rows is None


def _circ_prime(f: torch.Tensor, g: torch.Tensor, knobs: tuple,
                fuse: Optional[bool]) -> torch.Tensor:
    """Transform-domain circular convolution of square prime operands.

    Fused route: one pipeline call.  A stack against one shared kernel
    takes the kernel's projections from one forward of the kernel alone
    and rides the batched pipeline with them.  Staged route: forward
    both operands, 1-D convolve, inverse.
    """
    from ..radon import pipeline_apply  # lazy: radon imports core

    def fwd(x):
        return _operator(x.shape, x.dtype, knobs)(x)

    plan = _operator(f.shape, f.dtype, knobs).plan
    if _use_pipeline(plan, fuse):
        if g.ndim > f.ndim:      # convolution commutes: pipeline the stack
            return _circ_prime(g, f, knobs, fuse)
        if f.ndim == 3 and g.ndim == 2:
            return pipeline_apply(plan, f, "conv", fwd(g))
        return pipeline_apply(plan, f, "conv", g)     # in-kernel operand
    rc = circ_conv1d_exact(fwd(f), fwd(g))            # all N+1 directions
    n = rc.shape[-1]
    shape = (n, n) if rc.ndim == 2 else (rc.shape[0], n, n)
    return _operator(shape, rc.dtype, knobs).inverse(rc)


def circ_conv2d_dprt(f: torch.Tensor, g: torch.Tensor,
                     method: Optional[str] = None,
                     strip_rows: Optional[int] = None,
                     m_block: Optional[int] = None,
                     block_size: Optional[int] = None,
                     fuse: Optional[bool] = None) -> torch.Tensor:
    """Exact 2-D circular convolution of equal-geometry integer images.

    Square prime (N, N) operands take the transform-domain route; on
    pipeline-capable backends (``method="auto"`` resolves the ``cuda``
    backend for int/float images) it is one K2 call.  Either operand may
    be a (B, N, N) stack.  Any other (H, W) geometry folds the exact
    prime-embedded linear convolution onto its torus (``block_size``
    streams that path tile by tile).  ``fuse=False`` forces the staged
    path.  Unset knobs resolve against the ambient
    :func:`repro_torch.radon.config` scope; autograd is exact through
    both routes.
    """
    fh, fw = f.shape[-2:]
    if (fh, fw) != tuple(g.shape[-2:]):
        raise ValueError(
            f"circular convolution needs equal operand geometry, got "
            f"{tuple(f.shape)} vs {tuple(g.shape)}")
    knobs = _resolve_knobs(method, strip_rows, m_block)
    if fh == fw and is_prime(fh) and block_size is None:
        return _circ_prime(f, g, knobs, fuse)
    lin = _linear_conv2d(f, g, knobs, block_size, fuse)
    return G.fold_mod(lin, fh, fw)


def circ_conv2d_direct(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """O(N^4) direct oracle for circular convolution (exact):
    ``out[x, y] = sum_{u,v} f[u, v] g[<x-u>, <y-v>]``, one output row
    at a time on the operands' device."""
    n = f.shape[0]
    acc = accum_dtype_for(torch.promote_types(f.dtype, g.dtype))
    i = torch.arange(n, device=f.device)
    sub = torch.remainder(i[:, None] - i[None, :], n)     # sub[a, b] = a-b
    fa, ga = f.to(acc), g.to(acc)
    rows = []
    for x in range(n):
        gx = ga[sub[x]]                                    # (u, N): g[x-u]
        gxy = gx[:, sub]                                   # (u, y, v)
        rows.append((fa[:, None, :] * gxy).sum((0, 2), dtype=acc))
    return torch.stack(rows)


def circ_conv2d_fft(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Floating-point FFT path (the approach the paper's hardware
    avoids)."""
    out = torch.fft.ifft2(torch.fft.fft2(f) * torch.fft.fft2(g)).real
    if not f.dtype.is_floating_point:
        return torch.round(out)
    return out


def _linear_conv_blocked(f: torch.Tensor, g: torch.Tensor, block: int,
                         knobs: tuple, fuse: Optional[bool]) -> torch.Tensor:
    """Overlap-add linear convolution on prime-sized tiles.

    ``f``: (…, A_h, A_w) image(s); ``g``: one small (C_h, C_w) kernel.
    Each tile's circular convolution at q = next_prime(block + k - 1) is
    its full linear convolution (q >= tile + k - 1), and the tiles'
    results overlap-add exactly to the full linear convolution.  On
    pipeline-capable backends the tile stack is one batched pipeline
    call against the kernel's projections (one small forward).
    """
    if g.ndim != 2:
        raise ValueError(f"blocked convolution needs a single 2-D kernel, "
                         f"got {tuple(g.shape)}")
    ah, aw = f.shape[-2:]
    ch, cw = g.shape[-2:]
    block = int(block)
    q = next_prime(block + max(ch, cw) - 1)

    tiles, offsets = G.image_to_tiles(f, block)       # (…, T, block, block)
    tq = G.pad2d(tiles, q - block, q - block)
    gq = G.pad2d(g, q - ch, q - cw)
    rg = _operator(gq.shape, gq.dtype, knobs)(gq)

    t = tq.shape[-3]
    stack = tq.reshape(-1, q, q)                      # (B*T or T, q, q)
    stack_op = _operator(stack.shape, stack.dtype, knobs)
    if _use_pipeline(stack_op.plan, fuse):
        from ..radon import pipeline_apply            # lazy: radon -> core
        outs = pipeline_apply(stack_op.plan, stack, "conv", rg)
    else:
        rc = circ_conv1d_exact(stack_op(stack), rg)   # broadcast over stack
        outs = _operator((rc.shape[0], q, q), rc.dtype, knobs).inverse(rc)

    oh, ow = block + ch - 1, block + cw - 1           # useful tile output
    tile_out = outs[..., :oh, :ow]
    if f.ndim == 3:
        tile_out = tile_out.reshape(f.shape[0], t, oh, ow)
    th, tw = -(-ah // block), -(-aw // block)
    canvas = (th * block + ch - 1, tw * block + cw - 1)
    lin = G.overlap_add(tile_out, offsets, canvas)
    return lin[..., : ah + ch - 1, : aw + cw - 1]


def _linear_conv2d(f: torch.Tensor, g: torch.Tensor, knobs: tuple,
                   block_size: Optional[int],
                   fuse: Optional[bool]) -> torch.Tensor:
    ah, aw = f.shape[-2:]
    ch, cw = g.shape[-2:]
    out_h, out_w = ah + ch - 1, aw + cw - 1
    if block_size is not None:
        return _linear_conv_blocked(f, g, block_size, knobs, fuse)
    p = next_prime(max(out_h, out_w))
    fp = G.pad2d(f, p - ah, p - aw)
    gp = G.pad2d(g, p - ch, p - cw)
    return _circ_prime(fp, gp, knobs, fuse)[..., :out_h, :out_w]


def linear_conv2d_dprt(f: torch.Tensor, g: torch.Tensor,
                       method: Optional[str] = None,
                       strip_rows: Optional[int] = None,
                       m_block: Optional[int] = None,
                       block_size: Optional[int] = None,
                       fuse: Optional[bool] = None) -> torch.Tensor:
    """Exact full linear convolution of arbitrary rectangular operands.

    Whole-image route: zero-pad both operands to the next prime covering
    the (out_h, out_w) support, rows and columns each on their own.
    With ``block_size``, the overlap-add route convolves
    ``block_size``-square tiles of ``f`` against the (small) kernel
    ``g`` at the tile prime.  ``f`` may be a (B, H, W) stack in either
    route; on pipeline-capable backends each route's transform -> 1-D
    conv -> inverse chain is one K2 call (``fuse=False`` stages it).
    """
    knobs = _resolve_knobs(method, strip_rows, m_block)
    return _linear_conv2d(f, g, knobs, block_size, fuse)


def linear_conv2d_direct(f, g) -> np.ndarray:
    """numpy oracle for full linear convolution (exact, int64)."""
    fa = np.asarray(f, dtype=np.int64)
    ga = np.asarray(g, dtype=np.int64)
    ah, aw = fa.shape
    ch, cw = ga.shape
    out = np.zeros((ah + ch - 1, aw + cw - 1), dtype=np.int64)
    for u in range(ah):
        for v in range(aw):
            out[u:u + ch, v:v + cw] += fa[u, v] * ga
    return out


def prime_vs_pow2_padding(size: int, kernel: int) -> dict:
    """Paper Sec. I: transform-size overhead of prime vs power-of-two
    padding."""
    need = size + kernel - 1
    p = next_prime(need)
    pow2 = 1 << max(0, (need - 1).bit_length())
    return {
        "required": need,
        "prime_pad": p,
        "pow2_pad": pow2,
        "prime_overhead": p / need,
        "pow2_overhead": pow2 / need,
    }
