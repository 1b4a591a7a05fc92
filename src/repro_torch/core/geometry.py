"""Geometry normalization for arbitrary-shape DPRT inputs.

The port of :mod:`repro.core.geometry`: embed/crop, and the tiling
helpers of the overlap-add convolution.  The
transforms are defined on square prime-N images; an ``(H, W)`` or
``(B, H, W)`` input is zero-padded into the smallest prime
``P >= max(H, W)`` and the inverse crops back.  Zero rows/columns add
nothing to any projection sum and the exact inverse reproduces them as
zeros, so ``crop(idprt(dprt(embed(f)))) == f`` bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from .dprt import next_prime

__all__ = ["Geometry", "normalize_geometry", "embed", "crop", "pad2d",
           "image_to_tiles", "overlap_add", "fold_mod"]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Pad/crop metadata tying a logical image shape to its prime domain.

    ``prime`` is the transform size P; ``height``/``width`` the logical
    image; ``batch`` is ``None`` for single images.  ``native`` means the
    input already lives in the prime domain and embed/crop are
    identities.
    """

    height: int
    width: int
    prime: int
    batch: Optional[int] = None

    @property
    def batched(self) -> bool:
        return self.batch is not None

    @property
    def native(self) -> bool:
        return self.height == self.width == self.prime

    @property
    def pad_rows(self) -> int:
        return self.prime - self.height

    @property
    def pad_cols(self) -> int:
        return self.prime - self.width

    @property
    def image_shape(self) -> tuple:
        hw = (self.height, self.width)
        return (self.batch, *hw) if self.batched else hw

    @property
    def transform_shape(self) -> tuple:
        pr = (self.prime + 1, self.prime)
        return (self.batch, *pr) if self.batched else pr


def normalize_geometry(shape: Sequence[int]) -> Geometry:
    """(H, W) or (B, H, W) -> :class:`Geometry` with P = next_prime(max)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        batch, (h, w) = None, shape
    elif len(shape) == 3:
        batch, (h, w) = shape[0], shape[1:]
    else:
        raise ValueError(
            f"DPRT input must be (H, W) or (B, H, W), got {shape}")
    if h < 1 or w < 1 or (batch is not None and batch < 1):
        raise ValueError(f"DPRT input dims must be positive, got {shape}")
    return Geometry(height=h, width=w, prime=next_prime(max(h, w, 2)),
                    batch=batch)


def pad2d(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the trailing two axes by (rows, cols) at the high end."""
    if rows == 0 and cols == 0:
        return x
    return F.pad(x, (0, cols, 0, rows))


def embed(f: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Zero-embed the image(s) into the (…, P, P) prime domain."""
    if tuple(f.shape[-2:]) != (geom.height, geom.width):
        raise ValueError(
            f"image trailing shape {tuple(f.shape[-2:])} does not match "
            f"plan geometry ({geom.height}, {geom.width})")
    return pad2d(f, geom.pad_rows, geom.pad_cols)


def crop(x: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Crop a (…, P, P) prime-domain image back to (…, H, W)."""
    return x[..., : geom.height, : geom.width]


# ---------------------------------------------------------------------------
# tiling (paper Sec. III-C / companion-paper overlap-add blocks)
# ---------------------------------------------------------------------------
def image_to_tiles(f: torch.Tensor, block: int
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """Split (…, H, W) into (…, T, block, block) tiles + (T, 2) offsets.

    The image is zero-padded up to a multiple of ``block`` per axis; the
    offsets are each tile's top-left corner in the original image,
    row-major.  Zero padding contributes nothing to any downstream
    convolution, so overlap-add of per-tile results stays exact.
    """
    h, w = f.shape[-2:]
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    th, tw = math.ceil(h / block), math.ceil(w / block)
    fp = pad2d(f, th * block - h, tw * block - w)
    lead = fp.shape[:-2]
    tiles = fp.reshape(*lead, th, block, tw, block)
    tiles = tiles.transpose(-3, -2).reshape(*lead, th * tw, block, block)
    offsets = np.array([(i * block, j * block)
                        for i in range(th) for j in range(tw)],
                       dtype=np.int32)
    return tiles, offsets


def overlap_add(tile_outs: torch.Tensor, offsets: np.ndarray,
                canvas_shape: Tuple[int, int]) -> torch.Tensor:
    """Accumulate (…, T, oh, ow) tiles onto a (…, *canvas_shape) canvas
    at (T, 2) offsets, one tile at a time (the canvas plus one tile
    live: the streaming half of the resource-fitting scheme)."""
    oh, ow = tile_outs.shape[-2:]
    canvas = torch.zeros((*tile_outs.shape[:-3], *canvas_shape),
                         dtype=tile_outs.dtype, device=tile_outs.device)
    for t, (r, c) in enumerate(np.asarray(offsets).tolist()):
        canvas[..., r:r + oh, c:c + ow] += tile_outs[..., t, :, :]
    return canvas


def fold_mod(lin: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Wrap a (…, LH, LW) linear-conv result onto the (h, w) torus.

    out[..., x, y] = sum of lin[..., u, v] over u = x (mod h),
    v = y (mod w): an exact integer sum that turns prime-embedded linear
    convolution into true (h, w)-circular convolution.
    """
    lh, lw = lin.shape[-2:]
    kh, kw = math.ceil(lh / h), math.ceil(lw / w)
    lp = pad2d(lin, kh * h - lh, kw * w - lw)
    lp = lp.reshape(*lin.shape[:-2], kh, h, kw, w)
    return lp.sum((-4, -2), dtype=lin.dtype)
