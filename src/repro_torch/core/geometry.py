"""Geometry normalization for arbitrary-shape DPRT inputs.

The port of the embed/crop half of :mod:`repro.core.geometry`.  The
transforms are defined on square prime-N images; an ``(H, W)`` or
``(B, H, W)`` input is zero-padded into the smallest prime
``P >= max(H, W)`` and the inverse crops back.  Zero rows/columns add
nothing to any projection sum and the exact inverse reproduces them as
zeros, so ``crop(idprt(dprt(embed(f)))) == f`` bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .dprt import next_prime

__all__ = ["Geometry", "normalize_geometry", "embed", "crop", "pad2d"]


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
