"""Deterministic synthetic prime-sized integer images for the DPRT paths.

A numpy copy of the image half of ``repro.data.synthetic`` (the port
keeps its own copy so it never imports the JAX package): random or
phantom (disk/line) integer rasters, seeded and reproducible, so the
same arrays feed both packages in the parity tests.
"""
from __future__ import annotations

import numpy as np

__all__ = ["radon_images", "phantom_image"]


def phantom_image(n: int, seed: int = 0, bits: int = 8) -> np.ndarray:
    """Disk + line phantom on an n x n integer raster (classic Radon test)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.zeros((n, n), np.int32)
    for _ in range(3):
        cx, cy = rng.integers(n // 4, 3 * n // 4, size=2)
        r = rng.integers(n // 10, n // 4)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += int(
            rng.integers(1, 2 ** bits // 4))
    k = rng.uniform(-2, 2)
    b = rng.integers(0, n)
    img[np.abs(yy - (k * xx + b)) < 1.5] += 2 ** bits // 4
    return np.clip(img, 0, 2 ** bits - 1).astype(np.int32)


def radon_images(n: int, batch: int, seed: int = 0, bits: int = 8,
                 kind: str = "random") -> np.ndarray:
    if kind == "phantom":
        return np.stack([phantom_image(n, seed + i, bits)
                         for i in range(batch)])
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** bits, size=(batch, n, n)).astype(np.int32)
