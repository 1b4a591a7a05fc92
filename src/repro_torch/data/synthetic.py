"""Deterministic synthetic data: learnable token streams and prime images.

A numpy copy of the reference's ``repro.data.synthetic`` (the port keeps
its own copy so it never imports the JAX package).  The token stream has
real sequential structure (an affine random walk over the vocabulary plus
noise); images are random or phantom (disk/line) prime-sized integer
rasters for the DPRT paths.  Everything is seeded and reproducible, so
the same arrays feed both packages in the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenStream", "radon_images", "phantom_image"]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-shard batch
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    noise: float = 0.05

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.num_shards + self.shard)
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        # next = (prev*a + c) mod v with *stream-global* a, c: a learnable
        # deterministic next-token function, so CE genuinely decreases.
        g = np.random.default_rng(self.seed)
        a = int(g.integers(1, v)) | 1
        c = int(g.integers(0, v))
        t0 = rng.integers(0, v, size=(b, 1))
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0:1] = t0
        for i in range(1, s + 1):
            toks[:, i] = (toks[:, i - 1] * a + c) % v
        noise_mask = rng.random((b, s + 1)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s + 1))
        toks = np.where(noise_mask, noise_tok, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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
