"""Gradient compression: int8 stochastic-rounding quantization and a
compressed data-parallel mean over a ``torch.distributed`` group.

The port of :mod:`repro.optim.compress`.  Quantizing to int8 with a
per-tensor scale quarters the float32 bytes of a gradient all-reduce at
~0.4% relative error, unbiased by stochastic rounding.  The noise comes
from a ``torch.Generator`` where the reference takes a ``jax.random``
key, so the draws differ from the reference's; what carries over is the
error bound (one step of the scale), unbiasedness and the structure.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "compressed_psum_mean"]


def _scale(xf: torch.Tensor) -> torch.Tensor:
    return torch.clamp(xf.abs().max(), min=1e-12) / 127.0


def _round_noisy(y: torch.Tensor, generator: torch.Generator):
    noise = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                       device=y.device) - 0.5
    return torch.clamp(torch.round(y + noise), -127, 127)


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased int8 quantization with stochastic rounding: ``(q,
    scale)``, ``scale`` = max|x| / 127 (floored at 1e-12 / 127).  The
    generator lives on ``x``'s device."""
    xf = x.float()
    scale = _scale(xf)
    return _round_noisy(xf / scale, generator).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads, generator: torch.Generator):
    """Quantize and dequantize every gradient leaf (the wire format's
    error).  Each leaf draws its noise from a generator of its own,
    seeded by one draw of ``generator`` (a CPU generator), as the
    reference splits its key per leaf."""
    leaves = tree_leaves(grads)
    seeds = torch.randint(0, 2 ** 62, (len(leaves),), generator=generator)
    out = []
    for g, seed in zip(leaves, seeds.tolist()):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(seed)
        q, s = quantize_int8(g, gen)
        out.append(dequantize_int8(q, s, g.dtype))
    return tree_unflatten(grads, out)


def compressed_psum_mean(x: torch.Tensor, group,
                         generator: torch.Generator) -> torch.Tensor:
    """The mean of every rank's ``x`` over ``group``, sent as int8 values.

    Summing int8 payloads exactly needs one scale: each rank's max|x| /
    127 is MAX-reduced (one scalar all-reduce), each rank quantizes
    against it with its own noise (``generator``, on ``x``'s device),
    the int32 payloads are SUM-reduced, and the sum is rescaled by
    1 / world.  Every rank gets the mean.
    """
    n = dist.get_world_size(group)
    xf = x.float()
    s = _scale(xf).reshape(1)
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    q = _round_noisy(xf / s, generator).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.float() * s / n).to(x.dtype)
