"""The plain reference of the exact DPRT, in plain PyTorch.

Definitions (N prime, paper eq. (1)-(2)):

    R(m, d) = sum_i f(i, <d + m*i>_N)        0 <= m < N
    R(N, d) = sum_j f(d, j)
    f(i, j) = (sum_m R(m, <j - m*i>_N) - S + R(N, i)) / N,   S = sum_d R(0, d)

Each stage loops over one index of the definition (a direction, or an
image row) and gathers the whole batch at once, so it runs in blocks of
one direction or row on any device and needs no more memory than one
gathered B x N x N block.  The sums are taken in ``acc``: int64 by
default, which is exact for every pixel dtype here.

The control sums in a narrower type that a configuration names
(``control_accumulator``).  Integer sums that wrap are exact modulo
2**bits, so a narrower integer still gives every output exactly while
the outputs fit in it (a projection is at most 255 * N, the inverse's
numerator N * f); the control is the nearest type below the stated one
that breaks that: int16 at N = 251, float32 (24-bit mantissa) at
N = 4099.  A float sum's result is floored back to an integer.
"""
from __future__ import annotations

import torch

def input_shape(config: dict) -> tuple:
    return (config["batch"], config["n"], config["n"])


def forward(f: torch.Tensor, acc: torch.dtype = torch.int64) -> torch.Tensor:
    """(B, N, N) images -> (B, N+1, N) projections, summed in ``acc``."""
    b, n, _ = f.shape
    out = torch.empty((b, n + 1, n), dtype=acc, device=f.device)
    i = torch.arange(n, device=f.device)
    d = torch.arange(n, device=f.device)
    for m in range(n):
        idx = (d[None, :] + m * i[:, None]) % n          # [i, d]
        out[:, m] = torch.gather(f, 2, idx.expand(b, n, n)).sum(
            1, dtype=acc)
    out[:, n] = f.sum(2, dtype=acc)
    return out


def inverse(r: torch.Tensor, acc: torch.dtype = torch.int64) -> torch.Tensor:
    """(B, N+1, N) projections -> (B, N, N) images, summed in ``acc``;
    the divide by N is a floor division, exact for true projections."""
    b, n1, n = r.shape
    r = r.to(acc)
    out = torch.empty((b, n, n), dtype=acc, device=r.device)
    s = r[:, 0].sum(1, dtype=acc)
    m = torch.arange(n, device=r.device)
    j = torch.arange(n, device=r.device)
    body = r[:, :n]
    for i in range(n):
        idx = (j[None, :] - m[:, None] * i) % n          # [m, j]
        z = torch.gather(body, 2, idx.expand(b, n, n)).sum(1, dtype=acc)
        num = z - s[:, None] + r[:, n, i][:, None]
        out[:, i] = torch.div(num, n, rounding_mode="floor")
    return out


STAGES = {"forward": forward, "inverse": inverse}


def stages(config: dict, control: bool = False) -> dict:
    """``{stage: callable}``: exact in int64, or, for the control, summed
    in the configuration's ``control_accumulator``."""
    acc = getattr(torch, config["control_accumulator"]) if control else (
        torch.int64)
    return {name: (lambda x, fn=fn: fn(x, acc)) for name, fn in STAGES.items()}
