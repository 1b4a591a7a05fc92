"""Plain torch oracles for the DPRT kernels (single (N, N) images)."""
from __future__ import annotations

import torch


def skew_sum_ref(g: torch.Tensor, sign: int = 1) -> torch.Tensor:
    """out[m, d] = sum_i g(i, <d + sign*m*i>_N), exact int32."""
    n = g.shape[0]
    gi = g.to(torch.int32)
    i = torch.arange(n, device=g.device)[:, None]
    d = torch.arange(n, device=g.device)[None, :]
    out = [torch.gather(gi, 1, torch.remainder(d + sign * m * i, n))
           .sum(0, dtype=torch.int32) for m in range(n)]
    return torch.stack(out)


def dprt_ref(f: torch.Tensor) -> torch.Tensor:
    """(N, N) -> (N+1, N) forward DPRT oracle."""
    core = skew_sum_ref(f, 1)
    return torch.cat([core, f.to(torch.int32).sum(1, dtype=torch.int32)[None]],
                     0)


def idprt_ref(r: torch.Tensor) -> torch.Tensor:
    """(N+1, N) -> (N, N) inverse DPRT oracle (exact floor divide)."""
    n = r.shape[1]
    z = skew_sum_ref(r[:n], -1)
    s = r[0].to(torch.int32).sum(dtype=torch.int32)
    return torch.div(z - s + r[n].to(torch.int32)[:, None], n,
                     rounding_mode="floor")
