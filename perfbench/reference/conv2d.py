"""The plain reference of exact 2-D circular convolution, in plain PyTorch.

For a stack f of B images of N x N pixels and a kernel g that fits the
N x N torus:

    out[b, i, j] = sum_{u, v} g[u, v] * f[b, <i - u>_N, <j - v>_N]

computed directly, one ``torch.roll`` and add per tap of the kernel, in
int64: exact for every pixel and kernel here, and independent of the DPRT.

The control takes the DPRT route instead, as the program does: the
forward of the images and of the zero-padded kernel, per direction the
1-D circular convolution of the two projections (the DPRT of f * g), then
the inverse (``reference/dprt.py``), all summed in the configuration's
``control_accumulator``.  Integer sums that wrap are exact modulo
2**bits, so the route is exact while the inverse's numerator N * out
fits; in int16 it does not at N = 251 (251 * 9 * 255 > 32767), and the
floor divide of a wrapped numerator gives a wrong pixel.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch


@functools.cache
def _dprt_reference():
    """``reference/dprt.py``, loaded from its file beside this one."""
    path = Path(__file__).with_name("dprt.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_dprt_for_conv2d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def input_shape(config: dict) -> tuple:
    return (config["batch"], config["n"], config["n"])


def kernel(config: dict) -> torch.Tensor:
    """The configuration's kernel, ``{"shape": [kh, kw], "fill": v}``."""
    spec = config["kernel"]
    return torch.full(tuple(spec["shape"]), int(spec["fill"]),
                      dtype=torch.int64)


def direct(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, N, N) images circularly convolved with the (kh, kw) kernel
    ``g``, in int64."""
    f = f.to(torch.int64)
    out = torch.zeros_like(f)
    for u, row in enumerate(g.tolist()):
        for v, w in enumerate(row):
            if w:
                out.add_(torch.roll(f, (u, v), (-2, -1)), alpha=int(w))
    return out


def dprt_route(f: torch.Tensor, g: torch.Tensor,
               acc: torch.dtype) -> torch.Tensor:
    """The same convolution by the DPRT's convolution property, every sum
    in ``acc``: R_out(m, d) = sum_t R_g(m, t) * R_f(m, <d - t>_N)."""
    dprt = _dprt_reference()
    n = f.shape[-1]
    padded = torch.zeros((1, n, n), dtype=acc, device=f.device)
    padded[0, :g.shape[0], :g.shape[1]] = g.to(acc)
    rf = dprt.forward(f, acc)
    rg = dprt.forward(padded, acc)[0]
    rc = torch.zeros_like(rf)
    for t in range(n):
        rc += rg[:, t, None] * torch.roll(rf, t, -1)
    return dprt.inverse(rc, acc)


def stages(config: dict, control: bool = False) -> dict:
    """``{"conv": callable}``: the direct convolution in int64, or, for
    the control, the DPRT route summed in ``control_accumulator``."""
    g = kernel(config)
    if control:
        acc = getattr(torch, config["control_accumulator"])
        return {"conv": lambda x: dprt_route(x, g, acc)}
    return {"conv": lambda x: direct(x, g)}
