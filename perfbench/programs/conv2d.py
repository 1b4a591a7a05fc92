"""The system under test for the ``conv2d`` operation: the port's public
operator, ``repro_torch.radon.Conv2D``, and nothing else of the program.

``build`` makes the operator for the configuration's stack with a kernel
made from the configuration, in the images' dtype and on the device, as a
deployment holds its filter, and warms exactly its request: one call on
a stack of the request's shape and dtype, which makes the stack's and the
kernel image's plans, the nvcc libraries of K1 and K2 (under the port's
fixed ``build/repro_torch/`` inside the checkout) and the pipeline's
applier.  The window then calls ``op(x)``, which computes the kernel's
projections (one K1 forward of one image) and runs K2 against them.
"""
from __future__ import annotations

import torch


def build(config: dict, device: torch.device) -> dict:
    from repro_torch import radon
    dtype = getattr(torch, config["dtype"])
    spec = config["kernel"]
    kernel = torch.full(tuple(spec["shape"]), int(spec["fill"]),
                        dtype=dtype, device=device)
    shape = (config["batch"], config["n"], config["n"])
    op = radon.Conv2D(shape, kernel, **config["knobs"])
    op(torch.zeros(shape, dtype=dtype, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"conv": op}


def window_guard():
    """A build of a plan or a kernel library inside the window raises."""
    from repro_torch import radon
    return radon.retrace_guard(max_traces=0)
