"""The system under test for the ``dprt`` operation: the port's public
operator, ``repro_torch.radon.DPRT``, and nothing else of the program.

``build`` makes the operator for the configuration's shape, dtype and
knobs and warms exactly its two datapaths (``op.compile`` and
``op.inverse.compile``: the plan, the nvcc libraries under the port's
fixed ``build/repro_torch/`` inside the checkout, one warm call each).
The window then calls ``op(x)`` and ``op.inverse(r)``.
"""
from __future__ import annotations

import torch


def build(config: dict, device: torch.device) -> dict:
    from repro_torch import radon
    op = radon.DPRT((config["batch"], config["n"], config["n"]),
                    getattr(torch, config["dtype"]), **config["knobs"])
    inv = op.inverse
    op.compile(device)
    inv.compile(device)
    return {"forward": op, "inverse": inv}


def window_guard():
    """A build of a plan or a kernel library inside the window raises."""
    from repro_torch import radon
    return radon.retrace_guard(max_traces=0)
