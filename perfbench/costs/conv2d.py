"""Operations and bytes of one call of exact 2-D circular convolution by
the DPRT method, from shapes alone.

For a batch of B images of N x N pixels (N prime), the method that
``radon.Conv2D`` computes (forward, one 1-D circular convolution per
direction, inverse):

* the forward: B * N^2 * (N + 1) additions (as ``costs/dprt.py``);
* the N + 1 directions' length-N circular convolutions against the
  kernel's projections: B * (N + 1) * N^2 multiply-adds, two operations
  each (an ``IMAD`` result counts like an ``IADD3``'s two additions, at
  ``peaks.py``'s rate of additions);
* the inverse: B * N^2 * (N + 2) additions (as ``costs/dprt.py``);
* an int64 operation counts as two int32 operations;
* bytes: the input stack read once at its own dtype and the result
  written once in the accumulator dtype.

The count is of the method, not of the cheapest algorithm for the
kernel: a direct 3 x 3 convolution takes 9 multiply-adds a pixel, and a
time measured against that count would read above 100%.  The kernel's
own forward (one image, per call) is not counted: it is overhead of the
call that a later change may remove.

At N = 251, B = 256 and int32 sums: 16,273,410,304 operations and
80,641,280 bytes, 0.4865 ms at the peaks of :mod:`perfbench.peaks`,
bound by the operations (the bytes take 0.024 ms).
"""
from __future__ import annotations

_ITEMSIZE = {"uint8": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8}
_OPS_PER_ADD = {"int32": 1, "int64": 2}


def stage_counts(batch: int, n: int, dtype: str, accumulator: str) -> dict:
    """``{"conv": (operations, bytes)}`` for one call."""
    forward = batch * n * n * (n + 1)
    conv = 2 * batch * (n + 1) * n * n
    inverse = batch * n * n * (n + 2)
    image = batch * n * n
    return {"conv": (_OPS_PER_ADD[accumulator] * (forward + conv + inverse),
                     image * (_ITEMSIZE[dtype] + _ITEMSIZE[accumulator]))}


def counts(config: dict) -> dict:
    """:func:`stage_counts` at a configuration's shape and dtypes."""
    return stage_counts(config["batch"], config["n"], config["dtype"],
                        config["accumulator"])
