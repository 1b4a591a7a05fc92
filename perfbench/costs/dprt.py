"""Operations and bytes of one call of each DPRT stage, from shapes alone.

For a batch of B images of N x N pixels (N prime):

* ``forward``: B * N^2 * (N + 1) additions.  The skew-sum
  R(m, d) = sum_i f(i, <d + m*i>_N) is N directions x N offsets x N rows,
  and the row-sum row R(N, d) = sum_j f(d, j) adds N^2 more.
* ``inverse``: B * N^2 * (N + 2) additions.  The skew-sum over the N
  directions of the projections is N^3, and the correction -S + R(N, i)
  adds two per pixel (the exact divide by N is not counted).
* An int64 addition counts as two int32 operations (an add with carry).
* Bytes: each input byte is read once, at the input's own dtype, and each
  output byte is written once, whatever a kernel reads again.  The
  forward reads the B x N x N image and writes B x (N+1) x N projections
  in the accumulator dtype; the inverse reads those and writes the
  B x N x N image in the accumulator dtype.

At N = 251, B = 256 and int32 sums these give 0.1215 ms forward and
0.1220 ms inverse at the peaks of :mod:`perfbench.peaks`; at N = 4099,
B = 4 and int64 sums, 16.4753 ms forward.  At the port's own rate of one
addition per instruction (``launch/roofline.py``, 16.75e12/s) the same
counts give PERF.md's bounds: 0.2426, 0.2436 and, at B = 1, 8.2254 ms.
"""
from __future__ import annotations

_ITEMSIZE = {"uint8": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8}
_OPS_PER_ADD = {"int32": 1, "int64": 2}


def stage_counts(batch: int, n: int, dtype: str, accumulator: str) -> dict:
    """``{stage: (operations, bytes)}`` for one call of each stage."""
    per_add = _OPS_PER_ADD[accumulator]
    size_in, size_acc = _ITEMSIZE[dtype], _ITEMSIZE[accumulator]
    image, proj = batch * n * n, batch * (n + 1) * n
    return {
        "forward": (per_add * batch * n * n * (n + 1),
                    image * size_in + proj * size_acc),
        "inverse": (per_add * batch * n * n * (n + 2),
                    proj * size_acc + image * size_acc),
    }


def counts(config: dict) -> dict:
    """:func:`stage_counts` at a configuration's shape and dtypes."""
    return stage_counts(config["batch"], config["n"], config["dtype"],
                        config["accumulator"])
