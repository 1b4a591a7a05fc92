"""The table of peaks that rooflines and ``mfu`` are read against.

NVIDIA H100 SXM at its 1.98 GHz boost clock and 700 W power limit:

* ``hbm_bytes_per_s``: 3.35e12 B/s of HBM3 bandwidth (data sheet).
* ``int32_adds_per_s``: 33.45e12 int32 additions per second.  The peak
  counts additions, not instructions.  The CUDA C++ Programming Guide's
  table of arithmetic throughput gives 64 results of 32-bit integer add
  per clock per SM at compute capability 9.0, and one such result, the
  three-input ``IADD3`` that nvcc emits for summation chains, is two
  additions: 132 SMs x 64 lanes x 2 additions x 1.98e9 clocks per second
  = 33.45e12.  (The port's ``launch/roofline.py`` counts one addition per
  instruction, 16.75e12/s, so its bounds are twice these.)  An ``IMAD``
  on the FMA pipe can add beside the ALU pipe; this table does not count
  it, so a kernel that mixes the two could read above its roofline.
* An int64 addition counts as two int32 additions (``costs/``): its low
  and high words take two ``IADD3`` with a carry between them.

A card whose SM clock or power limit is below these reads lower against
them, so every run prints the card's ``clocks.sm`` and ``power.limit``.
"""
from __future__ import annotations

H100_SXM = {
    "name": "NVIDIA H100 SXM (HBM: data sheet; int32 adds: 64 IADD3 a "
            "clock per SM, 2 adds each, at 1.98 GHz)",
    "hbm_bytes_per_s": 3.35e12,
    "int32_adds_per_s": 33.45e12,
}


def least_seconds(ops: float, nbytes: float, peaks: dict = H100_SXM):
    """The least time the chip could take for ``ops`` int32 additions
    and ``nbytes`` bytes moved: the larger of the two terms, with the
    name of the term that bounds it."""
    ops_s = ops / peaks["int32_adds_per_s"]
    bytes_s = nbytes / peaks["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
