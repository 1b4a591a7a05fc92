"""The paper's analytical cost/resource models and Pareto front, and
K1's strip model on one NVIDIA H100.

The port's own copy of :mod:`repro.core.pareto` (pure integer
arithmetic; it imports no JAX), as executable code:

* Table I   -- forward-DPRT cycle counts (serial / systolic / SFDPRT / FDPRT)
* Table II  -- inverse-DPRT cycle counts
* Table III -- resource usage (register bits, adder-tree flip-flops,
               1-bit additions, MUXes, RAM bits)
* Fig. 22   -- ``tree_resources`` (adder-tree resource recurrence)
* eq. (11)  -- the Pareto-front membership test over strip heights H
* ``TPUStripCost`` / ``tpu_strip_cost`` -- the reference's TPU cost
  model of its strip kernel: VMEM working-set bytes and VPU op counts
  per (strip H, direction block M).

These describe the paper's FPGA designs and the reference's TPU, not
the card the port runs on, and return exactly the reference's values
(N=251, B=8: FDPRT = 511 cycles; systolic = 63,253 cycles and 516,096
flip-flops).  The H100 counterpart of the TPU model is
``H100StripCost`` / ``h100_strip_cost``: K1's launch at a tile of
:func:`repro_torch.kernels.tuning.skew_geometry`, its shared memory,
blocks and waves, adds, shared loads and HBM bytes, and a predicted time
at the peaks of :data:`repro_torch.launch.roofline.HW`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

__all__ = [
    "tree_resources",
    "cycles_serial", "cycles_systolic", "cycles_sfdprt", "cycles_fdprt",
    "cycles_isfdprt", "cycles_ifdprt",
    "flipflops_sfdprt", "flipflops_systolic", "flipflops_serial",
    "flipflops_fdprt",
    "adders_sfdprt", "adders_systolic", "adders_serial", "adders_fdprt",
    "pareto_front", "pareto_points",
    "TPUStripCost", "tpu_strip_cost",
    "H100StripCost", "h100_strip_cost",
]


def _n(x: int) -> int:
    return math.ceil(math.log2(x))


# ---------------------------------------------------------------------------
# Fig. 22: adder-tree resources for X operands of B bits
# ---------------------------------------------------------------------------
def tree_resources(x: int, b: int) -> Dict[str, int]:
    """Returns {'fa': 1-bit additions, 'ff': flip-flops, 'mux': 2-to-1 muxes}."""
    h = _n(x) if x > 1 else 0
    a_ff = a_fa = a_mux = 0
    a = x
    for z in range(1, h + 1):
        r = a % 2
        a = a // 2
        a_fa += a * (b + z - 1)
        a_mux += a * b
        a = a + r
        a_ff += a * (b + z)
    return {"fa": a_fa, "ff": a_ff, "mux": a_mux}


# ---------------------------------------------------------------------------
# Table I: forward cycle counts
# ---------------------------------------------------------------------------
def cycles_serial(n: int) -> int:
    return n ** 3 + 2 * n ** 2 + n


def cycles_systolic(n: int) -> int:
    return n ** 2 + n + 1


def cycles_sfdprt(n: int, h: int) -> int:
    k = math.ceil(n / h)
    return k * (n + 3 * h + 3) + n + _n(h) + 1


def cycles_fdprt(n: int) -> int:
    return 2 * n + _n(n) + 1


# ---------------------------------------------------------------------------
# Table II: inverse cycle counts
# ---------------------------------------------------------------------------
def cycles_isfdprt(n: int, h: int, b: int) -> int:
    k = math.ceil(n / h)
    return k * (n + h) + 2 * _n(n) + _n(h) + b + 3


def cycles_ifdprt(n: int, b: int) -> int:
    return 2 * n + 3 * _n(n) + b + 2


# ---------------------------------------------------------------------------
# Table III: resources (flip-flops = register-array bits + adder-tree FFs,
# matching how Fig. 19 counts them)
# ---------------------------------------------------------------------------
def flipflops_serial(n: int, b: int) -> int:
    return n * (b + _n(n)) + (3 * b + 2 * _n(n))


def flipflops_systolic(n: int, b: int) -> int:
    return n * (n + 1) * _n(n) + (n + 1) * (3 * b + 2 * _n(n))


def flipflops_sfdprt(n: int, h: int, b: int) -> int:
    return n * h * b + n * tree_resources(h, b)["ff"]


def flipflops_fdprt(n: int, b: int) -> int:
    return n * n * b + n * tree_resources(n, b)["ff"]


def adders_serial(n: int, b: int) -> int:
    return b + _n(n)


def adders_systolic(n: int, b: int) -> int:
    return (n + 1) * (b + _n(n))


def adders_sfdprt(n: int, h: int, b: int) -> int:
    return n * tree_resources(h, b)["fa"] + n * (b + _n(n))


def adders_fdprt(n: int, b: int) -> int:
    return n * tree_resources(n, b)["fa"]


# ---------------------------------------------------------------------------
# eq. (11): Pareto front over H
# ---------------------------------------------------------------------------
def pareto_front(n: int) -> List[int]:
    """H in {2..(N-1)/2} with ceil(N/H) < ceil(N/(H-1))."""
    return [h for h in range(2, (n - 1) // 2 + 1)
            if math.ceil(n / h) < math.ceil(n / (h - 1))]


def pareto_points(n: int, b: int) -> List[Dict[str, int]]:
    """(H, cycles, flip-flops, 1-bit adders) along the front, plus H=N."""
    pts = [{"h": h,
            "cycles": cycles_sfdprt(n, h),
            "ff": flipflops_sfdprt(n, h, b),
            "fa": adders_sfdprt(n, h, b)} for h in pareto_front(n)]
    pts.append({"h": n, "cycles": cycles_fdprt(n),
                "ff": flipflops_fdprt(n, b), "fa": adders_fdprt(n, b)})
    return pts


# ---------------------------------------------------------------------------
# TPU-analog cost model for the strip kernel (used by §Perf block sweeps).
#
# A (H-row strip) x (M-direction block) tile keeps in VMEM:
#   strip rows        H  x Npad  x in_bytes
#   accumulator       M  x Npad  x 4            (int32)
#   per-step work: the binary roll-select ladder issues ceil(log2 N)
#   roll+select pairs on the (M, Npad) accumulator plus one add.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TPUStripCost:
    h: int
    m_block: int
    n: int
    n_pad: int
    vmem_bytes: int
    vpu_ops: int            # scalar-equivalent VPU lane-ops for the full DPRT
    hbm_bytes: int          # image reads + output writes (one pass)
    ai: float               # arithmetic intensity (ops/HBM byte)


def tpu_strip_cost(n: int, h: int, m_block: int, in_bytes: int = 4,
                   lanes: int = 128, sublanes: int = 8) -> TPUStripCost:
    n_pad = math.ceil(n / lanes) * lanes
    k = math.ceil(n / h)
    mb = math.ceil((n + 1) / m_block)
    ladder = max(1, _n(n))
    vmem = h * n_pad * in_bytes + m_block * n_pad * 4 * 2  # strip + acc (dbl buf)
    # per (strip, m-block): H steps x (ladder rolls + ladder selects + 1 add)
    per_tile = h * (2 * ladder + 1) * m_block * n_pad
    align = (2 * ladder) * m_block * n_pad                 # alignment roll
    vpu = k * mb * (per_tile + align)
    hbm = k * mb * h * n_pad * in_bytes + (n + 1) * n_pad * 4
    return TPUStripCost(h=h, m_block=m_block, n=n, n_pad=n_pad,
                        vmem_bytes=vmem, vpu_ops=vpu, hbm_bytes=hbm,
                        ai=vpu / max(hbm, 1))


# ---------------------------------------------------------------------------
# K1's strip model on one H100 (kernels/csrc/sfdprt.cu).
#
# A block of K1 holds D = m_block directions of one image in registers and
# streams the image's N rows through a ring of ``slots`` shared-memory
# stages of ``stage_rows`` rows; every add of a direction's sum reads its
# term from shared memory.  Per forward launch of B images:
#   adds = shared loads = B * (N+1) * N * N   (N+1 output rows of N sums
#                                              of N terms: B N^2 (N+1))
#   HBM bytes = each block's read of its image + the output's write
# and the time is the largest of the bytes at HBM rate, the adds at the
# int32 rate and the shared loads at 32 per clock per SM -- the latter two
# on the busiest SM, which runs ceil(blocks / SMs) blocks (the waves'
# tail; fewer blocks than SMs leave SMs idle).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class H100StripCost:
    n: int
    batch: int
    itemsize: int
    m_block: int            # D: directions per block
    stage_rows: int
    slots: int
    smem_bytes: int         # dynamic shared memory of one block
    blocks_per_image: int
    blocks: int             # blocks of the launch
    per_sm: int             # blocks an SM holds at once
    waves: float            # blocks / (per_sm * SMs)
    tail: float             # busiest SM's blocks over the mean
    adds: int
    shared_loads: int
    hbm_bytes: int          # image reads (each block's) + output writes
    hbm_ms: float
    add_ms: float
    load_ms: float
    ms: float               # predicted: the largest of the three
    bound_by: str           # "bytes", "adds" or "shared loads"


def h100_strip_cost(n: int, batch: int, itemsize: int, m_block: int,
                    stage_rows: int, slots: int) -> H100StripCost:
    """K1's forward of ``batch`` N x N images at D = ``m_block`` and a
    ring of ``slots`` stages of ``stage_rows`` rows, on one H100
    (``itemsize``: bytes of an image element and of a sum)."""
    from ..kernels.tuning import skew_geometry
    from ..launch.roofline import HW

    out_rows = n + 1
    t = skew_geometry(n, itemsize, out_rows, m_block, stage_rows, slots)
    sms = HW["sms"]
    blocks = batch * t.blocks
    adds = batch * out_rows * n * n
    hbm = blocks * n * n * itemsize + batch * out_rows * n * itemsize
    tail = math.ceil(blocks / sms) / (blocks / sms)
    hbm_ms = 1e3 * hbm / HW["hbm_bw"]
    add_ms = 1e3 * adds / HW["int32_ops"] * tail
    load_ms = 1e3 * adds / (HW["smem_loads_per_clock"] * sms
                            * HW["sm_clock_hz"]) * tail
    terms = {"bytes": hbm_ms, "adds": add_ms, "shared loads": load_ms}
    bound_by = max(terms, key=terms.get)
    return H100StripCost(
        n=n, batch=batch, itemsize=itemsize, m_block=t.m_block,
        stage_rows=t.stage_rows, slots=t.slots, smem_bytes=t.smem,
        blocks_per_image=t.blocks, blocks=blocks, per_sm=t.per_sm,
        waves=blocks / (t.per_sm * sms), tail=tail, adds=adds,
        shared_loads=adds, hbm_bytes=hbm, hbm_ms=hbm_ms, add_ms=add_ms,
        load_ms=load_ms, ms=terms[bound_by], bound_by=bound_by)
