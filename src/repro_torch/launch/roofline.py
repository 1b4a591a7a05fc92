"""Roofline terms of a step at one NVIDIA H100's peaks.

The port of :mod:`repro.launch.roofline`, whose ``HW`` holds a TPU's
peaks; this ``HW`` holds the H100 SXM's, from NVIDIA's data sheet (dense
rates, without sparsity, at the 700 W power limit).  Three terms per
step, in seconds, per device:

    compute    = flops / peak_flops     (bf16 tensor cores; float32
                                         steps: ``peak_flops=HW["f32_flops"]``)
    memory     = bytes / hbm_bw
    collective = collective bytes / link_bw   (NVLink 4, one direction)

The counts come from :func:`repro_torch.launch.hlo_cost.analyze_step`,
which counts the aten and c10d operations a call dispatches (there is no
compiled HLO in the port).  The reference's ``parse_collectives`` reads
collective bytes out of partitioned HLO text; here the same per-class
dict -- ``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``, ``count``, ``total`` -- comes
from ``analyze_step(...)["collectives"]``, under the reference's byte
conventions: an all-reduce, all-to-all or send counts its tensor, an
all-gather its operand (the result over the group size), a
reduce-scatter its operand (the result times the group size).

``HW`` is also where the repository's other H100 figures live: the
float32 peak outside the tensor cores, the int32 add rate, and the SM
count, clock and shared-memory load rate the K1 strip model of
:func:`repro_torch.core.pareto.h100_strip_cost` reads; ``chip_smoke.py``
reads its bounds from here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..kernels.tuning import H100_SMS
from ..parallel.sharding import map_specs

__all__ = ["HW", "roofline_terms", "param_counts", "model_flops"]

HW = {
    # dense bf16 tensor-core rate: 989 TFLOP/s (H100 SXM data sheet), the
    # counterpart of the reference's TPU bf16 peak
    "peak_flops": 989e12,
    # HBM3: 3.35 TB/s (data sheet)
    "hbm_bw": 3.35e12,
    # NVLink 4: 900 GB/s per GPU over both directions (18 links of
    # 50 GB/s, data sheet), 450 GB/s each way
    "link_bw": 450e9,
    # float32 outside the tensor cores: 67 TFLOP/s (data sheet; an FMA
    # counts as two), the rate of the port's float32 "highest" products
    "f32_flops": 67e12,
    # int32 adds: 132 SMs x 64 INT32 lanes x 1.98 GHz, half the lane-ops
    # behind the float32 figure
    "int32_ops": 16.75e12,
    # SMs and the boost clock behind those rates (data sheet; the SM
    # count is also K1's default wave width, kernels/tuning.py)
    "sms": H100_SMS,
    "sm_clock_hz": 1.98e9,
    # shared-memory loads an SM issues per clock: 32 banks of 4 bytes
    "smem_loads_per_clock": 32,
}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, chips: int,
                   peak_flops: Optional[float] = None) -> Dict[str, float]:
    """The reference's terms at ``HW``; ``peak_flops`` replaces the bf16
    tensor-core rate (a float32 step: ``HW["f32_flops"]``)."""
    compute = flops_per_dev / (peak_flops or HW["peak_flops"])
    memory = bytes_per_dev / HW["hbm_bw"]
    collective = coll_bytes_per_dev / HW["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms.update(dominant=dom.replace("_s", ""),
                 step_s_lower_bound=bound,
                 chips=chips,
                 global_flops=flops_per_dev * chips,
                 global_bytes=bytes_per_dev * chips,
                 global_coll_bytes=coll_bytes_per_dev * chips)
    return terms


def param_counts(specs) -> Tuple[int, int]:
    """(total, non-routed) parameters of a ``ParamSpec`` tree: a leaf
    under a ``moe`` key with an ``experts`` axis is a routed expert's."""
    counts = []

    def leaf(path, spec):
        n = 1
        for d in spec.shape:
            n *= int(d)
        routed = "moe" in path and "experts" in (spec.logical or ())
        counts.append((n, routed))

    map_specs(leaf, specs)
    total = sum(n for n, _ in counts)
    return total, sum(n for n, routed in counts if not routed)


def model_flops(cfg, specs, tokens: int, mode: str):
    """``(flops, total, active)``: 6 * N_active * D (train) or
    2 * N_active * D (inference); routed experts count k/E of theirs."""
    total, nonrouted = param_counts(specs)
    routed = total - nonrouted
    if cfg.num_experts:
        active = nonrouted + routed * cfg.experts_per_token / cfg.num_experts
    else:
        active = total
    mult = 6.0 if mode == "train" else 2.0
    return mult * active * tokens, total, active
