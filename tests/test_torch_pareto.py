"""The port's ``core/pareto.py`` against the reference's, and K1's H100
strip model against K1's tile geometry.

* Every public name of ``repro.core.pareto`` exists in
  ``repro_torch.core.pareto`` and returns exactly the reference's values
  (integers, the reference's floats bit for bit) on a grid: every prime
  N <= 251, B in {8, 12, 16}, H over ``range(2, N)``, and
  ``tpu_strip_cost`` at a few (H, m_block); the paper's pinned numbers
  (N = 251, B = 8: FDPRT 511 cycles, systolic 63,253 cycles and 516,096
  flip-flops).
* ``h100_strip_cost`` takes shared memory, blocks per image and blocks
  per SM from ``kernels.tuning.skew_geometry``; its add count equals the
  terms a DPRT of an all-ones image sums (numpy oracle), its HBM bytes
  each block's read of its image plus the output, and its time the
  largest of its three terms.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import pareto as RP
from repro.core.dprt import dprt_oracle_np
from repro_torch.core import pareto as TP
from repro_torch.kernels.tuning import H100_SMS, skew_geometry, skew_tile
from repro_torch.launch.roofline import HW

PRIMES = [p for p in range(2, 252)
          if all(p % q for q in range(2, int(p ** 0.5) + 1))]
BITS = (8, 12, 16)
#: the (n, h) functions and the (n, h, b) functions of the grid
NH = ("cycles_sfdprt",)
NHB = ("cycles_isfdprt", "flipflops_sfdprt", "adders_sfdprt")
NB = ("cycles_ifdprt", "flipflops_serial", "flipflops_systolic",
      "flipflops_fdprt", "adders_serial", "adders_systolic",
      "adders_fdprt")
N_ONLY = ("cycles_serial", "cycles_systolic", "cycles_fdprt",
          "pareto_front")


def test_every_public_name_is_ported():
    assert set(RP.__all__) <= set(TP.__all__)
    assert {"H100StripCost", "h100_strip_cost"} <= set(TP.__all__)
    for name in RP.__all__:
        assert callable(getattr(TP, name)), name


def test_paper_pinned_numbers():
    assert TP.cycles_fdprt(251) == 511
    assert TP.cycles_systolic(251) == 63_253
    assert TP.flipflops_systolic(251, 8) == 516_096
    # H = 84: ~36x faster than systolic with ~25% fewer flip-flops (the
    # reference's tests/test_dprt_core.py bands)
    assert 34 <= TP.cycles_systolic(251) / TP.cycles_sfdprt(251, 84) <= 38
    assert 0.70 <= TP.flipflops_sfdprt(251, 84, 8) \
        / TP.flipflops_systolic(251, 8) <= 0.80


@pytest.mark.parametrize("name", N_ONLY)
def test_functions_of_n(name):
    for n in PRIMES:
        assert getattr(TP, name)(n) == getattr(RP, name)(n), n


@pytest.mark.parametrize("name", NB)
def test_functions_of_n_and_bits(name):
    for n in PRIMES:
        for b in BITS:
            assert getattr(TP, name)(n, b) == getattr(RP, name)(n, b)


@pytest.mark.parametrize("name", NH + NHB)
def test_functions_of_n_and_strip_height(name):
    for n in PRIMES:
        for h in range(2, n):
            if name in NH:
                assert getattr(TP, name)(n, h) == getattr(RP, name)(n, h)
                continue
            for b in BITS:
                assert getattr(TP, name)(n, h, b) == \
                    getattr(RP, name)(n, h, b), (n, h, b)


def test_tree_resources_and_pareto_points():
    for x in range(1, 252):
        for b in BITS:
            assert TP.tree_resources(x, b) == RP.tree_resources(x, b)
    for n in PRIMES:
        for b in BITS:
            assert TP.pareto_points(n, b) == RP.pareto_points(n, b)


@pytest.mark.parametrize("n,h,m_block", [
    (251, 84, 8), (251, 8, 32), (251, 251, 252), (13, 3, 2),
    (509, 16, 64), (31, 2, 1)])
def test_tpu_strip_cost(n, h, m_block):
    for in_bytes in (1, 4):
        got = TP.tpu_strip_cost(n, h, m_block, in_bytes)
        want = RP.tpu_strip_cost(n, h, m_block, in_bytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# K1 on one H100
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,batch,itemsize,d,stage_rows,slots", [
    (251, 256, 4, 32, 17, 2), (251, 256, 4, 8, 17, 2),
    (251, 1, 4, 16, 17, 2), (251, 256, 4, 56, 9, 4),
    (13, 5, 4, 4, 3, 2), (61, 3, 8, 7, 5, 3)])
def test_h100_strip_cost_follows_k1_geometry(n, batch, itemsize, d,
                                             stage_rows, slots):
    c = TP.h100_strip_cost(n, batch, itemsize, d, stage_rows, slots)
    t = skew_geometry(n, itemsize, n + 1, d, stage_rows, slots)
    assert (c.smem_bytes, c.blocks_per_image, c.per_sm) == \
        (t.smem, t.blocks, t.per_sm)
    assert c.blocks == batch * -(-(n + 1) // d)
    assert c.waves == c.blocks / (c.per_sm * H100_SMS)
    # each output of the N+1 projections sums N terms: an all-ones image
    # sums to N in every output, so its projections total the adds
    ones = np.ones((n, n), np.int64)
    assert c.adds == c.shared_loads == batch * int(dprt_oracle_np(ones).sum())
    assert c.hbm_bytes == (c.blocks * n * n + batch * (n + 1) * n) \
        * itemsize
    busiest = math.ceil(c.blocks / H100_SMS)
    assert c.tail == busiest / (c.blocks / H100_SMS) >= 1.0
    assert c.ms == max(c.hbm_ms, c.add_ms, c.load_ms)
    assert c.bound_by in ("bytes", "adds", "shared loads")
    assert c.hbm_ms == 1e3 * c.hbm_bytes / HW["hbm_bw"]


def test_h100_strip_cost_at_the_main_paths_tile():
    """radon_251's K1 forward (B = 256) at the tile skew_tile picks: the
    shared loads bound it, 8 blocks per image, 2048 blocks."""
    t = skew_tile(251, 251, 4, 251, 32, 252, batch=256)
    c = TP.h100_strip_cost(251, 256, 4, t.m_block, t.stage_rows, t.slots)
    assert (c.m_block, c.blocks_per_image, c.blocks) == (32, 8, 2048)
    assert c.bound_by == "shared loads"
    assert c.adds == 256 * 252 * 251 * 251
