"""The control of each cell at the cell's own size, on the card: the
plain reference in the program's place, summed in the configuration's
``control_accumulator`` (int16 at N = 251, float32 at N = 4099), driven
through a short window at the cell's load, must come out not correct on
every seed.  Int32 sums at N = 4099, the type just below the stated
int64, wrap and stay exact (every output fits in int32): that reading is
kept too.  Skips without a card; on the card::

    python -m pytest -q -s -m cuda perfbench/test_perfbench_control.py
"""
import json

import pytest
import torch

from perfbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
#: long enough to finish as many requests as a run compares (the control
#: at N = 4099 takes ~10 s a request of 4 images)
WINDOW_S = {"dprt251_roundtrip": 5.0, "dprt4099_roundtrip": 50.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(WINDOW_S))
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    bench = harness.Bench()
    ref = bench.module("reference", bench.config(
        bench.cell(cell)["config"])["op"])
    for seed in SEEDS:
        result = harness.execute(
            bench, cell, seed, WINDOW_S[cell], False, torch.device("cuda"),
            build_program=lambda cfg, dev: ref.stages(cfg, control=True))
        print(f"control {cell} seed {seed}: correct {result['correct']} "
              f"checks {json.dumps(result['checks'])}")
        assert result["correct"] is False


@pytest.mark.cuda
def test_wrapped_int32_sums_are_exact_at_n4099():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reading is at the cell's size")
    bench = harness.Bench()
    cell = "dprt4099_roundtrip"
    ref = bench.module("reference", "dprt")
    result = harness.execute(
        bench, cell, SEEDS[0], WINDOW_S[cell], False, torch.device("cuda"),
        build_program=lambda cfg, dev: ref.stages(
            dict(cfg, control_accumulator="int32"), control=True))
    print(f"int32 sums {cell} seed {SEEDS[0]}: correct {result['correct']} "
          f"checks {json.dumps(result['checks'])}")
    assert result["correct"] is True
