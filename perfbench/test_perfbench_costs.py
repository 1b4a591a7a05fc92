"""The benchmark's counts reproduce the port's bound times (PERF.md §6)
at the port's instruction rate, and give half of them at the benchmark's
peak of additions."""
import importlib.util
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
spec = importlib.util.spec_from_file_location(
    "perfbench_test_costs_dprt", HERE / "costs" / "dprt.py")
costs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(costs)
spec = importlib.util.spec_from_file_location("perfbench_test_peaks",
                                              HERE / "peaks.py")
peaks = importlib.util.module_from_spec(spec)
spec.loader.exec_module(peaks)


#: the port's ``launch/roofline.py`` rate: one addition per instruction
PORT_INSTRUCTION_RATE = dict(peaks.H100_SXM, int32_adds_per_s=16.75e12)


@pytest.mark.parametrize("batch,n,acc,stage,ms,port_ms", [
    (256, 251, "int32", "forward", 0.1215, 0.2426),
    (256, 251, "int32", "inverse", 0.1220, 0.2436),
    (1, 4099, "int64", "forward", 4.1188, 8.2254),
    (4, 4099, "int64", "forward", 16.4753, 32.9014),
    (4, 4099, "int64", "inverse", 16.4793, 32.9095),
])
def test_bound_times(batch, n, acc, stage, ms, port_ms):
    """At the benchmark's peak (an IADD3 is two additions) and, at the
    port's one addition per instruction, §6's bounds: the counts are the
    same, the peak is twice the port's."""
    ops, nbytes = costs.stage_counts(batch, n, "uint8", acc)[stage]
    least, by = peaks.least_seconds(ops, nbytes)
    assert by == "operations"
    assert round(least * 1e3, 4) == ms
    least, by = peaks.least_seconds(ops, nbytes, PORT_INSTRUCTION_RATE)
    assert by == "operations"
    assert round(least * 1e3, 4) == port_ms


def test_counts_from_shapes():
    ops, nbytes = costs.stage_counts(2, 5, "uint8", "int64")["forward"]
    assert ops == 2 * 2 * 25 * 6
    assert nbytes == 2 * 25 * 1 + 2 * 30 * 8
    cfg = {"batch": 2, "n": 5, "dtype": "uint8", "accumulator": "int32"}
    ops, nbytes = costs.counts(cfg)["inverse"]
    assert ops == 2 * 25 * 7 and nbytes == 2 * 30 * 4 + 2 * 25 * 4
