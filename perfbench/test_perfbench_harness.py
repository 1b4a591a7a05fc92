"""The harness on the CPU at a tiny size: a configuration, a traffic mix
and a per-layer metric added only as new files are found by name, a mix
of another kind (an open loop at a fixed rate, steady or in bursts)
among them; an unknown cell fails cleanly; a broken timed path, or the
reference in a narrower precision in the program's place, comes out not
correct.

On the CPU the port's operators run their kernels' plain versions and no
device number is read (the command itself refuses to run without a card).
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import harness, run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TINY_CELL = "tiny13_roundtrip"
CLOSED = {"kind": "closed", "in_flight": 2}


def _tree(tmp_path, n=13, batch=4, arrival=CLOSED):
    """A copy of the benchmark's data and per-name files, plus one new
    configuration, traffic mix and per-layer metric, each a new file."""
    for kind in ("configs", "traffic", "metrics", "reference", "costs",
                 "programs"):
        shutil.copytree(HERE / kind, tmp_path / "perfbench" / kind)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps({
        "op": "dprt", "batch": batch, "n": n, "dtype": "uint8",
        "accumulator": "int32", "control_accumulator": "int16",
        "knobs": {}, "reduced": []}))
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps({
        "request": ["forward", "inverse"], "arrival": arrival, "pool": 3,
        "check_sample": 4, "profile_seconds": 0.05}))
    (pb / "metrics" / "requests_done.py").write_text(
        "def read(obs):\n    return obs.completed\n")
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "requests_done", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "images_per_s",
                              "workloads": [TINY_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(tmp_path)


def _run(bench, seed=2 ** 31 + 5, trace=False, build_program=None):
    return harness.execute(bench, TINY_CELL, seed, 0.15, trace, "cpu",
                           build_program=build_program)


@pytest.fixture(autouse=True)
def _short_warm(monkeypatch):
    monkeypatch.setattr(harness, "WARM_S", 0.02)


def test_new_files_are_found_by_name(tmp_path):
    bench = _tree(tmp_path)
    before = {p: p.read_bytes() for p in HERE.rglob("*")
              if p.is_file() and "out" not in p.parts
              and "__pycache__" not in p.parts}
    result = _run(bench, trace=True)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= result["metrics"]["requests_done"]["value"]
    assert result["metrics"]["requests_done"]["value"] > 0
    # the other per-layer metrics list only the benchmark's own cells
    assert set(result["metrics"]) == {"requests_done"}
    assert list(result)[-1] == "checks"
    assert [m["name"] for m in bench.metrics("end_to_end",
                                             bench.cell(TINY_CELL))] == [
        "images_per_s", "latency_p95_ms", "setup_s"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_untraced_run_reports_the_end_to_end_metrics(tmp_path):
    result = _run(_tree(tmp_path))
    assert result["correct"]
    assert set(result["metrics"]) == {"images_per_s", "latency_p95_ms",
                                      "setup_s"}
    assert result["checks"]["checked"]["value"] == 4


@pytest.mark.parametrize("burst", [None, {"period_s": 0.1, "on_share": 0.2}],
                         ids=["steady", "bursts"])
def test_an_open_loop_mix_is_only_a_new_file(tmp_path, burst):
    """A mix of another kind than the benchmark's closed loops: requests
    offered at a fixed rate whatever the device does, as a data file."""
    rate, seconds = 200.0, 0.5
    arrival = {"kind": "open", "rate_per_s": rate, "max_in_flight": 4}
    if burst:
        arrival["burst"] = burst
    bench = _tree(tmp_path, n=5, batch=1, arrival=arrival)
    result = harness.execute(bench, TINY_CELL, 2 ** 33 + 1, seconds, False,
                             "cpu")
    assert result["correct"] and result["failed"] == 0
    # the offered count follows the rate, not the device
    assert rate * seconds * 0.7 < result["attempted"] < rate * seconds * 1.3
    assert result["metrics"]["latency_p95_ms"]["value"] > 0


def test_open_loop_arrivals_are_one_set_of_gaps_in_a_seeded_order():
    spec = {"kind": "open", "rate_per_s": 50.0, "max_in_flight": 2}
    a, b, c = (harness.Arrivals(spec, s) for s in (7, 7, 8))
    assert a.gaps == b.gaps and a.gaps != c.gaps
    assert sorted(a.gaps) == sorted(c.gaps)
    assert sum(a.gaps) / len(a.gaps) == pytest.approx(1 / 50.0, rel=0.01)
    burst = harness.Arrivals(dict(spec, burst={"period_s": 1.0,
                                               "on_share": 0.1}), 7)
    offsets = burst.offsets()
    times = [next(offsets) for _ in range(500)]
    assert all(t % 1.0 < 0.1 + 1e-9 for t in times)      # only while on
    assert times == sorted(times)
    assert 500 / times[-1] == pytest.approx(50.0, rel=0.15)


def test_an_unknown_arrival_kind_is_refused():
    with pytest.raises(harness.BenchError):
        harness.Arrivals({"kind": "poisson_soup"}, 1)


def test_a_per_layer_metric_must_list_its_cells(tmp_path):
    bench = _tree(tmp_path)
    del bench.spec["per_layer"][0]["workloads"]
    with pytest.raises(harness.BenchError, match="lists no workloads"):
        bench.metrics("per_layer", bench.cell(TINY_CELL))


def test_same_seed_same_inputs():
    a = harness.make_pool((2, 5, 5), torch.uint8, 3, 2 ** 31 + 9, "cpu")
    b = harness.make_pool((2, 5, 5), torch.uint8, 3, 2 ** 31 + 9, "cpu")
    c = harness.make_pool((2, 5, 5), torch.uint8, 3, 2 ** 31 + 10, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unknown_cell_fails_cleanly(capsys):
    assert run.main(["--workload", "no_such_cell", "--seed", "1",
                     "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "unknown workload 'no_such_cell'" in err


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "dprt251_roundtrip", "--seed", "1",
                     "--seconds", "1"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA card" in err


def test_bad_names_are_refused(tmp_path):
    bench = _tree(tmp_path)
    with pytest.raises(harness.BenchError):
        bench.module("metrics", "../run")


# -- the timed path broken underneath: each fault must read not correct --
def _faulty(fault):
    def build(cfg, device):
        prog = dict(harness.Bench(ROOT).module("programs", "dprt")
                    .build(cfg, device))
        fwd, inv = prog["forward"], prog["inverse"]
        n = cfg["n"]
        perm = torch.arange(n + 1)
        perm[[0, 1]] = perm[[1, 0]]
        if fault == "forward_answer_altered":
            def forward(x):
                r = fwd(x)
                r[0, 0, 0] += 1
                return r
            prog["forward"] = forward
        elif fault == "inverse_answer_altered":
            def inverse(r):
                f = inv(r)
                f[-1, -1, -1] += 1
                return f
            prog["inverse"] = inverse
        elif fault == "half_batch_left_out":
            def forward(x):
                r = fwd(x)
                r[x.shape[0] // 2:] = 0
                return r
            prog["forward"] = forward
        elif fault == "output_never_written":
            prog["forward"] = lambda x: torch.zeros_like(fwd(x))
        elif fault == "forward_and_inverse_wrong_alike":
            # directions swapped on the way out and back: the round trip
            # still returns the input, the projections are wrong
            prog["forward"] = lambda x: fwd(x)[:, perm]
            prog["inverse"] = lambda r: inv(r[:, perm])
        return prog
    return build


@pytest.mark.parametrize("fault,check", [
    ("forward_answer_altered", "forward_max_abs_err"),
    ("inverse_answer_altered", "inverse_max_abs_err"),
    ("half_batch_left_out", "forward_max_abs_err"),
    ("output_never_written", "forward_max_abs_err"),
    ("forward_and_inverse_wrong_alike", "forward_max_abs_err"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, check):
    result = _run(_tree(tmp_path), build_program=_faulty(fault))
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["checks"][check]["value"] > 0


def test_the_control_is_not_correct(tmp_path):
    """The reference in the program's place, summed in int16 (the next
    narrower integer than the configuration's int32): at N = 131 the
    inverse's numerators N * f pass 32767 and wrap."""
    bench = _tree(tmp_path, n=131, batch=2)
    ref = bench.module("reference", "dprt")
    result = _run(bench, build_program=lambda cfg, dev: ref.stages(
        cfg, control=True))
    assert result["correct"] is False
    assert result["checks"]["inverse_max_abs_err"]["value"] > 0
