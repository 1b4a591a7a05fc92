"""The convolution cell (``dprt251_conv3x3``) on the CPU at tiny sizes:
the port's ``radon.Conv2D`` against the plain reference
(``reference/conv2d.py``), the reference against the definition, its
int16 control, the counts, the port's spans and counter, the reader of
``conv.kernel_projections_share``, and the cell driven through the
harness (correct; one pixel off by one is not).  The control at the
cell's own size runs on the card::

    python -m pytest -q -s -m cuda perfbench/test_perfbench_conv2d.py
"""
import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, peaks, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CELL = "dprt251_conv3x3"
TINY_CELL = "tiny_conv"
NEW_METRICS = ("roofline.conv", "conv.kernel_projections_share")


def _module(kind, name, path=HERE):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_test_conv2d_{kind}_{name}".replace(".", "_"),
        path / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _module("reference", "conv2d")
costs = _module("costs", "conv2d")


def _images(b, n, seed, high=256):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, (b, n, n), dtype=torch.uint8, generator=gen)


def _kernel(kind, seed):
    if kind == "ones3":
        return torch.ones(3, 3, dtype=torch.uint8)
    size = int(kind[-1])
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (size, size), dtype=torch.uint8,
                         generator=gen)


def loop_conv(f, g):
    """The definition, one pixel at a time."""
    n = f.shape[-1]
    out = np.zeros(f.shape, dtype=np.int64)
    for b in range(f.shape[0]):
        for i in range(n):
            for j in range(n):
                out[b, i, j] = sum(
                    int(g[u, v]) * int(f[b, (i - u) % n, (j - v) % n])
                    for u in range(g.shape[0]) for v in range(g.shape[1]))
    return out


# -- the port against the reference ------------------------------------------
@pytest.mark.parametrize("kind", ["ones3", "random3", "random5"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [7, 11, 13, 31])
def test_port_conv2d_equals_the_reference(n, batch, kind):
    from repro_torch import radon
    seed = 100 * n + 10 * batch + len(kind)
    f, g = _images(batch, n, seed), _kernel(kind, seed + 1)
    got = radon.Conv2D((batch, n, n), g)(f)
    assert got.dtype == torch.int32
    want = ref.direct(f, g)
    assert want.dtype == torch.int64
    assert torch.equal(got.to(torch.int64), want)


@pytest.mark.parametrize("kind", ["ones3", "random3", "random5"])
def test_reference_matches_the_definition(kind):
    f, g = _images(2, 7, 5), _kernel(kind, 6)
    np.testing.assert_array_equal(ref.direct(f, g).numpy(),
                                  loop_conv(f.numpy(), g.numpy()))


def test_the_kernel_comes_from_the_config():
    cfg = json.loads((HERE / "configs" / "conv3x3_n251.json").read_text())
    assert torch.equal(ref.kernel(cfg), torch.ones(3, 3, dtype=torch.int64))
    assert ref.input_shape(cfg) == (256, 251, 251)


# -- the control --------------------------------------------------------------
def test_the_dprt_route_is_exact_in_int64():
    f, g = _images(2, 13, 21), _kernel("random3", 22)
    assert torch.equal(ref.dprt_route(f, g, torch.int64), ref.direct(f, g))


def test_the_int16_control_fails_where_the_numerator_wraps():
    cfg = {"kernel": {"shape": [3, 3], "fill": 1},
           "control_accumulator": "int16"}
    exact = ref.stages(cfg)["conv"]
    control = ref.stages(cfg, control=True)["conv"]
    # N * out <= 13 * 9 * 3 = 351 fits in int16: the wrapped sums are
    # exact modulo 2**16, so the control gives every pixel
    small = _images(2, 13, 31, high=4)
    assert control(small).dtype == torch.int16
    assert torch.equal(control(small).to(torch.int64), exact(small))
    # N * out reaches 31 * 9 * 255 = 71145 > 32767: the floor divide of a
    # wrapped numerator is wrong
    f = _images(2, 31, 32)
    err = (control(f).to(torch.int64) - exact(f)).abs()
    assert int(err.max()) > 0 and int((err > 0).sum()) > f.numel() // 4


# -- the counts ---------------------------------------------------------------
def test_counts_at_the_cells_size():
    """Hand-computed: forward 256 * 251^2 * 252, the 1-D convolutions
    2 * 256 * 252 * 251^2, inverse 256 * 251^2 * 253; bytes 256 * 251^2
    of uint8 in and of int32 out."""
    cfg = json.loads((HERE / "configs" / "conv3x3_n251.json").read_text())
    ops, nbytes = costs.counts(cfg)["conv"]
    assert ops == 4_064_320_512 + 8_128_641_024 + 4_080_448_768
    assert ops == 16_273_410_304
    assert nbytes == 256 * 251 * 251 * (1 + 4) == 80_641_280
    least, by = peaks.least_seconds(ops, nbytes)
    assert by == "operations"
    assert round(least * 1e3, 4) == 0.4865


def test_counts_from_shapes():
    ops, nbytes = costs.stage_counts(2, 5, "uint8", "int64")["conv"]
    assert ops == 2 * (2 * 25 * 6 + 2 * 2 * 6 * 25 + 2 * 25 * 7)
    assert nbytes == 2 * 25 * (1 + 8)


# -- the port's spans and counter ---------------------------------------------
def _span_counts(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return {s: names.count(s) for s in (
        "repro_torch.conv2d.kernel_projections",
        "repro_torch.conv2d.pipeline")}


def test_conv2d_emits_its_spans_and_counts_the_kernel_forward():
    from repro_torch import radon
    from repro_torch.kernels import pipeline as kp
    op = radon.Conv2D((2, 13, 13), torch.ones(3, 3, dtype=torch.uint8))
    f = _images(2, 13, 41)
    op(f)
    kp.reset_launch_counts()
    assert kp.CONV_KERNEL_FORWARDS == 0
    assert set(_span_counts(lambda: op(f)).values()) == {1}
    assert kp.CONV_KERNEL_FORWARDS == 1
    dprt = radon.DPRT((2, 13, 13), torch.uint8)
    assert set(_span_counts(lambda: dprt.inverse(dprt(f))).values()) == {0}
    assert kp.CONV_KERNEL_FORWARDS == 1
    kp.reset_launch_counts()
    assert kp.CONV_KERNEL_FORWARDS == 0


# -- the reader of conv.kernel_projections_share ------------------------------
def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _request(t0, corr, kernel_us, rest_us):
    """One request's mark: a span with one launch, then one launch
    outside it, and the two device activities they launched."""
    return [
        _x("user_annotation", trace.MARK, t0, 20),
        _x("user_annotation", "repro_torch.conv2d.kernel_projections",
           t0 + 1, 5),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 2, 1, corr=corr),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 10, 1, corr=corr + 1),
        _x("kernel", "k1", t0 + 30, kernel_us, corr=corr),
        _x("kernel", "k2", t0 + 40, rest_us, corr=corr + 1),
    ]


def test_the_share_reader_on_a_hand_made_trace(tmp_path):
    metric = _module("metrics", "conv.kernel_projections_share")
    events = ([_x("kernel", "queued_before", 0, 50, corr=1)]
              + _request(100, 10, 5, 95)      # 5%
              + _request(200, 20, 10, 90)     # 10%
              + _request(300, 30, 40, 60))    # 40%
    path = tmp_path / "t.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert metric.share(path) == pytest.approx(10.0)
    # a program without the span: nothing to read
    path.write_text(json.dumps({"traceEvents": [
        e for e in events if not e["name"].startswith("repro_torch.")]}))
    assert metric.share(path) is None


def test_the_share_reader_reads_the_newest_trace(tmp_path):
    (tmp_path / "metrics").mkdir()
    shutil.copy(HERE / "metrics" / "conv.kernel_projections_share.py",
                tmp_path / "metrics")
    metric = _module("metrics", "conv.kernel_projections_share", tmp_path)
    obs = harness.Observation(span_s=1.0, completed=1, enqueue_s=[1e-3],
                              stage_least_s={"conv": 1e-3},
                              profile=trace.Profile())
    assert metric.read(obs) is None               # no trace written yet
    out = tmp_path / "out"
    out.mkdir()
    (out / "old.trace.json").write_text(json.dumps([]))
    os.utime(out / "old.trace.json", (1, 1))
    (out / "new.trace.json").write_text(json.dumps(_request(0, 5, 1, 3)))
    assert metric.read(obs) == pytest.approx(25.0)


# -- the cell through the harness ---------------------------------------------
def _tree(tmp_path, n=13, batch=3):
    """A copy of the benchmark's per-name files, plus a tiny convolution
    configuration and a cell that reports the new per-layer metrics."""
    for kind in ("configs", "traffic", "metrics", "reference", "costs",
                 "programs"):
        shutil.copytree(HERE / kind, tmp_path / "perfbench" / kind)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "conv3x3_n251.json").read_text())
    cfg.update(batch=batch, n=n)
    (tmp_path / "perfbench" / "configs" / "tiny_conv.json").write_text(
        json.dumps(cfg))
    spec["configs"].append({"name": "tiny_conv", "source": "test",
                            "file": "perfbench/configs/tiny_conv.json",
                            "reduced": [], "why": "test"})
    cell = dict(spec["workloads"][-1], name=TINY_CELL, config="tiny_conv")
    spec["workloads"].append(cell)
    for m in spec["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append(TINY_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(tmp_path)


def _run(bench, trace_on=False, build_program=None):
    return harness.execute(bench, TINY_CELL, 2 ** 31 + 77, 0.5, trace_on,
                           "cpu", build_program=build_program)


@pytest.fixture(autouse=True)
def _short_warm(monkeypatch):
    monkeypatch.setattr(harness, "WARM_S", 0.02)


def test_the_cell_is_declared():
    bench = harness.Bench()
    cell = bench.cell(CELL)
    assert cell["chips"] == 1
    cfg = bench.config(cell["config"])
    assert cfg["op"] == "conv2d" and cfg["reduced"] == []
    assert bench.traffic(cell["traffic"])["request"] == ["conv"]
    assert [m["name"] for m in bench.metrics("per_layer", cell)] == list(
        NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(bench.module("metrics", name).read)


@pytest.mark.parametrize("trace_on", [False, True], ids=["untraced", "traced"])
def test_the_tiny_cell_is_correct(tmp_path, trace_on):
    result = _run(_tree(tmp_path), trace_on=trace_on)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["conv_max_abs_err"]["value"] == 0
    assert result["checks"]["checked"]["value"] >= 1
    if trace_on:    # no card: neither new metric has anything to read
        assert not set(result["metrics"]) & set(NEW_METRICS)
    else:   # the rate and p95 need a completion inside the window
        assert "setup_s" in result["metrics"]
        assert set(result["metrics"]) <= {"images_per_s", "latency_p95_ms",
                                          "setup_s"}


def test_one_pixel_off_by_one_is_not_correct(tmp_path):
    bench = _tree(tmp_path)

    def build(cfg, device):
        conv = bench.module("programs", "conv2d").build(cfg, device)["conv"]

        def off_by_one(x):
            y = conv(x)
            y[-1, 2, 5] += 1
            return y
        return {"conv": off_by_one}

    result = _run(bench, build_program=build)
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["conv_max_abs_err"]["value"] == 1


def test_the_control_is_not_correct_through_the_harness(tmp_path):
    bench = _tree(tmp_path, n=31, batch=2)
    result = _run(bench, build_program=lambda cfg, dev: ref.stages(
        cfg, control=True))
    assert result["correct"] is False
    assert result["checks"]["conv_max_abs_err"]["value"] > 0


# -- on the card --------------------------------------------------------------
@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    bench = harness.Bench()
    for seed in (2 ** 31 + 404, 2 ** 31 + 505, 2 ** 31 + 606):
        result = harness.execute(
            bench, CELL, seed, 5.0, False, torch.device("cuda"),
            build_program=lambda cfg, dev: ref.stages(cfg, control=True))
        print(f"control {CELL} seed {seed}: correct {result['correct']} "
              f"checks {json.dumps(result['checks'])}")
        assert result["correct"] is False
        assert result["checks"]["conv_max_abs_err"]["value"] > 0
