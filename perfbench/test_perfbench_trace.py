"""The trace reader on a hand-made Chrome trace: activities counted per
request by correlation id, the window, the busy union and the idle gaps."""
import json

from pytest import approx

from perfbench import trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read(tmp_path):
    events = [
        # work queued before the span: not a request's, not in the window
        _x("cuda_runtime", "cudaLaunchKernel", 0, 2, corr=1),
        _x("kernel", "old", 5, 10, corr=1),
        # request 1: two launches; request 2: three (one a memset)
        _x("user_annotation", trace.MARK, 10, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 11, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 2, corr=3),
        _x("user_annotation", trace.MARK, 30, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 2, corr=4),
        _x("cuda_runtime", "cudaMemsetAsync", 33, 2, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 36, 2, corr=6),
        _x("kernel", "k1", 20, 30, corr=2),
        _x("kernel", "k2", 50, 10, corr=3),
        _x("cpu_op", "aten::wait", 55, 20),
        _x("kernel", "k1", 70, 30, corr=4),
        _x("gpu_memset", "Memset", 100, 5, corr=5),
        _x("kernel", "k2", 105, 10, corr=6),
        _x("gpu_user_annotation", trace.MARK, 20, 95),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    p = trace.read(path)
    assert p.activities_per_request == 2.5
    assert p.window_s == approx(95e-6)      # 20 .. 115
    assert p.busy_s == approx(85e-6)        # idle 60 .. 70
    assert p.device_ops[0] == ["k1", approx(60e-6)]
    assert p.idle_gaps == [["aten::wait", approx(10e-6)]]


def test_no_requests(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps([_x("kernel", "k", 0, 1, corr=1)]))
    p = trace.read(path)
    assert p.activities_per_request is None and p.busy_s == 0.0
