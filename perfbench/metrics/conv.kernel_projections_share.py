"""The share of a ``radon.Conv2D`` call's device time that computes the
kernel's projections: for each request of the profiled span, the device
time of the activities (kernels, memsets, copies) launched inside the
port's ``repro_torch.conv2d.kernel_projections`` span over the device
time of those launched inside the request's mark, matched by the trace's
correlation ids as ``trace.py`` matches them; the median request's share.

It reads the Chrome trace that the run itself wrote last, the newest
``perfbench/out/<cell>.trace.json`` (the harness writes it just before
the per-layer readers run).  Where the program has no such span, or the
trace holds no device activity, it reads nothing.  Layer: the operator
API and the plan (``radon/operators.py``: ``Conv2D.__call__`` makes the
kernel's projections on every call).
"""
from __future__ import annotations

import bisect
import json
import statistics
from pathlib import Path

from perfbench.trace import DEVICE_CATS, MARK

SPAN = "repro_torch.conv2d.kernel_projections"
OUT = Path(__file__).resolve().parents[1] / "out"


def _spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("name") == name
                  and e.get("cat") in ("user_annotation", "cpu_op")
                  and "dur" in e)


def _inside(spans, starts, ts):
    i = bisect.bisect_right(starts, ts) - 1
    return i if i >= 0 and ts <= spans[i][1] else None


def share(path: Path):
    """The median request's share, in %, of one exported trace."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    marks, spans = _spans(events, MARK), _spans(events, SPAN)
    if not marks or not spans:
        return None
    mark_starts, span_starts = [m[0] for m in marks], [s[0] for s in spans]
    launch_ts = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (e.get("ph") == "X" and corr is not None
                and e.get("cat") in ("cuda_runtime", "cuda_driver")):
            launch_ts[corr] = e["ts"]
    total = [0.0] * len(marks)
    mine = [0.0] * len(marks)
    for act in events:
        if (act.get("ph") != "X" or act.get("cat") not in DEVICE_CATS
                or "dur" not in act):
            continue
        ts = launch_ts.get(act.get("args", {}).get("correlation"))
        i = None if ts is None else _inside(marks, mark_starts, ts)
        if i is None:
            continue
        total[i] += act["dur"]
        if _inside(spans, span_starts, ts) is not None:
            mine[i] += act["dur"]
    shares = [100.0 * m / t for m, t in zip(mine, total) if t > 0]
    return statistics.median(shares) if shares else None


def read(obs):
    if obs.profile is None:
        return None
    traces = sorted(OUT.glob("*.trace.json"), key=lambda p: p.stat().st_mtime)
    return share(traces[-1]) if traces else None
