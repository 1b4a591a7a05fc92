"""What a ``torch.profiler`` trace of the profiled span says.

The span wraps the issue of each request in ``record_function(MARK)``.
From the exported Chrome trace this module reads:

* the device activities (kernels, memsets, copies) whose launching runtime
  call lies inside a request's mark, found by the trace's correlation ids,
  so the count does not depend on any kernel's name; the median
  request's count is kept, so a record that the tracer drops, or the
  requests it starts and stops around, do not move it;
* the traced window: from the start of the first such activity to the end
  of the last, so the device work that was already queued when the
  profiler started is not read as idle time;
* the seconds in that window in which any device activity ran (the union
  of their intervals), the device operations that took most time, and the
  longest idle gaps, each named by the innermost host call that was
  running at the gap's midpoint.
"""
from __future__ import annotations

import bisect
import json
import statistics
from dataclasses import dataclass, field
from pathlib import Path

MARK = "perfbench.request"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver", "python_function"})
TOP = 10
NAME_CHARS = 120


@dataclass
class Profile:
    activities_per_request: float | None = None   # the median request's
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host call, seconds]]


def _spans(events, cats):
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_call_at(hosts, starts, t):
    """The innermost host call running at time ``t`` (microseconds)."""
    best = None
    for e in hosts[:bisect.bisect_right(starts, t)]:
        if e["ts"] + e["dur"] >= t and (best is None
                                         or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best is not None else "(no traced host call)"


def read(path: Path) -> Profile:
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    device = _spans(events, DEVICE_CATS)
    marks = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in _spans(events, {"user_annotation", "cpu_op"})
                   if e.get("name") == MARK)
    launch_ts = {}
    for e in _spans(events, {"cuda_runtime", "cuda_driver"}):
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launch_ts[corr] = e["ts"]
    mark_starts = [m[0] for m in marks]

    def request_of(act):
        ts = launch_ts.get(act.get("args", {}).get("correlation"))
        if ts is None:
            return None
        i = bisect.bisect_right(mark_starts, ts) - 1
        return i if i >= 0 and ts <= marks[i][1] else None

    per_mark = [0] * len(marks)
    mine = []
    for act in device:
        i = request_of(act)
        if i is not None:
            per_mark[i] += 1
            mine.append(act)
    prof = Profile()
    if not mine:
        return prof
    prof.activities_per_request = statistics.median(per_mark)
    lo = min(a["ts"] for a in mine)
    hi = max(a["ts"] + a["dur"] for a in mine)
    clipped = [(max(a["ts"], lo), min(a["ts"] + a["dur"], hi), a["name"])
               for a in device if a["ts"] < hi and a["ts"] + a["dur"] > lo]
    busy = _merge((s, e) for s, e, _ in clipped)
    prof.window_s = (hi - lo) * 1e-6
    prof.busy_s = sum(e - s for s, e in busy) * 1e-6

    by_name = {}
    for s, e, name in clipped:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    prof.device_ops = [[n[:NAME_CHARS], v] for n, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    hosts = sorted(_spans(events, HOST_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in hosts]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    prof.idle_gaps = [[_host_call_at(hosts, starts, (s + e) / 2)[:NAME_CHARS],
                       g * 1e-6] for g, s, e in gaps]
    return prof
