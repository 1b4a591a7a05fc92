"""The general harness: one cell of ``BENCHMARK.json``, run and judged.

A cell names a configuration and a traffic mix; everything else is found
by name (see :mod:`perfbench`).  A run:

1. makes the cell's pool of inputs on the device from ``--seed``, builds
   the system under test (``programs/<op>.py``) and warms exactly the
   request it will send;
2. measures for ``--seconds`` one client that offers the mix's requests
   as its ``arrival`` says (:class:`Arrivals`: a closed loop that keeps
   ``in_flight`` requests on the device, or an open loop at a fixed rate,
   steady or in on/off bursts), with no synchronise between requests,
   inside the program's guard against builds;
3. with ``--trace 1`` times each stage of each request with CUDA events,
   then profiles a short span of the same loop with ``torch.profiler``;
4. compares a sample of the window's answers, drawn from the seed, with
   the plain reference (``reference/<op>.py``), which recomputes every
   stage from the inputs once the window has closed;
5. returns the result line's fields.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import re
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import peaks
from . import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: how long past the window's close an answer is waited for
LATE_S = 60.0
#: seconds of the cell's own loop in set-up, after its first requests
WARM_S = 1.0
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class BenchError(Exception):
    """A cell, file or argument that the benchmark cannot run."""


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------
def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise BenchError(f"not a benchmark name: {name!r}")
    return name


def _load_json(path: Path):
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"missing file {path}") from None


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = _load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.spec["workloads"])
        raise BenchError(f"unknown workload {name!r} (cells: {known})")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return dict(_load_json(self.root / entry["file"]),
                            name=name)
        raise BenchError(f"unknown configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return _load_json(self.root / "perfbench" / "traffic"
                          / f"{_checked(name)}.json")

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py``, loaded from its file."""
        path = self.root / "perfbench" / kind / f"{_checked(name)}.py"
        if not path.is_file():
            raise BenchError(f"missing file {path}")
        mod_name = "perfbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, section: str, cell: dict) -> list:
        """The entries of ``section`` that ``cell`` reports: those whose
        ``workloads`` list it; an end-to-end entry without that key is
        reported by every cell, and a per-layer entry must have it."""
        out = []
        for m in self.spec[section]:
            if "workloads" not in m and section == "per_layer":
                raise BenchError(f"per-layer metric {m['name']!r} lists no "
                                 f"workloads")
            if cell["name"] in m.get("workloads", (cell["name"],)):
                out.append(m)
        return out


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------
class _HostEvent:
    """Where there is no card (the CPU tests), a request's completion is
    the return of its calls; no device time is read from it."""

    def record(self):
        pass

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass


class Device:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def event(self, timing: bool = False):
        if self.cuda:
            return torch.cuda.Event(enable_timing=timing)
        return _HostEvent()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def make_pool(shape, dtype: torch.dtype, count: int, seed: int,
              device: torch.device) -> torch.Tensor:
    """``count`` distinct inputs of ``shape``, uniform over the whole range
    of the integer ``dtype``, made in one call on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, (count, *shape),
                         dtype=dtype, generator=gen, device=device)


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------
#: inter-arrival gaps an open loop cycles through, shuffled by the seed
GAPS = 1024
#: how long the client sleeps while it waits for an arrival or a completion
POLL_S = 5e-5


class Arrivals:
    """When the client offers each request, from the mix's ``arrival``:

    * ``{"kind": "closed", "in_flight": k}``: the next request as soon as
      fewer than ``k`` are on the device;
    * ``{"kind": "open", "rate_per_s": r, "max_in_flight": k}``: requests at
      ``r`` a second on average, whatever the device does; with ``"burst":
      {"period_s": p, "on_share": s}`` all of them in the first ``s * p``
      seconds of every period, at ``r / s`` a second.  The gaps are the
      ``GAPS`` quantiles of the exponential distribution, in an order drawn
      from the seed, so every seed offers the same set of gaps.  When ``k``
      are on the device the client waits for the oldest; the requests it
      then offers late still count their latency from their arrival.
    """

    def __init__(self, spec: dict, seed: int):
        self.kind = spec.get("kind")
        if self.kind == "closed":
            self.in_flight = int(spec["in_flight"])
            return
        if self.kind != "open":
            raise BenchError(f"unknown arrival kind {self.kind!r}")
        self.in_flight = int(spec["max_in_flight"])
        burst = spec.get("burst")
        self.period = float(burst["period_s"]) if burst else None
        self.on_s = float(burst["on_share"]) * self.period if burst else None
        rate = float(spec["rate_per_s"]) / (
            float(burst["on_share"]) if burst else 1.0)
        self.gaps = [-math.log(1.0 - (i + 0.5) / GAPS) / rate
                     for i in range(GAPS)]
        random.Random(seed).shuffle(self.gaps)

    @property
    def open(self) -> bool:
        return self.kind == "open"

    def offsets(self):
        """Seconds after the window's start at which request 0, 1, ...
        arrives (an open loop only)."""
        t_on, k = 0.0, 0
        while True:
            if self.period is None:
                yield t_on
            else:
                yield (t_on // self.on_s) * self.period + t_on % self.on_s
            t_on += self.gaps[k % GAPS]
            k += 1


@dataclass
class Request:
    slot: int
    t_submit: float     # its arrival
    t_begin: float      # the client starts to issue it
    t_issued: float     # the client has issued it
    events: list
    t_done: float = math.nan


class Sample:
    """A reservoir of ``size`` requests' outputs, drawn from ``seed``:
    every request issued has the same chance to be kept."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept = []            # [(k, slot, outputs)]

    def offer(self, k: int, slot: int, outputs) -> None:
        if len(self.kept) < self.size:
            self.kept.append((k, slot, outputs))
            return
        j = self.rng.randrange(k + 1)
        if j < self.size:
            self.kept[j] = (k, slot, outputs)


@dataclass
class Window:
    t_start: float
    t_end: float
    issued: int
    done: list = field(default_factory=list)
    unfinished: int = 0

    @property
    def completed(self) -> list:
        """Requests that completed inside the window."""
        return [r for r in self.done if r.t_done <= self.t_end]

    @property
    def span_s(self) -> float:
        """From the window's start to the last completion inside it: the
        time that the completed requests' work took, none of it cut off."""
        done = [r.t_done for r in self.completed]
        return max(done) - self.t_start if done else 0.0


def _issue(k, t_submit, stages, pool, dev, timing, annotate) -> tuple:
    slot = k % len(pool)
    with annotate() if annotate else contextlib.nullcontext():
        t_begin = time.perf_counter()
        events = []
        if timing:
            events.append(dev.event(True))
            events[-1].record()
        y, outputs = pool[slot], []
        for fn in stages:
            y = fn(y)
            outputs.append(y)
            if timing:
                events.append(dev.event(True))
                events[-1].record()
        if not timing:
            events.append(dev.event(False))
            events[-1].record()
        t_issued = time.perf_counter()
    return Request(slot, t_submit, t_begin, t_issued, events), outputs


def _complete(req: Request) -> Request:
    req.events[-1].synchronize()
    req.t_done = time.perf_counter()
    return req


def drive(stages, pool, arrivals: Arrivals, seconds: float, dev: Device, *,
          timing: bool = False, sample: Sample | None = None,
          annotate=None, k0: int = 0) -> Window:
    """One client that offers requests as ``arrivals`` says until
    ``seconds`` have passed; then it waits for the rest, at most
    :data:`LATE_S`.  A request's latency runs from its arrival (a closed
    loop's is its issue) to the host time its completion is seen."""
    pending = deque()
    t_start = time.perf_counter()
    win = Window(t_start, t_start + seconds, 0)
    offsets = arrivals.offsets() if arrivals.open else None
    k = k0
    while True:
        while len(pending) >= arrivals.in_flight:
            win.done.append(_complete(pending.popleft()))
        if offsets is None:
            t_submit = time.perf_counter()
        else:
            t_submit = t_start + next(offsets)
            while time.perf_counter() < min(t_submit, win.t_end):
                if pending and pending[0].events[-1].query():
                    win.done.append(_complete(pending.popleft()))
                else:
                    time.sleep(POLL_S)
        if max(t_submit, time.perf_counter()) >= win.t_end:
            break
        req, outputs = _issue(k, t_submit, stages, pool, dev, timing,
                              annotate)
        pending.append(req)
        if sample is not None:
            sample.offer(k, req.slot, outputs)
        del outputs
        k += 1
    win.issued = k - k0
    deadline = time.perf_counter() + LATE_S
    while pending:
        req = pending.popleft()
        while not req.events[-1].query() and time.perf_counter() < deadline:
            time.sleep(1e-4)
        if req.events[-1].query():
            win.done.append(_complete(req))
        else:
            win.unfinished += 1
    return win


def warm(stages, pool, dev: Device, held: int, seconds: float,
         arrivals: Arrivals) -> None:
    """Set-up's warm-up of exactly the cell's request: ``held`` requests
    whose outputs are all alive at once (so the allocator holds as many
    blocks as the window's sample and pipeline keep), then the loop
    itself for ``seconds``."""
    outs = []
    for k in range(held):
        y = pool[k % len(pool)]
        for fn in stages:
            y = fn(y)
            outs.append(y)
    dev.sync()
    del outs
    drive(stages, pool, arrivals, seconds, dev)


def profile_span(stages, pool, arrivals: Arrivals, seconds: float,
                 dev: Device,
                 path: Path, k0: int) -> tracing.Profile:
    """The same loop for ``seconds`` under ``torch.profiler``, each
    request's issue marked; the trace is written to ``path`` and read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        drive(stages, pool, arrivals, seconds, dev, k0=k0,
              annotate=lambda: record_function(tracing.MARK))
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return tracing.read(path)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def check(sample: Sample, pool, reference: dict, stage_names, unfinished):
    """Compare each sampled request's outputs with the reference, stage by
    stage, recomputed from the request's input: exact integers, so every
    limit is 0.  Returns ``(checks, bad requests)``."""
    worst = {name: 0 for name in stage_names}
    bad = set()
    by_slot = {}
    for k, slot, outputs in sample.kept:
        by_slot.setdefault(slot, []).append((k, outputs))
    for slot in sorted(by_slot):
        y, want = pool[slot], []
        for name in stage_names:
            y = reference[name](y)
            want.append(y)
        for k, outputs in by_slot[slot]:
            for name, got, ref in zip(stage_names, outputs, want):
                if tuple(got.shape) != tuple(ref.shape):
                    err = None
                else:
                    err = int((got.to(torch.int64) - ref.to(torch.int64))
                              .abs().max())
                if err is None or worst[name] is None:
                    worst[name] = None
                else:
                    worst[name] = max(worst[name], err)
                if err != 0:
                    bad.add(k)
        del want, y
    checks = {f"{name}_max_abs_err": {"value": worst[name], "max": 0}
              for name in stage_names}
    checks["unfinished"] = {"value": unfinished, "max": 0}
    checks["checked"] = {"value": len(sample.kept), "min": 1}
    return checks, bad


def passes(checks: dict) -> bool:
    for c in checks.values():
        v = c["value"]
        if v is None or ("max" in c and v > c["max"]) or (
                "min" in c and v < c["min"]):
            return False
    return True


# ---------------------------------------------------------------------------
# what the metrics read
# ---------------------------------------------------------------------------
def percentile(sorted_samples, q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted sequence
    (the port's ``launch/service.py:percentile``)."""
    if not sorted_samples:
        raise ValueError("percentile of no samples")
    pos = (len(sorted_samples) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_samples) - 1)
    frac = pos - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac


@dataclass
class Observation:
    """What a traced run gives the per-layer readers."""
    span_s: float                       # window start to last completion
    completed: int
    enqueue_s: list
    stage_least_s: dict                 # {stage: least seconds per call}
    stage_device_s: dict | None = None  # {stage: [device s]}; None: no card
    profile: tracing.Profile | None = None

    def roofline(self, stage: str):
        times = (self.stage_device_s or {}).get(stage)
        if not times or sum(times) <= 0:
            return None
        return 100.0 * self.stage_least_s[stage] * len(times) / sum(times)


def forbidden_modules() -> list:
    """The top-level names, compared whole, of the JAX modules and the JAX
    package that this process has loaded (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_state() -> dict:
    """The card's SM clock and power limit, read beside the peaks."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.splitlines()[0]
        name, clock, limit = (v.strip() for v in out.split(","))
        return {"name": name, "sm_clock_mhz": float(clock),
                "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def execute(bench: Bench, workload: str, seed: int, seconds: float,
            trace: bool, device, *, t0: float | None = None,
            build_program=None) -> dict:
    """Run one cell and return the result line's fields.  ``t0`` is the
    process's start on the host clock; ``build_program(config, device)``
    replaces the system under test (the control, and the tests' faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    reference = bench.module("reference", cfg["op"])
    costs = bench.module("costs", cfg["op"])
    program_mod = bench.module("programs", cfg["op"])
    dev = Device(device)

    phases = {"imports": time.perf_counter() - t0}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    trace_file = bench.root / "perfbench" / "out" / f"{workload}.trace.json"
    pool = make_pool(reference.input_shape(cfg), getattr(torch, cfg["dtype"]),
                     traffic["pool"], seed, dev.device)
    dev.sync()
    phase("pool")
    program = (build_program or program_mod.build)(cfg, dev.device)
    phase("build")
    names = traffic["request"]
    stages = [program[s] for s in names]
    arrivals = Arrivals(traffic["arrival"], seed)
    sample_size = traffic["check_sample"]
    warm(stages, pool, dev, arrivals.in_flight + sample_size + 1, WARM_S,
         arrivals)
    phase("warm")
    if trace:   # the profiler's own first start belongs to set-up
        profile_span(stages, pool, arrivals,
                     min(0.1, traffic["profile_seconds"]), dev, trace_file,
                     k0=0)
        phase("profiler")
    sample = Sample(sample_size, seed)
    with program_mod.window_guard():
        win = drive(stages, pool, arrivals, seconds, dev, timing=trace,
                    sample=sample)
        prof = None
        if trace:
            prof = profile_span(stages, pool, arrivals,
                                traffic["profile_seconds"], dev, trace_file,
                                k0=win.issued)
    setup_s = win.t_start - t0
    memory_peak = (torch.cuda.max_memory_allocated(dev.device)
                   if dev.cuda else 0)
    card = card_state() if dev.cuda else {}   # as the window left the card

    completed = win.completed
    stage_device_s = None
    if trace and dev.cuda:
        stage_device_s = {name: [r.events[i].elapsed_time(r.events[i + 1])
                                 * 1e-3 for r in completed]
                          for i, name in enumerate(names)}
    del program, stages
    counts = costs.counts(cfg)
    least = {name: peaks.least_seconds(*counts[name]) for name in names}

    t_check = time.perf_counter()
    checks, bad = check(sample, pool, reference.stages(cfg), names,
                        win.unfinished)
    dev.sync()
    check_s = time.perf_counter() - t_check
    correct = passes(checks)

    latencies = sorted(r.t_done - r.t_submit for r in completed)
    if trace:
        obs = Observation(
            span_s=win.span_s, completed=len(completed),
            enqueue_s=[r.t_issued - r.t_begin for r in completed],
            stage_least_s={n: v[0] for n, v in least.items()},
            stage_device_s=stage_device_s,
            profile=prof)
        metrics = {}
        for m in bench.metrics("per_layer", cell):
            value = bench.module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "images_per_s": (cfg["batch"] * len(completed) / win.span_s
                             if completed else None),
            "latency_p95_ms": (1e3 * percentile(latencies, 95)
                               if latencies else None),
            "setup_s": setup_s,
        }
        metrics = {}
        for m in bench.metrics("end_to_end", cell):
            if m["name"] not in e2e:
                raise BenchError(f"no end-to-end metric {m['name']!r}")
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    result = {
        "correct": correct,
        "attempted": win.issued,
        "failed": win.unfinished + len(bad),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.cuda else dev.device.type,
            "kind": (torch.cuda.get_device_name(dev.device) if dev.cuda
                     else dev.device.type),
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if trace and prof is not None:
        result["device"]["busy_s"] = prof.busy_s
        result["device"]["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": prof.device_ops,
                               "idle_gaps": prof.idle_gaps}
    result["run"] = {
        "workload": workload, "seed": seed, "seconds": seconds,
        "completed_in_window": len(completed),
        "latency_n": len(latencies),
        "latency_p50_ms": (1e3 * percentile(latencies, 50)
                           if latencies else None),
        "span_s": win.span_s,
        "least_ms": {n: [1e3 * v, term] for n, (v, term) in least.items()},
        "peaks": peaks.H100_SXM["name"],
        "card": card,
        "setup_s": setup_s,
        "setup_phases_s": phases,
        "check_s": check_s,
    }
    result["checks"] = checks
    return result
