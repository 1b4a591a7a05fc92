"""Process-level cache/build health report: ``python -m repro_torch.radon.healthz``.

The port of :mod:`repro.radon.healthz`, the ``/healthz``-style
counterpart to :mod:`repro_torch.radon.selfcheck`: where selfcheck
*exercises* the API, this module *inspects* a process -- plan-cache
hit/miss/eviction counters, the warm plan entries themselves, the build
counts by subject (plans, appliers and nvcc libraries: the zero-rebuild
serving property as data), the in-memory AOT executable census, and the
environment fingerprint persistent executable blobs are keyed against.
The same counters back
:meth:`repro_torch.launch.service.DPRTService.healthz`, which prepends
its admission-queue and latency sections.

``report()`` returns the formatted text; :func:`snapshot` the raw dict.
Exit code is always 0 -- counters are a readout, not a judgement.  The
fingerprint names ``--device`` (default ``cuda``, which needs a card;
``--device cpu`` reads the process on the CPU).
"""
from __future__ import annotations

import argparse

__all__ = ["snapshot", "report", "main"]


def _label(subject, kind: str) -> str:
    geometry = getattr(subject, "geometry", None)
    if geometry is None:            # an nvcc library, by name
        return f"{subject}/{kind}"
    return f"{geometry.image_shape}/{subject.dtype_name}/{kind}"


def snapshot(device="cuda") -> dict:
    """The raw counter dict behind :func:`report`."""
    import os

    from . import (aot_cache_info, aot_fingerprint, plan_cache_entries,
                   plan_cache_info, trace_count, trace_counts)
    # distinct plans (different knobs/mesh) can share a label: aggregate,
    # so the per-label counts still sum to the process total
    traces: dict = {}
    for (subject, kind), n in trace_counts().items():
        label = _label(subject, kind)
        traces[label] = traces.get(label, 0) + n
    return {
        "fingerprint": aot_fingerprint(device),
        "plan_cache": plan_cache_info()._asdict(),
        "plans": plan_cache_entries(),
        "traces_total": trace_count(),
        "traces": dict(sorted(traces.items())),
        "aot_cache": aot_cache_info(),
        # armed chaos spec, if any (REPRO_FAULTS): echoed so "why is
        # this worker misbehaving" is answerable from its healthz alone
        "faults_env": os.environ.get("REPRO_FAULTS") or None,
    }


def report(device="cuda") -> str:
    """Format :func:`snapshot` as the ``[healthz]`` text block."""
    s = snapshot(device)
    lines = [
        f"[healthz] {s['fingerprint']}",
        "[healthz] plan_cache hits={hits} misses={misses} "
        "currsize={currsize} maxsize={maxsize} evictions={evictions}"
        .format(**s["plan_cache"]),
    ]
    for p in s["plans"]:
        lines.append(f"[healthz]   plan {p.get('image_shape')} "
                     f"method={p.get('method')}")
    lines.append(f"[healthz] traces total={s['traces_total']}")
    for path, count in s["traces"].items():
        lines.append(f"[healthz]   trace {path} x{count}")
    aot = s["aot_cache"]
    lines.append(f"[healthz] aot_executables currsize={aot['currsize']}")
    for key in aot["keys"]:
        lines.append(f"[healthz]   aot {key}")
    if s.get("faults_env"):
        lines.append(f"[healthz] faults_env {s['faults_env']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.radon.healthz")
    ap.add_argument("--device", default="cuda",
                    help="device the fingerprint names (default cuda)")
    args = ap.parse_args(argv)
    print(report(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
