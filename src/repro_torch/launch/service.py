"""Latency statistics shared by the port's serving entry points.

The port of the statistics half of :mod:`repro.launch.service`
(``percentile``, ``latency_summary``, ``format_latency``); the
dynamic-batching service itself is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

__all__ = ["latency_summary", "format_latency", "percentile"]


def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted sequence."""
    if not sorted_samples:
        raise ValueError("percentile of no samples")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    pos = (len(sorted_samples) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_samples) - 1)
    frac = pos - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac


def latency_summary(samples_s: Iterable[float]) -> Dict[str, float]:
    """p50/p95/p99/mean/max (milliseconds) + count over latency samples
    in seconds.  Empty input -> ``{"n": 0}``."""
    xs = sorted(samples_s)
    if not xs:
        return {"n": 0}
    return {
        "n": len(xs),
        "mean_ms": 1e3 * sum(xs) / len(xs),
        "p50_ms": 1e3 * percentile(xs, 50),
        "p95_ms": 1e3 * percentile(xs, 95),
        "p99_ms": 1e3 * percentile(xs, 99),
        "max_ms": 1e3 * xs[-1],
    }


def format_latency(summary: Dict[str, float],
                   imgs_per_s: Optional[float] = None) -> str:
    """One-line latency report: ``p50=… p95=… p99=… ms (n=…, mean=…)``."""
    if not summary.get("n"):
        return "latency: no samples"
    line = (f"latency p50={summary['p50_ms']:.2f} "
            f"p95={summary['p95_ms']:.2f} p99={summary['p99_ms']:.2f} "
            f"max={summary['max_ms']:.2f} ms "
            f"(n={summary['n']}, mean={summary['mean_ms']:.2f} ms)")
    if imgs_per_s is not None:
        line += f", {imgs_per_s:.1f} img/s"
    return line
