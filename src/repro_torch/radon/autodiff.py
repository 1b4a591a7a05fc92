"""Exact autodiff + retrace accounting for the four plan datapaths.

The port of :mod:`repro.radon.autodiff`.  The DPRT and its inverse are
linear, so each datapath's derivative is its transpose: every kind
(``forward`` / ``inverse`` / ``adjoint`` / ``inverse_adjoint`` on
:class:`repro_torch.core.plan.RadonPlan`) is a
:class:`torch.autograd.Function` whose backward applies the
``TRANSPOSE_OF`` kind -- through the same backend, so gradients of the
``cuda`` backend run the hand-written kernel too (its ``core`` mode).
The backward is itself one of these Functions, so higher-order
gradients stay exact.  A call that needs no gradient runs the plan
directly.

Retrace accounting
------------------
PyTorch runs eagerly: there is no trace to repeat.  What a serving loop
must not repeat is *building* -- a plan (cache miss), a CUDA kernel
library (nvcc), a plan's differentiable pipeline applier
(:mod:`repro_torch.radon.fusion`) or a solver body
(:mod:`repro_torch.radon.solve`).  They are counted here, as
``(plan, "plan")``, ``(library, "kernel")``, ``(plan, "pipeline:<op>")``
and ``(plan, "solve:<method>")`` events; the appliers live in one
per-plan store (:func:`plan_applier`) that drops a plan's entries when
the plan cache evicts it.  :func:`retrace_guard` raises
:class:`RetraceError` when any one of them happens more than
``max_traces`` times inside the scope (``max_traces=0`` asserts a warm
steady state).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..core.plan import add_plan_build_hook, add_plan_evict_hook
from ..kernels import _build

_CACHE_LOCK = threading.RLock()

__all__ = [
    "KINDS",
    "TRANSPOSE_OF",
    "INVERSE_OF",
    "FUNCTIONS",
    "apply_plan",
    "plan_applier",
    "trace_count",
    "trace_counts",
    "reset_trace_counts",
    "retrace_guard",
    "RetraceError",
]

#: the four linear datapaths a plan exposes, and their algebra
KINDS = ("forward", "inverse", "adjoint", "inverse_adjoint")
TRANSPOSE_OF = {"forward": "adjoint", "adjoint": "forward",
                "inverse": "inverse_adjoint", "inverse_adjoint": "inverse"}
# (A^T)^-1 == (A^-1)^T, so inversion swaps within the transposed pair
INVERSE_OF = {"forward": "inverse", "inverse": "forward",
              "adjoint": "inverse_adjoint", "inverse_adjoint": "adjoint"}


def _primal(plan, kind: str, x: torch.Tensor) -> torch.Tensor:
    return getattr(plan, kind)(x)


# ---------------------------------------------------------------------------
# retrace accounting: plan builds and kernel builds
# ---------------------------------------------------------------------------
class RetraceError(RuntimeError):
    """A plan or kernel was built more often than a guard allows."""


_TRACE_COUNTS: dict = {}
_GUARDS: list = []


def _note_trace(subject, kind: str) -> None:
    key = (subject, kind)
    with _CACHE_LOCK:
        _TRACE_COUNTS[key] = _TRACE_COUNTS.get(key, 0) + 1
        for limit, baseline in _GUARDS:
            fresh = _TRACE_COUNTS[key] - baseline.get(key, 0)
            if fresh > limit:
                raise RetraceError(
                    f"{kind} build of {subject!r} happened {fresh} times "
                    f"inside a retrace_guard(max_traces={limit}) -- a warm "
                    f"geometry must not rebuild its plan or kernels")


add_plan_build_hook(lambda plan: _note_trace(plan, "plan"))
_build.add_build_hook(lambda name: _note_trace(name, "kernel"))


def trace_counts() -> dict:
    """All counters: {(plan or library name, "plan" | "kernel"): builds}."""
    with _CACHE_LOCK:
        return dict(_TRACE_COUNTS)


def trace_count(plan=None, kind: Optional[str] = None) -> int:
    """Total builds, optionally filtered by plan and/or event kind."""
    total = 0
    for (subject, k), n in trace_counts().items():
        if plan is not None and subject != plan:
            continue
        if kind is not None and k != kind:
            continue
        total += n
    return total


def reset_trace_counts() -> None:
    with _CACHE_LOCK:
        _TRACE_COUNTS.clear()


@contextlib.contextmanager
def retrace_guard(max_traces: int = 1):
    """Raise :class:`RetraceError` if any plan or kernel library is built
    more than ``max_traces`` times inside the scope."""
    with _CACHE_LOCK:
        frame = (int(max_traces), dict(_TRACE_COUNTS))
        _GUARDS.append(frame)
    try:
        yield
    finally:
        with _CACHE_LOCK:
            _GUARDS.remove(frame)


#: (plan, kind, variant) -> the applier built for it (pipeline
#: Functions, solver bodies)
_APPLIERS: dict = {}


def plan_applier(plan, kind: str, build, variant=()):
    """The applier of one (plan, kind, variant), built by ``build()`` and
    counted as a ``kind`` build of ``plan`` on first use, then reused."""
    key = (plan, kind, variant)
    with _CACHE_LOCK:
        applier = _APPLIERS.get(key)
        if applier is None:
            applier = _APPLIERS[key] = build()
            _note_trace(plan, kind)
    return applier


def _drop_plan(plan) -> None:
    """Plan-cache eviction hook: drop the evicted plan's counters and
    appliers."""
    with _CACHE_LOCK:
        for store in (_TRACE_COUNTS, _APPLIERS):
            for key in [k for k in store if k[0] == plan]:
                del store[key]


add_plan_evict_hook(_drop_plan)


# ---------------------------------------------------------------------------
# the differentiable datapaths: one autograd.Function per kind
# ---------------------------------------------------------------------------
def _make_function(kind: str):
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _primal(plan, kind, x)

    def backward(ctx, grad):
        return FUNCTIONS[TRANSPOSE_OF[kind]].apply(grad.contiguous(),
                                                   ctx.plan), None

    name = "".join(p.title() for p in kind.split("_")) + "Fn"
    return type(name, (torch.autograd.Function,), {
        "__doc__": f"The plan's ``{kind}`` datapath; backward applies "
                   f"``{TRANSPOSE_OF[kind]}``.",
        "forward": staticmethod(forward),
        "backward": staticmethod(backward),
    })


#: kind -> its torch.autograd.Function
FUNCTIONS = {kind: _make_function(kind) for kind in KINDS}


def apply_plan(plan, kind: str, x: torch.Tensor) -> torch.Tensor:
    """Run one datapath of ``plan`` on ``x``, differentiably."""
    if kind not in KINDS:
        raise ValueError(f"unknown datapath kind {kind!r}; one of {KINDS}")
    if torch.is_grad_enabled() and x.requires_grad:
        return FUNCTIONS[kind].apply(x, plan)
    return _primal(plan, kind, x)
