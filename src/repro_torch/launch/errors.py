"""Typed service errors shared by the port's serving tier.

The port's own copy of :mod:`repro.launch.errors` (same classes, same
wire codes).

Every rejection a caller can see carries a stable machine-readable
``code`` (the jsonl front-end and the chaos harness both key on it), so
"the router refused" is always distinguishable from "the kernel is
wrong".  The contract the fault-tolerance suite enforces is exactly:
every response is either bit-exact output or one of these.

This module sits below both :mod:`repro_torch.launch.service` and
:mod:`repro_torch.launch.router` (the router imports the service, so the
shared vocabulary cannot live in either), and below the multi-process
:mod:`repro_torch.launch.supervisor` (worker loss is a typed event too).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["ServiceError", "DeadlineExceeded", "QueueFull",
           "ServiceShutdown", "WorkerLost", "error_for_code"]


class ServiceError(RuntimeError):
    """Base of every typed serving rejection; ``code`` is the stable
    wire identifier.  ``retry_after_s``, when set, is the backpressure
    hint: how long the client should wait before retrying (derived from
    queue depth x the route's execution-time EWMA -- an estimate of when
    the congestion that caused this rejection will have drained, not a
    promise of admission)."""

    code = "service_error"
    retry_after_s: Optional[float] = None

    def __init__(self, *args, retry_after_s: Optional[float] = None):
        super().__init__(*args)
        if retry_after_s is not None:
            self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServiceError):
    """The request's SLO deadline passed (or provably cannot be met)
    before its batch dispatched -- rejected instead of served late."""

    code = "deadline_exceeded"


class QueueFull(ServiceError):
    """Bounded admission refused the request: the per-key queue cap, the
    router's global in-flight budget, or the worker pool's pending
    budget is exhausted.  Carries ``retry_after_s`` when the rejecting
    tier can estimate its own drain time."""

    code = "queue_full"


class ServiceShutdown(ServiceError):
    """The service/router is (shutting) down; the request was rejected
    rather than left as a forever-pending future."""

    code = "shutdown"


class WorkerLost(ServiceError):
    """A worker *process* died with this request in flight and the
    one-shot replay could not deliver it (no healthy worker, or the
    request already used its replay).  The typed, recoverable form of
    "the machine serving you crashed" -- never a silent drop."""

    code = "worker_lost"


#: wire code -> exception class; the supervisor rehydrates typed worker
#: rejections through this so a pool client sees the same exception
#: types an in-process router caller would.
_CODE_MAP = {cls.code: cls for cls in
             (ServiceError, DeadlineExceeded, QueueFull, ServiceShutdown,
              WorkerLost)}


def error_for_code(code: str, msg: str,
                   retry_after_s: Optional[float] = None) -> ServiceError:
    """Rebuild the typed exception a remote worker serialized as
    ``{"error": code, "msg": …}``; unknown codes come back as the base
    :class:`ServiceError` (still typed, still not a raw failure)."""
    cls = _CODE_MAP.get(code, ServiceError)
    err = cls(msg)
    if retry_after_s is not None:
        err.retry_after_s = float(retry_after_s)
    return err
