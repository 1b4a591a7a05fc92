"""Ambient transform defaults: ``repro_torch.radon.config(...)``.

A copy of :mod:`repro.radon.ambient` (stdlib only), kept in the port so
it never imports the JAX package.

The operator API keeps per-call knob plumbing out of user code: instead
of threading ``method=`` / ``strip_rows=`` / ``m_block=`` through every
call site, a scope sets them once

    with radon.config(method="cuda", m_block=16):
        op = radon.DPRT(img.shape, img.dtype)   # picks the ambient knobs
        r = op(img)

and every plan/operator built inside the scope resolves unset knobs
against it.  Scopes nest (innermost wins per key) and are thread-local.  Explicit keyword
arguments always beat ambient defaults.

Resolution happens *eagerly*, before any plan-cache lookup, so the ambient scope participates in every cache key: a plan
built inside a scope is never replayed outside one with different
knobs.

This module is deliberately dependency-free (stdlib only) so any layer
of the repo -- kernels, core, launch -- can consult it without import
cycles.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

__all__ = ["config", "current_config", "resolve", "snapshot_knobs",
           "knobs_kwargs", "CONFIG_KEYS"]

#: knobs an ambient scope may set -- the same surface get_plan accepts.
#: This is also the field order of :func:`snapshot_knobs` tuples.
CONFIG_KEYS = ("method", "strip_rows", "m_block", "batch_impl",
               "block_rows", "stream_rows", "block_batch", "mesh")

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class config:
    """Context manager installing ambient transform defaults.

    Accepted keys: ``method``, ``strip_rows``, ``m_block``,
    ``batch_impl``, ``block_rows``, ``stream_rows``, ``block_batch``,
    ``mesh``.  A value
    of ``None`` is ignored (it cannot mask an outer scope's setting).
    Re-entrant use of one ``config`` object is rejected.
    """

    def __init__(self, **knobs: Any):
        unknown = sorted(set(knobs) - set(CONFIG_KEYS))
        if unknown:
            raise TypeError(
                f"radon.config got unknown knob(s) {unknown}; "
                f"valid keys: {list(CONFIG_KEYS)}")
        self._knobs = {k: v for k, v in knobs.items() if v is not None}
        self._active = False

    def __enter__(self) -> "config":
        if self._active:
            raise RuntimeError("this radon.config scope is already active")
        self._active = True
        _stack().append(self._knobs)
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
        popped = _stack().pop()
        assert popped is self._knobs, "radon.config scopes exited out of order"


def current_config() -> Dict[str, Any]:
    """The merged ambient knobs for this thread (innermost scope wins)."""
    merged: Dict[str, Any] = {}
    for frame in _stack():
        merged.update(frame)
    return merged


def resolve(name: str, explicit: Optional[Any], fallback: Any = None) -> Any:
    """Explicit argument > ambient scope > ``fallback``."""
    if explicit is not None:
        return explicit
    value = current_config().get(name)
    return fallback if value is None else value


def snapshot_knobs(method: Optional[str] = None,
                   strip_rows: Optional[int] = None,
                   m_block: Optional[int] = None,
                   batch_impl: Optional[str] = None, *,
                   fallback_method: str = "horner") -> tuple:
    """One hashable tuple of ALL transform knobs, ``CONFIG_KEYS``-ordered.

    Explicit arguments beat the ambient scope; knobs with no explicit
    parameter at the call site come from the scope alone.  Callers that
    cache per knob set use this tuple as their key, so the FULL ambient
    scope participates in it.
    """
    cfg = current_config()
    return (resolve("method", method, fallback_method),
            resolve("strip_rows", strip_rows),
            resolve("m_block", m_block),
            resolve("batch_impl", batch_impl),
            cfg.get("block_rows"), cfg.get("stream_rows"),
            cfg.get("block_batch"), cfg.get("mesh"))


def knobs_kwargs(knobs: tuple) -> Dict[str, Any]:
    """A :func:`snapshot_knobs` tuple as keyword arguments for
    ``radon.DPRT`` / ``get_plan``."""
    return dict(zip(CONFIG_KEYS, knobs))
