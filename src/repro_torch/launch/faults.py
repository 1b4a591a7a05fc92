"""Deterministic fault injection for the port's serving tier.

The port's own copy of :mod:`repro.launch.faults`: the same seam, spec
grammar and numpy RNG, so one seed gives the same fault schedule in
both packages.

A robustness claim that was never exercised is a guess.  This module is
the seam the chaos suite drives: a context-managed
:class:`FaultInjector` that makes the serving stack misbehave in
exactly the ways production does -- kernel dispatch raising, dispatch
stalling past SLOs, AOT blobs corrupting on disk -- while staying fully
deterministic (explicit seed, explicit error budgets), so every chaos
test failure reproduces.

The seam itself is :func:`perturb`: the service's dispatch path calls
``perturb("dispatch", key=...)`` before running a kernel, and the
fallback path calls ``perturb("fallback", key=...)``.  With no injector
active (the production default) that is a single dict-free attribute
check -- no clock reads, no rng, no lock.

Queue floods need no seam: the chaos driver oversubmits through the
router's own bounded admission.  Blob corruption is an on-disk
operation: :func:`corrupt_blobs` deterministically tears/garbles every
``*.blob`` in a directory so the persistent-cache restore path has to
take its degraded cold-compile branch.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["InjectedFault", "FaultInjector", "perturb", "active_injector",
           "corrupt_blobs", "install_from_env", "FAULTS_ENV_VAR"]

#: the env var subprocess workers read at startup to arm deterministic
#: chaos; the supervisor sets it, the worker echoes it in healthz.
FAULTS_ENV_VAR = "REPRO_FAULTS"


class InjectedFault(RuntimeError):
    """The synthetic exception :class:`FaultInjector` raises at a seam
    (stands in for a kernel/dispatch failure; never escapes a correctly
    degrading service)."""


_STACK: list = []                      # innermost-active injector last
_LOCK = threading.Lock()


def active_injector() -> Optional["FaultInjector"]:
    """The innermost active injector, or None (production)."""
    with _LOCK:
        return _STACK[-1] if _STACK else None


def perturb(site: str, key: Optional[str] = None) -> None:
    """The seam: no-op unless a :class:`FaultInjector` is active, else
    delegate to it (may sleep, may raise :class:`InjectedFault`)."""
    if not _STACK:                     # fast path: nothing installed
        return
    inj = active_injector()
    if inj is not None:
        inj.perturb(site, key)


class FaultInjector:
    """Context-managed deterministic fault source.

    ``error_count`` fires an :class:`InjectedFault` on exactly the first
    N matching :func:`perturb` calls (deterministic: exercise "retry
    twice then succeed" or "exhaust retries, fall back" precisely);
    ``error_rate`` adds seeded-random failures after the budget.
    ``delay_s``/``delay_rate`` injects dispatch stalls (SLO pressure).
    ``sites`` restricts which seams fire and ``match`` (substring of the
    seam key, e.g. ``"13x13"``) targets one routed geometry in a
    mixed-traffic chaos run.

    Injectors nest (innermost wins) and are thread-safe: seams run on
    ``asyncio.to_thread`` workers.
    """

    def __init__(self, seed: int = 0, *,
                 sites: Sequence[str] = ("dispatch",),
                 match: Optional[str] = None,
                 error_count: int = 0, error_rate: float = 0.0,
                 delay_s: float = 0.0, delay_rate: float = 1.0):
        if error_count < 0 or not 0.0 <= error_rate <= 1.0:
            raise ValueError("error_count must be >= 0 and error_rate in "
                             f"[0, 1], got {error_count}/{error_rate}")
        if delay_s < 0.0 or not 0.0 <= delay_rate <= 1.0:
            raise ValueError("delay_s must be >= 0 and delay_rate in "
                             f"[0, 1], got {delay_s}/{delay_rate}")
        self.seed = int(seed)
        self.sites = tuple(sites)
        self.match = match
        self.error_count = int(error_count)
        self.error_rate = float(error_rate)
        self.delay_s = float(delay_s)
        self.delay_rate = float(delay_rate)
        self.spec: Optional[str] = None   # set when built via from_spec
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected_errors = 0
        self.injected_delays = 0

    # -- env-var activation (chaos across a process boundary) -------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Build an injector from a compact ``key=value`` spec string,
        e.g. ``"sites=dispatch|fallback;error_count=2;seed=7"``.

        The spec is how deterministic chaos crosses a fork/exec
        boundary: the supervisor can't hand a live object to a
        subprocess worker, but it can put this string in the
        environment.  Pairs are ``;``-separated; ``sites`` values are
        ``|``-separated; unknown keys raise (a typo'd chaos spec that
        silently arms nothing would invalidate the whole run).
        """
        kwargs: Dict[str, object] = {}
        for pair in spec.split(";"):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(f"bad fault spec fragment {pair!r} "
                                 f"(want key=value) in {spec!r}")
            key, val = (s.strip() for s in pair.split("=", 1))
            if key == "sites":
                kwargs[key] = tuple(s for s in val.split("|") if s)
            elif key == "match":
                kwargs[key] = val
            elif key in ("seed", "error_count"):
                kwargs[key] = int(val)
            elif key in ("error_rate", "delay_s", "delay_rate"):
                kwargs[key] = float(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r} "
                                 f"in {spec!r}")
        seed = int(kwargs.pop("seed", 0))
        inj = cls(seed, **kwargs)      # type: ignore[arg-type]
        inj.spec = spec
        return inj

    # -- context management ------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        with _LOCK:
            _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _LOCK:
            if self in _STACK:
                _STACK.remove(self)

    # -- the seam ----------------------------------------------------------
    def perturb(self, site: str, key: Optional[str] = None) -> None:
        if site not in self.sites:
            return
        if self.match is not None and (key is None or self.match not in key):
            return
        with self._lock:
            self.calls += 1
            delay = 0.0
            if self.delay_s > 0.0 and (self.delay_rate >= 1.0
                                       or self._rng.random()
                                       < self.delay_rate):
                delay = self.delay_s
                self.injected_delays += 1
            fire = self.injected_errors < self.error_count
            if not fire and self.error_rate > 0.0:
                fire = bool(self._rng.random() < self.error_rate)
            if fire:
                self.injected_errors += 1
                n = self.injected_errors
        if delay:
            time.sleep(delay)
        if fire:
            raise InjectedFault(
                f"injected fault #{n} at site {site!r}"
                + (f" key={key!r}" if key else ""))

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"seed": self.seed, "sites": self.sites,
                    "match": self.match, "spec": self.spec,
                    "calls": self.calls,
                    "injected_errors": self.injected_errors,
                    "injected_delays": self.injected_delays}

    def __repr__(self) -> str:
        s = self.stats()
        return (f"FaultInjector(seed={s['seed']}, sites={s['sites']}, "
                f"errors={s['injected_errors']}, "
                f"delays={s['injected_delays']})")


def install_from_env(env_var: str = FAULTS_ENV_VAR
                     ) -> Optional[FaultInjector]:
    """Arm a :class:`FaultInjector` from the environment, if set.

    Called once at worker startup (``serve --jsonl``).  The injector is
    *entered* (pushed on the active stack) and returned so the worker
    can echo its spec in healthz; it stays armed for the process
    lifetime -- chaos workers die, they don't gracefully unwind.
    Returns ``None`` when the variable is unset or empty.
    """
    spec = os.environ.get(env_var, "").strip()
    if not spec:
        return None
    inj = FaultInjector.from_spec(spec)
    inj.__enter__()
    return inj


def corrupt_blobs(directory: str, *, seed: int = 0) -> int:
    """Deterministically corrupt every ``*.blob`` in ``directory``;
    returns the number corrupted.  Corruptions alternate between the two
    on-disk failure shapes the persistent cache must survive:

    * **torn write** -- the file truncated mid-payload (header/size
      mismatch, ``load_blob`` raises ``ValueError``);
    * **payload rot** -- header intact, payload overwritten with seeded
      random bytes (loads fine, ``import_executable`` fails).

    Both must degrade to a counted fresh compile, never to an outage.
    """
    rng = np.random.default_rng(seed)
    count = 0
    if not os.path.isdir(directory):
        return 0
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".blob"):
            continue
        path = os.path.join(directory, fname)
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        if len(raw) <= 8:
            continue
        hlen = int.from_bytes(bytes(raw[:8]), "big")
        body = 8 + hlen
        if count % 2 == 0 or body >= len(raw):
            raw = raw[:max(8, len(raw) // 2)]          # torn write
        else:                                          # payload rot
            raw[body:] = rng.integers(0, 256, size=len(raw) - body,
                                      dtype=np.uint8).tobytes()
        with open(path, "wb") as f:
            f.write(bytes(raw))
        count += 1
    return count
