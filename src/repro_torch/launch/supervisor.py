"""Supervised multi-process serving of the port: the :class:`WorkerPool`.

The port of :mod:`repro.launch.supervisor`.
:class:`~repro_torch.launch.router.ServiceRouter` is fault-tolerant
*inside one process*; this module is the layer that survives the
process itself dying.  A :class:`WorkerPool` spawns N ``serve --mode
service --jsonl --framed`` router subprocesses over one shared
``aot_dir`` and makes worker loss a typed, recoverable event:

* **Framed pipe protocol.**  Length-prefixed jsonl frames
  (:mod:`repro_torch.launch.pool`) on stdin/stdout; a SIGKILL mid-write reads
  as truncation (EOF), never as a mangled request.
* **Health probes.**  A monitor thread sends an in-band ``healthz`` op
  on an interval; a worker that misses ``probe_misses`` consecutive
  probes is *suspect* and killed (crash detection for the hung-not-dead
  case), which funnels into the same death path as a real crash.
* **Crash recovery.**  A dead worker's in-flight requests are replayed
  **once** on a healthy peer -- bit-exact, the identical frame, with
  the payload digest journaled at dispatch and at replay so the
  equivalence is auditable -- or rejected typed as
  :class:`~repro_torch.launch.errors.WorkerLost`.  Never silently dropped.
  The worker itself is restarted under exponential backoff and comes
  back *warm*: its prefill restores the shared ``aot_dir`` blobs
  (published under cross-process compile locks) instead of recompiling.
* **Request journal.**  Every dispatch/deliver/replay/loss is recorded
  through :class:`~repro_torch.launch.pool.RequestJournal` -- the WAL that
  backs the accounting identity.
* **Bounded admission.**  A pool-wide pending budget; exceeding it
  rejects with :class:`~repro_torch.launch.errors.QueueFull` carrying a
  ``retry_after_s`` hint (pending depth x smoothed delivery time).
* **Graceful drain.**  :meth:`drain` stops admitting, asks each worker
  to flush (shutdown op -> the worker answers everything in flight,
  typed-rejects its queue, exits), and escalates SIGTERM -> SIGKILL
  only on timeout.
* **Pool healthz.**  :meth:`healthz` aggregates per-worker reports and
  closes the same identity the router does:
  ``admitted == delivered + failed + rejected + pending``.

Workers on one card are processes with a CUDA context each; the pool's
``device`` is passed to every worker (``--device cpu`` for a pool on the
CPU).
"""
from __future__ import annotations

import json
import queue
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from .errors import QueueFull, ServiceShutdown, WorkerLost, error_for_code
from .pool import RequestJournal, payload_digest, read_frame, write_frame

__all__ = ["WorkerPool", "default_worker_cmd"]

#: error codes the pool books as typed rejections; anything else a
#: worker reports ("internal", "bad_request") is a raw failure.
_TYPED_CODES = ("deadline_exceeded", "queue_full", "shutdown",
                "worker_lost", "service_error")


def default_worker_cmd(*, aot_dir: str, manifest: Sequence,
                       max_batch: int = 16, queue_cap: int = 64,
                       max_inflight: int = 256,
                       device: str = "cuda") -> List[str]:
    """The argv of one real router worker subprocess on ``device``."""
    return [sys.executable, "-m", "repro_torch.launch.serve",
            "--mode", "service", "--jsonl", "--framed", "--sigterm-drain",
            "--aot-dir", aot_dir, "--manifest", json.dumps(list(manifest)),
            "--batch", str(max_batch), "--queue-cap", str(queue_cap),
            "--max-inflight", str(max_inflight), "--device", str(device)]


class _PoolRequest:
    __slots__ = ("rid", "msg", "future", "digest", "replayed", "t_submit")

    def __init__(self, rid, msg, future, digest):
        self.rid = rid
        self.msg = msg
        self.future = future
        self.digest = digest
        self.replayed = False
        self.t_submit = time.monotonic()


class _Worker:
    """One subprocess plus its pipe plumbing.  The writer thread owns
    stdin (an outbox queue decouples dispatch from pipe backpressure --
    a full 64KB pipe must block the writer thread, never the pool
    lock); the reader thread owns stdout and is also the crash
    detector: EOF on a worker's stdout IS the death notification."""

    __slots__ = ("idx", "proc", "outbox", "reader", "writer", "alive",
                 "inflight", "restarts", "generation", "last_reply",
                 "booted", "probes_missed", "last_healthz", "draining")

    def __init__(self, idx: int):
        self.idx = idx
        self.proc: Optional[subprocess.Popen] = None
        self.outbox: "queue.Queue" = queue.Queue()
        self.reader: Optional[threading.Thread] = None
        self.writer: Optional[threading.Thread] = None
        self.alive = False
        self.inflight: Dict[str, _PoolRequest] = {}
        self.restarts = 0
        self.generation = 0
        self.last_reply = 0.0
        self.booted = False            # answered at least one frame
        self.probes_missed = 0
        self.last_healthz: Optional[dict] = None
        self.draining = False

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class WorkerPool:
    """Supervise N framed-jsonl router workers over one ``aot_dir``.

    ``cmd`` is the worker argv (default: :func:`default_worker_cmd`
    over ``aot_dir``/``manifest``/``device``); tests substitute a stub.  The pool
    is thread-safe; :meth:`submit` returns a
    :class:`concurrent.futures.Future` resolving to the result array
    or raising the typed error.  Use as a context manager, or call
    :meth:`start` / :meth:`drain` explicitly.
    """

    def __init__(self, n_workers: int = 2, *,
                 aot_dir: Optional[str] = None,
                 manifest: Sequence = (),
                 cmd: Optional[Sequence[str]] = None,
                 max_batch: int = 16,
                 pending_cap: int = 256,
                 probe_interval_s: float = 1.0,
                 probe_misses: int = 3,
                 restart_backoff_s: float = 0.25,
                 max_restarts: int = 5,
                 journal_path: Optional[str] = None,
                 env: Optional[dict] = None,
                 stderr=None,
                 drain_timeout_s: float = 30.0,
                 device: str = "cuda"):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if pending_cap < 1 or probe_misses < 1:
            raise ValueError("pending_cap and probe_misses must be >= 1")
        self.n_workers = int(n_workers)
        self.aot_dir = aot_dir
        self.manifest = list(manifest)
        self.max_batch = int(max_batch)
        self.pending_cap = int(pending_cap)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_misses = int(probe_misses)
        self.restart_backoff_s = float(restart_backoff_s)
        self.max_restarts = int(max_restarts)
        self.drain_timeout_s = float(drain_timeout_s)
        self.device = str(device)
        self._cmd = list(cmd) if cmd is not None else None
        self._env = dict(env) if env is not None else None
        self._stderr = stderr
        self.journal = RequestJournal(journal_path)

        self._lock = threading.RLock()
        self._workers: List[_Worker] = [_Worker(i)
                                        for i in range(self.n_workers)]
        self._rid = 0
        self._rr = 0                      # round-robin cursor
        self._started = False
        self._draining = False
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._restart_threads: List[threading.Thread] = []

        # -- accounting: every admitted future ends in exactly one bin
        self.admitted = 0
        self.delivered = 0
        self.failed = 0
        self.rejected: Dict[str, int] = {}
        #: typed refusals at submit time (no future was created, so
        #: they sit outside the admitted identity -- like the router's
        #: rejected_admission)
        self.rejected_admission: Dict[str, int] = {}
        self.replays = 0
        self.worker_restarts = 0
        self.workers_lost = 0
        self.suspect_kills = 0
        self._delivery_ewma: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------
    def worker_cmd(self) -> List[str]:
        if self._cmd is not None:
            return list(self._cmd)
        if self.aot_dir is None:
            raise ValueError("WorkerPool needs aot_dir (or an explicit cmd)")
        return default_worker_cmd(aot_dir=self.aot_dir,
                                  manifest=self.manifest,
                                  max_batch=self.max_batch,
                                  device=self.device)

    def start(self) -> "WorkerPool":
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._draining = False
            for w in self._workers:
                self._spawn(w)
            self._monitor_stop.clear()
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="pool-monitor")
            self._monitor.start()
        return self

    def __enter__(self) -> "WorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    def _spawn(self, w: _Worker) -> None:
        """Start (or restart) one worker process and its pipe threads.
        Caller holds the lock."""
        w.proc = subprocess.Popen(
            self.worker_cmd(), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._stderr,
            text=True, env=self._env)
        w.alive = True
        w.draining = False
        w.generation += 1
        w.booted = False
        w.probes_missed = 0
        w.last_reply = time.monotonic()
        w.outbox = queue.Queue()
        gen = w.generation
        w.reader = threading.Thread(target=self._reader_loop, args=(w, gen),
                                    daemon=True,
                                    name=f"pool-reader-{w.idx}")
        w.writer = threading.Thread(target=self._writer_loop, args=(w, gen),
                                    daemon=True,
                                    name=f"pool-writer-{w.idx}")
        w.reader.start()
        w.writer.start()

    # -- pipe threads ------------------------------------------------------
    def _writer_loop(self, w: _Worker, gen: int) -> None:
        while True:
            item = w.outbox.get()
            if item is None or w.generation != gen:
                return
            try:
                write_frame(w.proc.stdin, item)
            except (OSError, ValueError):
                # broken pipe: the reader's EOF owns the death path;
                # this request stays in `inflight` and gets replayed
                return

    def _reader_loop(self, w: _Worker, gen: int) -> None:
        stdout = w.proc.stdout
        while True:
            try:
                msg = read_frame(stdout)
            except Exception:
                msg = None                 # protocol corruption == crash
            if msg is None:
                break
            if w.generation == gen:
                self._on_frame(w, msg)
        if w.generation == gen:
            self._on_worker_exit(w)

    def _on_frame(self, w: _Worker, msg: dict) -> None:
        rid = msg.get("id")
        w.last_reply = time.monotonic()
        w.booted = True
        w.probes_missed = 0
        if rid == "__probe__" or rid == "__drain__":
            with self._lock:
                w.last_healthz = msg
            return
        if rid is None or msg.get("shutdown"):
            return
        with self._lock:
            req = w.inflight.pop(rid, None)
        if req is None:
            return                         # late duplicate (already replayed)
        self._resolve(req, msg)

    # -- the single resolution site ----------------------------------------
    def _resolve(self, req: _PoolRequest, msg: dict) -> None:
        """Book exactly one terminal outcome for ``req`` and resolve its
        future.  Every path that finishes a request funnels through
        here, so a request can never be double-counted or double-set."""
        if req.future.done():
            return
        if msg.get("ok"):
            dt = time.monotonic() - req.t_submit
            with self._lock:
                self.delivered += 1
                self._delivery_ewma = (dt if self._delivery_ewma is None
                                       else 0.7 * self._delivery_ewma
                                       + 0.3 * dt)
            self.journal.record("deliver", req.rid,
                                replayed=req.replayed)
            req.future.set_result(np.asarray(msg.get("data")))
            return
        code = msg.get("error", "internal")
        text = msg.get("msg", "")
        if code in _TYPED_CODES:
            with self._lock:
                self.rejected[code] = self.rejected.get(code, 0) + 1
            self.journal.record("typed", req.rid, code=code)
            req.future.set_exception(
                error_for_code(code, text, msg.get("retry_after_s")))
        else:
            with self._lock:
                self.failed += 1
            self.journal.record("fail", req.rid, code=code)
            req.future.set_exception(RuntimeError(
                f"worker failure ({code}): {text}"))

    # -- crash handling ----------------------------------------------------
    def _on_worker_exit(self, w: _Worker) -> None:
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            w.outbox.put(None)             # release the writer thread
            orphans = list(w.inflight.values())
            w.inflight.clear()
            clean = w.draining or self._draining
            if not clean:
                self.workers_lost += 1
        for req in orphans:
            if clean:
                # graceful exit: anything unanswered was queue-rejected
                # by the worker itself; a stray orphan is a shutdown
                with self._lock:
                    self.rejected["shutdown"] = \
                        self.rejected.get("shutdown", 0) + 1
                self.journal.record("typed", req.rid, code="shutdown")
                if not req.future.done():
                    req.future.set_exception(ServiceShutdown(
                        "pool drained with request in flight"))
                continue
            self._replay_or_reject(req, dead_idx=w.idx)
        if not clean:
            self._schedule_restart(w)

    def _replay_or_reject(self, req: _PoolRequest, *, dead_idx: int) -> None:
        """One-shot replay: a request that was in flight on a dead
        worker is re-dispatched bit-exact (the identical frame) on a
        healthy peer exactly once; a second loss -- or no healthy peer
        -- rejects it typed.  Never a silent drop, never a duplicate
        delivery race (the dead worker can no longer answer)."""
        with self._lock:
            target = self._pick_worker(exclude=dead_idx) \
                if not req.replayed else None
            if target is not None:
                req.replayed = True
                target.inflight[req.rid] = req
                self.replays += 1
        if target is not None:
            self.journal.record("replay", req.rid, worker=target.idx,
                                digest=req.digest)
            target.outbox.put(req.msg)
            return
        with self._lock:
            self.rejected["worker_lost"] = \
                self.rejected.get("worker_lost", 0) + 1
        self.journal.record("lost", req.rid, digest=req.digest)
        if not req.future.done():
            req.future.set_exception(WorkerLost(
                f"worker {dead_idx} died with request {req.rid} in "
                f"flight and no replay was possible"))

    def _schedule_restart(self, w: _Worker) -> None:
        with self._lock:
            if self._draining or w.restarts >= self.max_restarts:
                return
            w.restarts += 1
            backoff = self.restart_backoff_s * (2 ** (w.restarts - 1))
            t = threading.Thread(target=self._restart_after,
                                 args=(w, backoff), daemon=True,
                                 name=f"pool-restart-{w.idx}")
            self._restart_threads.append(t)
        t.start()

    def _restart_after(self, w: _Worker, backoff: float) -> None:
        time.sleep(backoff)
        with self._lock:
            if self._draining or w.alive:
                return
            self._spawn(w)
            self.worker_restarts += 1

    # -- probes ------------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self.probe_interval_s):
            with self._lock:
                workers = [w for w in self._workers if w.alive]
            for w in workers:
                if w.proc.poll() is not None:
                    continue               # reader's EOF handles it
                # a probe went unanswered for a full interval: the
                # worker is hung-or-wedged.  The clock only runs once
                # the worker has booted (its compile-heavy prefill
                # happens before it reads stdin) and pauses while
                # requests are in flight -- slow is not dead while
                # work completes.
                if w.booted and not w.inflight \
                        and time.monotonic() - w.last_reply \
                        > self.probe_interval_s:
                    w.probes_missed += 1
                if w.probes_missed >= self.probe_misses:
                    with self._lock:
                        self.suspect_kills += 1
                    self.kill_worker(w.idx)   # suspect -> kill -> restart
                    continue
                w.outbox.put({"op": "healthz", "id": "__probe__"})

    # -- admission / dispatch ----------------------------------------------
    def _retry_after_s(self) -> float:
        per = self._delivery_ewma or 0.05
        batches = self.pending() // max(1, self.max_batch) + 1
        return round(batches * per, 6)

    def _pick_worker(self, exclude: Optional[int] = None) \
            -> Optional[_Worker]:
        """Next healthy worker round-robin; caller holds the lock."""
        n = len(self._workers)
        for off in range(n):
            w = self._workers[(self._rr + off) % n]
            if w.alive and not w.draining and w.idx != exclude:
                self._rr = (self._rr + off + 1) % n
                return w
        return None

    def submit(self, spec, data, *, deadline_ms: Optional[float] = None,
               priority: int = 0) -> Future:
        """Admit one request into the pool; returns a Future resolving
        to the result array or raising the typed rejection."""
        arr = np.asarray(data)
        msg = dict(spec)
        msg["op"] = "submit"
        msg["data"] = arr.tolist()
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        if priority:
            msg["priority"] = int(priority)
        with self._lock:
            if not self._started or self._draining:
                raise ServiceShutdown("worker pool is not running")
            if self.pending() >= self.pending_cap:
                self.rejected_admission["queue_full"] = \
                    self.rejected_admission.get("queue_full", 0) + 1
                raise QueueFull(
                    f"pool pending budget {self.pending_cap} exhausted",
                    retry_after_s=self._retry_after_s())
            w = self._pick_worker()
            if w is None:
                raise ServiceShutdown("no live worker in the pool")
            self._rid += 1
            rid = f"r{self._rid}"
            msg["id"] = rid
            req = _PoolRequest(rid, msg, Future(), payload_digest(arr))
            self.admitted += 1
            w.inflight[req.rid] = req
        self.journal.record("dispatch", rid, worker=w.idx,
                            digest=req.digest)
        w.outbox.put(msg)
        return req.future

    # -- chaos / control surface -------------------------------------------
    def kill_worker(self, idx: int, sig: int = signal.SIGKILL) -> bool:
        """Deliver ``sig`` to worker ``idx`` (the chaos harness's
        mid-burst SIGKILL); death flows through the normal crash path.
        True if a live process was signalled."""
        with self._lock:
            w = self._workers[idx]
            proc = w.proc if w.alive else None
        if proc is None or proc.poll() is not None:
            return False
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            return False
        return True

    def wait_ready(self, timeout_s: float = 120.0) -> bool:
        """Block until every live worker answers a healthz probe --
        i.e. is past its (possibly compile-heavy) prefill.  True when
        all answered within ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            workers = [w for w in self._workers if w.alive]
        for w in workers:
            w.last_healthz = None
            w.outbox.put({"op": "healthz", "id": "__probe__"})
        while time.monotonic() < deadline:
            if all(w.last_healthz is not None or not w.alive
                   for w in workers):
                return any(w.alive for w in workers)
            time.sleep(0.02)
        return False

    def wait_pending(self, timeout_s: float = 60.0) -> bool:
        """Block until nothing is pending; True on success."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.pending() == 0:
                return True
            time.sleep(0.01)
        return False

    # -- drain -------------------------------------------------------------
    def drain(self) -> None:
        """Graceful pool shutdown: stop admitting, ask every worker to
        flush and exit, escalate SIGTERM then SIGKILL on timeout.
        Every admitted future is resolved by the time this returns."""
        with self._lock:
            if not self._started:
                return
            self._draining = True
            workers = [w for w in self._workers if w.alive]
            for w in workers:
                w.draining = True
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=self.probe_interval_s + 1.0)
        for w in workers:
            w.outbox.put({"op": "shutdown", "id": "__drain__"})
        deadline = time.monotonic() + self.drain_timeout_s
        for w in workers:
            left = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                w.proc.terminate()         # SIGTERM: worker drains itself
                try:
                    w.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait()
        for w in workers:
            if w.reader is not None:
                w.reader.join(timeout=5.0)
        # anything STILL unresolved (worker never answered) is a typed
        # shutdown, not a hang: a future the pool handed out resolves
        leftovers = []
        with self._lock:
            for w in self._workers:
                leftovers.extend(w.inflight.values())
                w.inflight.clear()
                w.alive = False
                w.outbox.put(None)
            self._started = False
        for req in leftovers:
            with self._lock:
                self.rejected["shutdown"] = \
                    self.rejected.get("shutdown", 0) + 1
            self.journal.record("typed", req.rid, code="shutdown")
            if not req.future.done():
                req.future.set_exception(ServiceShutdown(
                    "pool drained with request unanswered"))
        self.journal.close()

    # -- observability -----------------------------------------------------
    def pending(self) -> int:
        return sum(len(w.inflight) for w in self._workers)

    def rejected_total(self) -> int:
        return sum(self.rejected.values())

    def identity_ok(self) -> bool:
        """The pool accounting identity: every admitted request is in
        exactly one terminal bin or still pending."""
        return self.admitted == (self.delivered + self.failed
                                 + self.rejected_total() + self.pending())

    def verdict(self) -> str:
        """``FAIL``: dropped/raw-failed work or broken accounting.
        ``WARN``: clean answers but degradation happened (worker lost,
        replay, restart, rejection).  ``OK``: nothing went wrong."""
        if self.failed > 0 or not self.identity_ok():
            return "FAIL"
        if not self._started and self.pending() > 0:
            return "FAIL"
        degradations = (self.workers_lost + self.replays
                        + self.worker_restarts + self.suspect_kills
                        + self.rejected_total()
                        + sum(self.rejected_admission.values()))
        return "WARN" if degradations else "OK"

    def healthz(self, probe: bool = False,
                probe_timeout_s: float = 5.0) -> dict:
        """Aggregate pool health.  ``probe=True`` refreshes each live
        worker's in-band healthz first (blocking up to the timeout)."""
        if probe:
            with self._lock:
                workers = [w for w in self._workers if w.alive]
            for w in workers:
                w.last_healthz = None
                w.outbox.put({"op": "healthz", "id": "__probe__"})
            deadline = time.monotonic() + probe_timeout_s
            while time.monotonic() < deadline:
                if all(w.last_healthz is not None or not w.alive
                       for w in workers):
                    break
                time.sleep(0.02)
        with self._lock:
            report = {
                "verdict": self.verdict(),
                "workers": [{
                    "idx": w.idx, "pid": w.pid, "alive": w.alive,
                    "restarts": w.restarts, "inflight": len(w.inflight),
                    "worker_verdict": (w.last_healthz or {}).get("verdict"),
                    "retraces_since_start":
                        (w.last_healthz or {}).get("retraces_since_start"),
                    "persistent": (w.last_healthz or {}).get("persistent"),
                    "faults_env": (w.last_healthz or {}).get("faults_env"),
                } for w in self._workers],
                "admitted": self.admitted,
                "delivered": self.delivered,
                "failed": self.failed,
                "rejected": dict(self.rejected),
                "rejected_admission": dict(self.rejected_admission),
                "pending": self.pending(),
                "replays": self.replays,
                "workers_lost": self.workers_lost,
                "worker_restarts": self.worker_restarts,
                "suspect_kills": self.suspect_kills,
                "identity_ok": self.identity_ok(),
                "journal": self.journal.stats(),
            }
        return report

    def healthz_text(self, report: Optional[dict] = None) -> str:
        s = report if report is not None else self.healthz()
        lines = [
            f"[healthz] {s['verdict']} pool workers="
            f"{sum(1 for w in s['workers'] if w['alive'])}/"
            f"{len(s['workers'])} admitted={s['admitted']} "
            f"delivered={s['delivered']} failed={s['failed']} "
            f"rejected={sum(s['rejected'].values())} "
            f"pending={s['pending']} identity_ok={s['identity_ok']}",
            f"[healthz] faults workers_lost={s['workers_lost']} "
            f"replays={s['replays']} restarts={s['worker_restarts']} "
            f"suspect_kills={s['suspect_kills']}",
        ]
        for w in s["workers"]:
            lines.append(
                f"[healthz] worker {w['idx']} pid={w['pid']} "
                f"alive={w['alive']} restarts={w['restarts']} "
                f"inflight={w['inflight']} "
                f"verdict={w['worker_verdict']} "
                f"retraces={w['retraces_since_start']}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        alive = sum(1 for w in self._workers if w.alive)
        return (f"WorkerPool(workers={alive}/{len(self._workers)}, "
                f"admitted={self.admitted}, delivered={self.delivered}, "
                f"verdict={self.verdict()!r})")
