"""Fault-tolerant multi-geometry serving router of the port.

The port of :mod:`repro.launch.router`: the same admission, residency,
deadline, retry/degrade and prefill rules and the same jsonl / framed
wire format, over :class:`~repro_torch.launch.service.DPRTService`
routes on one ``device`` (default ``"cuda"``).

The paper's scalability claim is about fitting the transform to fixed
resources; a production serving tier has to make the same promise for
MANY transforms at once.  :class:`ServiceRouter` multiplexes requests
over a pool of :class:`~repro_torch.launch.service.DPRTService` instances --
one per ``(geometry, dtype, datapath)`` route -- under explicit,
bounded resource rules:

* **Bounded admission.**  A per-route queue cap and a global in-flight
  budget; exceeding either rejects with the typed
  :class:`~repro_torch.launch.errors.QueueFull` instead of queuing without
  bound.
* **Bounded residency.**  At most ``max_services`` routes stay live;
  creating one more retires the least-recently-used *idle* route and
  discards exactly the plans no surviving route shares
  (:func:`repro_torch.core.plan.plan_cache_discard`), which drops their
  appliers and executables in lockstep -- the process footprint is
  bounded by policy, not by traffic history.
* **Deadline/priority batching.**  Requests carry an optional
  ``deadline_s`` SLO and a ``priority`` (higher dispatches first).  The
  per-route batcher flushes a group early when the oldest deadline
  minus the route's smoothed execution time is about to pass, and a
  request whose deadline already passed at dispatch is rejected with
  :class:`~repro_torch.launch.errors.DeadlineExceeded` -- never served
  late,
  never left hanging.
* **Retry and degrade.**  Dispatch runs under a timeout; failures retry
  with exponential backoff, and when the primary executables are
  exhausted the route degrades to its service's fallback applier (the
  staged registry composition through the same hand-written kernels --
  bit-exact, just slower).  Only if THAT also fails does the caller see the raw error.
  Every degradation is counted and surfaced by :meth:`healthz`:
  ``OK`` (clean), ``WARN`` (degraded but every answer exact or typed),
  ``FAIL`` (dropped/incorrectly failed work).
* **Warm-pool prefill.**  :meth:`prefill` walks a geometry manifest and
  warms each route through the persistent AOT cache before traffic.
* **Drain on shutdown.**  :meth:`shutdown` cancels the batchers, lets
  in-flight dispatches finish, and rejects anything still queued with
  :class:`~repro_torch.launch.errors.ServiceShutdown` -- a future handed out
  by this router ALWAYS resolves.

:func:`serve_jsonl` is the transport front-end ``serve --mode service
--jsonl`` runs: newline-delimited JSON requests on stdin, responses
(with typed error codes) on stdout, ``healthz`` as an in-band op.
"""
from __future__ import annotations

import asyncio
import collections
import json
import os
import signal
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.dprt import as_dtype, dtype_name
from ..core.plan import plan_cache_discard, plan_cache_info
from ..kernels.tuning import router_warm_sizes
from .errors import (DeadlineExceeded, QueueFull, ServiceError,
                     ServiceShutdown)
from .service import (DPRTService, format_latency, latency_summary,
                      resolve_device)

__all__ = ["ServiceRouter", "serve_jsonl"]

#: slack reserved when flushing a batch against a request deadline, so
#: the dispatch-time expiry check sees the request strictly alive even
#: when the execution-time EWMA is still cold
_FLUSH_MARGIN_S = 2e-3


class _Routed:
    __slots__ = ("payload", "future", "t_enqueue", "deadline", "priority")

    def __init__(self, payload, future, t_enqueue, deadline, priority):
        self.payload = payload
        self.future = future
        self.t_enqueue = t_enqueue
        self.deadline = deadline
        self.priority = priority


class _Route:
    __slots__ = ("key", "service", "queue", "batcher", "ready", "warm_task",
                 "error", "seq", "exec_s", "inflight")

    def __init__(self, key, service):
        self.key = key
        self.service = service
        self.queue: Optional[asyncio.PriorityQueue] = None
        self.batcher: Optional[asyncio.Task] = None
        self.ready: Optional[asyncio.Event] = None
        self.warm_task: Optional[asyncio.Task] = None
        self.error: Optional[BaseException] = None
        self.seq = 0
        self.exec_s: Optional[float] = None   # EWMA of dispatch seconds
        self.inflight = 0

    @property
    def label(self) -> str:
        return self.service.fault_key

    def idle(self) -> bool:
        queued = self.queue is not None and not self.queue.empty()
        warming = self.ready is not None and not self.ready.is_set()
        return not queued and not warming and self.inflight == 0


class ServiceRouter:
    """Bounded, deadline-aware, degradable multi-geometry front-end.

    A *route spec* is ``{"n": 13}`` / ``{"shape": (13, 13)}`` plus
    optional ``dtype`` (default int32), ``datapath`` (default forward)
    and per-service knobs (``method``, ``conv_kernel``, ...); specs
    naming the same ``(shape, dtype, datapath)`` share one route.  SLO
    knobs: ``max_wait_us`` bounds coalescing latency, per-request
    ``deadline_s`` is the hard SLO, ``dispatch_timeout_s`` +
    ``max_retries``/``retry_backoff_s`` govern the retry ladder around
    one kernel dispatch.  Every route serves on ``device``.
    """

    def __init__(self, *, max_services: int = 8, queue_cap: int = 64,
                 max_inflight: int = 256, max_batch: int = 16,
                 max_wait_us: float = 2000.0,
                 dispatch_timeout_s: float = 60.0, max_retries: int = 2,
                 retry_backoff_s: float = 0.005,
                 aot_dir: Optional[str] = None, fallback: bool = True,
                 history: int = 65536, device="cuda"):
        if max_services < 1 or queue_cap < 1 or max_inflight < 1:
            raise ValueError("max_services, queue_cap and max_inflight "
                             "must all be >= 1")
        if max_retries < 0 or retry_backoff_s < 0 or dispatch_timeout_s <= 0:
            raise ValueError("retry/timeout knobs must be non-negative "
                             "(timeout > 0)")
        self.max_services = int(max_services)
        self.queue_cap = int(queue_cap)
        self.max_inflight = int(max_inflight)
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.aot_dir = aot_dir
        self.fallback = bool(fallback)
        self.device = resolve_device(device)

        self._routes: "collections.OrderedDict[tuple, _Route]" = \
            collections.OrderedDict()
        self._started = False
        self._closing = False
        self._dispatch_tasks: set = set()
        self._latencies = collections.deque(maxlen=int(history))

        # -- accounting: every admitted future ends in exactly one bin --
        self.admitted = 0
        self.delivered = 0
        self.failed = 0                 # raw (non-typed) future failures
        self.rejected_deadline = 0      # admitted, then DeadlineExceeded
        self.rejected_shutdown = 0      # admitted, then ServiceShutdown
        #: typed refusals at submit time (no future was created)
        self.rejected_admission: collections.Counter = collections.Counter()
        self._inflight = 0
        self.queue_depth_max = 0
        # -- degradations -------------------------------------------------
        self.retries = 0
        self.fallbacks = 0
        self.evictions = 0
        #: counters carried over from retired services
        self._retired = collections.Counter()

    # -- route specs -------------------------------------------------------
    @staticmethod
    def _normalize(spec) -> dict:
        if isinstance(spec, (int, np.integer)):
            spec = {"n": int(spec)}
        spec = dict(spec)
        if "shape" in spec:
            shape = tuple(int(s) for s in spec.pop("shape"))
        elif "n" in spec:
            n = int(spec.pop("n"))
            shape = (n, n)
        else:
            raise ValueError(f"route spec needs 'n' or 'shape': {spec}")
        dtype = as_dtype(spec.pop("dtype", "int32"))
        datapath = str(spec.pop("datapath", "forward"))
        return {"shape": shape, "dtype": dtype, "datapath": datapath,
                "extra": spec}

    @classmethod
    def route_key(cls, spec) -> Tuple[tuple, str, str]:
        norm = cls._normalize(spec)
        return (norm["shape"], dtype_name(norm["dtype"]), norm["datapath"])

    def _build_service(self, norm: dict) -> DPRTService:
        return DPRTService(
            norm["shape"], norm["dtype"], max_batch=self.max_batch,
            warm_sizes=router_warm_sizes(max(norm["shape"]), self.max_batch),
            max_wait_us=self.max_wait_us, datapath=norm["datapath"],
            aot_dir=self.aot_dir, fallback=self.fallback,
            device=self.device, **norm["extra"])

    def _ensure_route(self, spec) -> _Route:
        norm = self._normalize(spec)
        key = (norm["shape"], dtype_name(norm["dtype"]), norm["datapath"])
        route = self._routes.get(key)
        if route is not None:
            self._routes.move_to_end(key)     # LRU touch
            return route
        self._evict_for_capacity()
        route = _Route(key, self._build_service(norm))
        self._routes[key] = route
        if self._started:
            self._open_route(route)
        return route

    # -- backpressure ------------------------------------------------------
    #: fallback execution-time estimate for a route whose EWMA is cold
    _RETRY_AFTER_COLD_S = 0.05

    def _retry_after_s(self, route: Optional[_Route] = None) -> float:
        """The hint a :class:`QueueFull` rejection carries: estimated
        seconds until the congestion that refused this request drains
        -- queue depth in batches x the route's smoothed execution
        time.  With no route (router-wide budget exhausted), the
        worst live route stands in."""
        if route is not None:
            depth = route.inflight
            if route.queue is not None:
                depth += route.queue.qsize()
            per = route.exec_s or self._RETRY_AFTER_COLD_S
        else:
            depth = self._inflight
            per = max((r.exec_s for r in self._routes.values()
                       if r.exec_s is not None),
                      default=self._RETRY_AFTER_COLD_S)
        batches = depth // max(1, self.max_batch) + 1
        return round(batches * per, 6)

    # -- bounded residency -------------------------------------------------
    def _evict_for_capacity(self) -> None:
        while len(self._routes) >= self.max_services:
            victim = next((r for r in self._routes.values() if r.idle()),
                          None)
            if victim is None:
                self.rejected_admission["queue_full"] += 1
                raise QueueFull(
                    f"router at max_services={self.max_services} with "
                    "every route busy",
                    retry_after_s=self._retry_after_s())
            self._retire(victim)

    def _retire(self, route: _Route) -> None:
        """Retire one idle route: stop its batcher, fold its counters,
        and discard exactly the plans no surviving route shares -- the
        plan-cache evict hooks then drop the appliers and executables in
        lockstep."""
        del self._routes[route.key]
        if route.batcher is not None:
            route.batcher.cancel()
            route.batcher = None
        route.queue = None
        svc = route.service
        self._retired["requests"] += svc._requests_done
        self._retired["failures"] += svc._failures
        self._retired["fallback_uses"] += svc._fallback_uses
        if svc.persistent is not None:
            p = svc.persistent.stats()
            for k in self._PERSISTENT_KEYS:
                self._retired[f"persistent_{k}"] += p[k]
        live: set = set()
        for other in self._routes.values():
            live |= other.service.plans()
        plan_cache_discard(svc.plans() - live)
        self.evictions += 1

    # -- warm-pool prefill -------------------------------------------------
    def prefill(self, manifest: Sequence) -> list:
        """Warm one route per manifest entry (spec dicts), through the
        persistent AOT cache when ``aot_dir`` is set -- the boot path
        that makes first traffic hit compiled executables.  Callable
        before :meth:`start` (synchronous warmup) or after (blocks the
        caller, not the loop).  Returns per-route warmup info."""
        infos = []
        for spec in manifest:
            route = self._ensure_route(spec)
            if not route.service.warmed:
                infos.append(route.service.warmup())
            if route.ready is not None and route.service.warmed:
                route.ready.set()
        return infos

    # -- loop lifecycle ----------------------------------------------------
    async def start(self) -> None:
        """Bind to the running event loop: create queues + batchers for
        every existing route (idempotent)."""
        if self._started:
            return
        self._closing = False
        for route in self._routes.values():
            self._open_route(route)
        self._started = True

    def _open_route(self, route: _Route) -> None:
        route.queue = asyncio.PriorityQueue()
        route.ready = asyncio.Event()
        if route.service.warmed:
            route.ready.set()
        else:
            route.warm_task = asyncio.create_task(self._warm(route))
        route.batcher = asyncio.create_task(self._route_batcher(route))

    async def _warm(self, route: _Route) -> None:
        try:
            await asyncio.to_thread(route.service.warmup)
        except Exception as e:        # warmup failure: the route is dead,
            route.error = e           # its requests fail typed-raw below
        finally:
            route.ready.set()

    async def shutdown(self) -> None:
        """Drain on shutdown: stop the batchers, let in-flight
        dispatches finish, reject everything still queued with the
        typed :class:`ServiceShutdown`.  The router object stays warm
        (routes and executables survive) for the next :meth:`start`."""
        if not self._started:
            return
        self._closing = True
        for route in self._routes.values():
            if route.batcher is not None:
                route.batcher.cancel()
        for route in self._routes.values():
            if route.batcher is not None:
                try:
                    await route.batcher
                except asyncio.CancelledError:
                    pass
                route.batcher = None
            if route.warm_task is not None:
                try:
                    await route.warm_task
                except asyncio.CancelledError:
                    pass
                route.warm_task = None
        if self._dispatch_tasks:
            await asyncio.gather(*list(self._dispatch_tasks),
                                 return_exceptions=True)
        for route in self._routes.values():
            self._reject_queued(route)
            route.queue = None
            route.ready = None
        self._started = False
        self._closing = False

    def _reject_requests(self, route: _Route, requests) -> None:
        for r in requests:
            if not r.future.done():
                r.future.set_exception(ServiceShutdown(
                    f"router shut down with the request for "
                    f"{route.label} still queued"))
                self.rejected_shutdown += 1

    def _reject_queued(self, route: _Route) -> None:
        if route.queue is None:
            return
        while True:
            try:
                _, _, r = route.queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            self._reject_requests(route, (r,))

    # -- admission ---------------------------------------------------------
    def submit_nowait(self, spec, payload, *, deadline_s: Optional[float]
                      = None, priority: int = 0) -> asyncio.Future:
        """Admit one request (must run on the loop :meth:`start` ran
        on); returns the future of its result.  Raises the typed
        :class:`QueueFull` / :class:`DeadlineExceeded` /
        :class:`ServiceShutdown` instead of queuing work it cannot
        honor."""
        if not self._started or self._closing:
            raise ServiceShutdown("router is not running")
        route = self._ensure_route(spec)
        svc = route.service
        payload = np.asarray(payload)
        if payload.shape != svc.request_shape:
            raise ValueError(f"request shape {payload.shape} != route "
                             f"{route.label} contract {svc.request_shape}")
        if payload.dtype != svc.request_np_dtype:
            raise ValueError(f"request dtype {payload.dtype} != route "
                             f"{route.label} contract "
                             f"{svc.request_np_dtype.name}")
        if self._inflight >= self.max_inflight:
            self.rejected_admission["queue_full"] += 1
            raise QueueFull(f"global in-flight budget "
                            f"{self.max_inflight} exhausted",
                            retry_after_s=self._retry_after_s())
        if route.queue.qsize() >= self.queue_cap:
            self.rejected_admission["queue_full"] += 1
            raise QueueFull(f"queue for {route.label} at cap "
                            f"{self.queue_cap}",
                            retry_after_s=self._retry_after_s(route))
        loop = asyncio.get_running_loop()
        now = loop.time()
        deadline = None
        if deadline_s is not None:
            if deadline_s <= 0:
                self.rejected_admission["deadline_exceeded"] += 1
                raise DeadlineExceeded(
                    f"deadline_s={deadline_s} already passed at admission")
            deadline = now + float(deadline_s)
        fut = loop.create_future()
        self.admitted += 1
        self._inflight += 1
        fut.add_done_callback(self._dec_inflight)
        route.seq += 1
        route.queue.put_nowait((-int(priority), route.seq,
                                _Routed(payload, fut, now, deadline,
                                        priority)))
        self.queue_depth_max = max(self.queue_depth_max,
                                   route.queue.qsize())
        return fut

    def _dec_inflight(self, _fut) -> None:
        self._inflight -= 1

    async def submit(self, spec, payload, *, deadline_s: Optional[float]
                     = None, priority: int = 0) -> np.ndarray:
        """Admit one request and await its result."""
        await self.start()
        return await self.submit_nowait(spec, payload,
                                        deadline_s=deadline_s,
                                        priority=priority)

    # -- batching / dispatch -----------------------------------------------
    async def _route_batcher(self, route: _Route) -> None:
        await route.ready.wait()
        if route.error is not None:   # dead route: fail traffic fast
            while True:
                _, _, r = await route.queue.get()
                if not r.future.done():
                    self.failed += 1
                    r.future.set_exception(route.error)
        while True:
            _, _, first = await route.queue.get()
            # account for the forming batch immediately: requests pulled
            # off the queue must keep the route non-idle (and safe from
            # LRU eviction) while _collect awaits stragglers
            route.inflight += 1
            batch = [first]
            try:
                await self._collect(route, batch)
            except asyncio.CancelledError:
                # shutdown/retirement landed while the batch was still
                # forming: these requests left the queue, so the
                # queue-drain rejection cannot reach them -- reject
                # typed here, a future must ALWAYS resolve
                self._reject_requests(route, batch)
                route.inflight -= len(batch)
                raise
            except Exception:   # batcher bug: don't strand the batch
                self._reject_requests(route, batch)
                route.inflight -= len(batch)
                raise
            task = asyncio.create_task(self._dispatch(route, batch))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)

    async def _collect(self, route: _Route, batch: list) -> list:
        """Coalesce up to the route's max batch, bounded by
        ``max_wait_us`` AND by the tightest admitted deadline: the
        group flushes early when the oldest request's slack (deadline
        minus the route's smoothed execution time) is about to run
        out."""
        loop = asyncio.get_running_loop()
        cap = route.service.max_batch
        admission_deadline = loop.time() + self.max_wait_us * 1e-6
        while len(batch) < cap:
            try:
                batch.append(route.queue.get_nowait()[2])
                route.inflight += 1
                continue
            except asyncio.QueueEmpty:
                pass
            now = loop.time()
            wait = admission_deadline - now
            # flush with a safety margin beyond the smoothed execution
            # time: with a cold EWMA (est == 0) the group would
            # otherwise flush exactly AT the deadline and arrive at
            # dispatch already expired
            est = (route.exec_s or 0.0) + _FLUSH_MARGIN_S
            for r in batch:
                if r.deadline is not None:
                    wait = min(wait, r.deadline - est - now)
            if wait <= 0:
                break
            try:
                batch.append(
                    (await asyncio.wait_for(route.queue.get(), wait))[2])
                route.inflight += 1
            except asyncio.TimeoutError:
                break
        return batch

    async def _dispatch(self, route: _Route, batch: list) -> None:
        loop = asyncio.get_running_loop()
        try:
            now = loop.time()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    # reject-not-hang: serving it late helps nobody and
                    # steals batch slots from requests that can still
                    # make their SLO
                    if not r.future.done():
                        self.rejected_deadline += 1
                        r.future.set_exception(DeadlineExceeded(
                            f"request for {route.label} missed its "
                            f"deadline before dispatch"))
                else:
                    live.append(r)
            if not live:
                return
            stack = np.stack([r.payload for r in live])
            out = await self._execute(route, stack)
            now = loop.time()
            for i, r in enumerate(live):
                if not r.future.done():
                    self._latencies.append(now - r.t_enqueue)
                    self.delivered += 1
                    r.future.set_result(out[i])
        except Exception as e:
            for r in batch:
                if not r.future.done():
                    self.failed += 1
                    r.future.set_exception(e)
        finally:
            route.inflight -= len(batch)

    async def _execute(self, route: _Route, stack: np.ndarray) -> np.ndarray:
        """One admitted stack through the primary executables with
        timeout + retry/backoff; exhausted retries degrade to the
        route's bit-exact fallback applier (which runs only then)."""
        delay = self.retry_backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                out = await asyncio.wait_for(
                    asyncio.to_thread(route.service.execute, stack),
                    self.dispatch_timeout_s)
                dt = time.perf_counter() - t0
                route.exec_s = (dt if route.exec_s is None
                                else 0.7 * route.exec_s + 0.3 * dt)
                return out
            except (Exception, asyncio.TimeoutError) as e:
                last = e
            if attempt < self.max_retries:
                self.retries += 1
                await asyncio.sleep(delay)
                delay *= 2
        self.fallbacks += 1
        try:
            return await asyncio.wait_for(
                asyncio.to_thread(route.service.execute_fallback, stack),
                self.dispatch_timeout_s)
        except (Exception, asyncio.TimeoutError) as e:
            raise e from last

    # -- synchronous driver ------------------------------------------------
    def run_requests(self, requests: Sequence, arrival_us: float = 0.0,
                     repeats: int = 1) -> list:
        """Serve ``requests`` -- ``(spec, payload)`` or ``(spec,
        payload, kwargs)`` tuples -- as concurrent routed traffic and
        return per-request results in order; a typed rejection comes
        back as the exception instance, not a raise.  ``repeats``
        replays the traffic on one loop (per-pass wall seconds land in
        ``self.last_pass_walls``)."""
        reqs = [(r if len(r) == 3 else (r[0], r[1], {})) for r in requests]

        async def driver():
            await self.start()

            async def one(i, spec, payload, kw):
                if arrival_us > 0:
                    await asyncio.sleep(i * arrival_us * 1e-6)
                try:
                    fut = self.submit_nowait(spec, payload, **kw)
                except ServiceError as e:
                    return e
                try:
                    return await fut
                except (ServiceError, Exception) as e:
                    return e

            walls, results = [], None
            try:
                for _ in range(max(1, repeats)):
                    t0 = time.perf_counter()
                    results = await asyncio.gather(
                        *(one(i, s, p, kw)
                          for i, (s, p, kw) in enumerate(reqs)))
                    walls.append(time.perf_counter() - t0)
            finally:
                await self.shutdown()
            return results, walls

        results, walls = asyncio.run(driver())
        self.last_pass_walls = walls
        return results

    # -- observability -----------------------------------------------------
    def pending(self) -> int:
        """Admitted futures not yet resolved (0 after shutdown, always:
        the drop-a-future count the chaos suite asserts on)."""
        return self._inflight

    def degraded_compiles(self) -> int:
        total = int(self._retired["persistent_degraded_compiles"])
        for route in self._routes.values():
            if route.service.persistent is not None:
                total += route.service.persistent.degraded_compiles
        return total

    _PERSISTENT_KEYS = ("hits", "misses", "errors", "degraded_compiles",
                        "lock_steals", "lock_degraded")

    def persistent_stats(self) -> Dict[str, int]:
        """Aggregated persistent-AOT-cache counters across every route
        (live and retired) -- what a pool worker reports in its healthz
        reply, and what the cross-process coalescing assertion sums:
        total ``misses`` over all workers must equal the number of
        distinct blobs on disk."""
        out = {k: int(self._retired[f"persistent_{k}"])
               for k in self._PERSISTENT_KEYS}
        for route in self._routes.values():
            p = route.service.persistent
            if p is not None:
                s = p.stats()
                for k in self._PERSISTENT_KEYS:
                    out[k] += int(s[k])
        return out

    def stats(self) -> Dict[str, object]:
        rejected = {
            "deadline_exceeded": self.rejected_deadline
            + self.rejected_admission["deadline_exceeded"],
            "queue_full": int(self.rejected_admission["queue_full"]),
            "shutdown": self.rejected_shutdown
            + self.rejected_admission["shutdown"],
        }
        fallback_uses = int(self._retired["fallback_uses"]) + sum(
            r.service._fallback_uses for r in self._routes.values())
        return {
            "verdict": self.verdict(),
            "routes": {r.label: {
                "queue": r.queue.qsize() if r.queue is not None else 0,
                "inflight": r.inflight,
                "warmed": r.service.warmed,
                "requests": r.service._requests_done,
                "exec_ms": (None if r.exec_s is None
                            else 1e3 * r.exec_s),
                "warm_sizes": r.service.sizes,
            } for r in self._routes.values()},
            "max_services": self.max_services,
            "queue_cap": self.queue_cap,
            "max_inflight": self.max_inflight,
            "admitted": self.admitted,
            "delivered": self.delivered,
            "failed": self.failed,
            "pending": self.pending(),
            "rejected": rejected,
            "retries": self.retries,
            "fallbacks": self.fallbacks,
            "fallback_uses": fallback_uses,
            "evictions": self.evictions,
            "degraded_compiles": self.degraded_compiles(),
            "queue_depth_max": self.queue_depth_max,
            "latency": latency_summary(self._latencies),
            "plan_cache": plan_cache_info()._asdict(),
        }

    def verdict(self) -> str:
        """``FAIL``: work was dropped or failed raw (wrongness).
        ``WARN``: every answer was exact or a typed rejection, but a
        degradation happened (retry, fallback, degraded compile,
        rejection, eviction).  ``OK``: clean."""
        if self.failed > 0:
            return "FAIL"
        if not self._started and self.pending() > 0:
            return "FAIL"              # a shut-down router owes nothing
        degradations = (
            self.retries + self.fallbacks + self.evictions
            + self.rejected_deadline + self.rejected_shutdown
            + sum(self.rejected_admission.values())
            + self.degraded_compiles())
        return "WARN" if degradations else "OK"

    def healthz(self) -> str:
        """The routed ``/healthz`` report: one verdict line, the
        degradation ledger, per-route lines, latency + plan-cache."""
        s = self.stats()
        rej = s["rejected"]
        lines = [
            f"[healthz] {s['verdict']} router "
            f"routes={len(s['routes'])}/{s['max_services']} "
            f"admitted={s['admitted']} delivered={s['delivered']} "
            f"failed={s['failed']} pending={s['pending']}",
            f"[healthz] rejected deadline={rej['deadline_exceeded']} "
            f"queue_full={rej['queue_full']} shutdown={rej['shutdown']} "
            f"(queue_cap={s['queue_cap']} "
            f"max_inflight={s['max_inflight']})",
            f"[healthz] degraded retries={s['retries']} "
            f"fallbacks={s['fallbacks']} "
            f"fallback_uses={s['fallback_uses']} "
            f"evictions={s['evictions']} "
            f"degraded_compiles={s['degraded_compiles']}",
        ]
        for label, r in s["routes"].items():
            exec_ms = ("-" if r["exec_ms"] is None
                       else f"{r['exec_ms']:.2f}ms")
            lines.append(
                f"[healthz] route {label} warmed={r['warmed']} "
                f"queue={r['queue']} inflight={r['inflight']} "
                f"requests={r['requests']} exec={exec_ms} "
                f"warm_sizes={tuple(r['warm_sizes'])}")
        lines.append("[healthz] " + format_latency(s["latency"]))
        lines.append(
            "[healthz] plan_cache hits={hits} misses={misses} "
            "currsize={currsize} evictions={evictions}".format(
                **s["plan_cache"]))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"ServiceRouter(routes={len(self._routes)}/"
                f"{self.max_services}, admitted={self.admitted}, "
                f"verdict={self.verdict()!r})")


# ---------------------------------------------------------------------------
# stdin-jsonl transport front-end
# ---------------------------------------------------------------------------
def serve_jsonl(router: ServiceRouter, infile, outfile, *,
                framed: bool = False, sigterm_drain: bool = False) -> None:
    """Newline-delimited JSON worker over ``router.submit()``.

    Requests: ``{"op": "submit", "id": …, "n"/"shape": …, ["dtype": …,]
    ["datapath": …,] "data": nested-list, ["deadline_ms": …,]
    ["priority": …]}`` -- plus ``{"op": "healthz"}`` and
    ``{"op": "shutdown"}``.  Responses carry ``"ok": true`` with
    ``"data"``, or ``"ok": false`` with the typed ``"error"`` code (and
    its ``retry_after_s`` backpressure hint when set) -- a malformed
    line is answered, never fatal.  EOF drains and shuts the router
    down (queued work rejected typed, like any shutdown).

    ``framed=True`` switches both directions to the length-prefixed
    frames of :mod:`repro_torch.launch.pool` -- the supervisor's wire format,
    where a SIGKILL mid-write must read as truncation, not as a mangled
    message.  ``sigterm_drain=True`` installs a SIGTERM handler that
    drains instead of dying mid-batch: stop reading stdin, flush every
    in-flight request, emit one final unsolicited healthz frame
    (``"id": "__drain__"``), then return.
    """
    from ..radon import trace_count
    from .pool import read_frame, write_frame

    def reply(obj: dict) -> None:
        if framed:
            write_frame(outfile, obj)
        else:
            outfile.write(json.dumps(obj) + "\n")
            outfile.flush()

    def error_payload(rid, e: ServiceError) -> dict:
        obj = {"id": rid, "ok": False, "error": e.code, "msg": str(e)}
        if e.retry_after_s is not None:
            obj["retry_after_s"] = e.retry_after_s
        return obj

    def healthz_payload(rid, trace_baseline: int, *,
                        final: bool = False) -> dict:
        s = router.stats()
        obj = {"id": rid, "ok": True, "verdict": s["verdict"],
               "pid": os.getpid(),
               "stats": {"admitted": s["admitted"],
                         "delivered": s["delivered"],
                         "failed": s["failed"],
                         "rejected": sum(s["rejected"].values()),
                         "pending": s["pending"]},
               # steady-state build count: builds SINCE the worker
               # finished its prefill (warmup itself legitimately
               # builds) -- the pool's "warm, zero retraces" assertion
               "retraces_since_start": trace_count() - trace_baseline,
               "persistent": router.persistent_stats(),
               "faults_env": os.environ.get("REPRO_FAULTS") or None,
               "healthz": router.healthz()}
        if final:
            obj["final"] = True
        return obj

    async def answer(rid, fut) -> None:
        try:
            out = await fut
            reply({"id": rid, "ok": True, "data": np.asarray(out).tolist()})
        except ServiceError as e:
            reply(error_payload(rid, e))
        except Exception as e:                    # raw failure: surfaced
            reply({"id": rid, "ok": False, "error": "internal",
                   "msg": str(e)})

    async def main() -> None:
        await router.start()
        trace_baseline = trace_count()
        answers: set = set()
        loop = asyncio.get_running_loop()
        inq: asyncio.Queue = asyncio.Queue()
        drained_by_sigterm = False

        def pump() -> None:
            # a daemon thread owns the blocking reads: asyncio.run
            # would join a to_thread readline forever on drain, and a
            # signal can't interrupt it -- a daemon thread it simply
            # abandons.  The sentinel None is EOF (or torn frame).
            try:
                while True:
                    if framed:
                        msg = read_frame(infile)
                        if msg is None:
                            break
                    else:
                        line = infile.readline()
                        if not line:
                            break
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            msg = json.loads(line)
                        except ValueError:
                            msg = {"op": "__bad_json__"}
                    loop.call_soon_threadsafe(inq.put_nowait, msg)
            except Exception:
                pass                   # corrupt stream reads as EOF
            try:
                loop.call_soon_threadsafe(inq.put_nowait, None)
            except RuntimeError:
                pass                   # loop already gone

        def on_sigterm() -> None:
            nonlocal drained_by_sigterm
            drained_by_sigterm = True
            inq.put_nowait(None)       # stop consuming stdin, drain

        if sigterm_drain:
            loop.add_signal_handler(signal.SIGTERM, on_sigterm)
        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        try:
            while True:
                msg = await inq.get()
                if msg is None:
                    break
                rid = msg.get("id")
                op = msg.get("op", "submit")
                if op == "__bad_json__":
                    reply({"ok": False, "error": "bad_json"})
                elif op == "healthz":
                    reply(healthz_payload(rid, trace_baseline))
                elif op == "shutdown":
                    reply({"id": rid, "ok": True, "shutdown": True})
                    break
                elif op == "submit":
                    try:
                        spec = {k: msg[k] for k in
                                ("n", "shape", "dtype", "datapath")
                                if k in msg}
                        # the per-request dtype contract is the ROUTE's
                        # (inverse/solve consume accumulator-dtype
                        # projections, not images)
                        route = router._ensure_route(spec)
                        payload = np.asarray(
                            msg["data"],
                            dtype=route.service.request_np_dtype)
                        deadline_ms = msg.get("deadline_ms")
                        fut = router.submit_nowait(
                            spec, payload,
                            deadline_s=(None if deadline_ms is None
                                        else float(deadline_ms) * 1e-3),
                            priority=int(msg.get("priority", 0)))
                    except ServiceError as e:
                        reply(error_payload(rid, e))
                    except (KeyError, TypeError, ValueError) as e:
                        reply({"id": rid, "ok": False,
                               "error": "bad_request", "msg": str(e)})
                    else:
                        t = asyncio.create_task(answer(rid, fut))
                        answers.add(t)
                        t.add_done_callback(answers.discard)
                else:
                    reply({"id": rid, "ok": False, "error": "bad_request",
                           "msg": f"unknown op {op!r}"})
            if answers:
                await asyncio.gather(*answers, return_exceptions=True)
            await router.shutdown()
            if drained_by_sigterm:
                reply(healthz_payload("__drain__", trace_baseline,
                                      final=True))
        finally:
            if sigterm_drain:
                loop.remove_signal_handler(signal.SIGTERM)

    asyncio.run(main())
