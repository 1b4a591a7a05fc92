"""Async dynamic-batching DPRT service tier of the port.

The port of :mod:`repro.launch.service`.  A synchronous per-request
entry point pays one kernel launch per image; this module is the
front-end that coalesces concurrent single-image traffic into the
batched kernels:

* **Admission queue.**  Concurrent single-image requests land on an
  ``asyncio`` queue; the batcher coalesces up to ``max_batch`` of them,
  waiting at most ``max_wait_us`` after the first arrival, then drains
  whatever else is already queued for free.
* **Warm-size padding.**  A coalesced group is padded with zero images
  up to the nearest *warm batch size*
  (:func:`repro_torch.kernels.tuning.warm_batch_sizes`), so every
  admitted group hits one of a small set of executables built at
  warmup -- nothing is built at serving time.  Results are sliced back
  per request.
* **One copy each way.**  :meth:`DPRTService.execute` copies the padded
  stack to the card once, runs the executable chain there (``roundtrip``
  runs K1 forward then K1 inverse with no host copy between them) and
  copies the result back once; each response is a numpy view of that
  one host array.
* **Persistent AOT cache.**  :meth:`DPRTService.warmup` gets the
  warm-size executables through a
  :class:`repro_torch.radon.PersistentAOTCache` when ``aot_dir`` is set:
  exported executables -- the nvcc libraries their routes launch,
  around the resolved plan -- stored through the
  :mod:`repro_torch.checkpoint.store` blob machinery, so a restarted
  process installs the libraries instead of running nvcc.
* **Observability.**  Per-request latency histograms (p50/p95/p99),
  batch-occupancy and queue-depth gauges, plan-cache / build-counter /
  AOT-cache introspection -- all surfaced by
  :meth:`DPRTService.healthz`.

The service runs on ``device`` (default ``"cuda"``, which raises when
there is no card; ``"cpu"`` runs the kernels' plain versions).  Batches
execute on ``asyncio.to_thread`` worker threads, each entering its card
(``torch.cuda.device``).

**On a mesh** (``mesh=`` a DeviceMesh over every rank of the process
group) each rank is a process, and a sharded operator is a collective
call, so every rank must run the same batches, of the same padded
sizes, in the same order.  Every rank builds the service and calls
:meth:`warmup` (each warm size's executables are built once on every
rank).  The mesh's first rank, the *leader*, then runs the batcher and
answers requests; every other rank calls :meth:`follow`.  For each batch
the leader broadcasts a header (execute, fallback or stop; padded size;
sequence number), then the stack; every rank runs it, and the ranks
agree on the batch's outcome (one ``all_reduce``) before the leader
replies, so a rank that failed makes the leader's ``execute`` raise and
no rank is left inside a collective.  The output is assembled on the
leader.  :meth:`close` on the leader sends stop and sums the builds
every rank made after warmup.

The latency summary/formatting helpers here are shared with the
``serve --mode radon`` timing loop, so every serving surface reports the
same percentile statistics.
"""
from __future__ import annotations

import asyncio
import collections
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import radon
from ..core.dprt import as_dtype, dtype_name
from ..core.plan import get_plan, plan_cache_entries, plan_cache_info
from ..kernels.tuning import nearest_warm_batch, warm_batch_sizes
from ..radon.operators import _on_device
from .errors import ServiceShutdown
from .faults import perturb

__all__ = ["DPRTService", "latency_summary", "format_latency",
           "percentile", "resolve_device"]


def resolve_device(name) -> torch.device:
    """The device to serve on; a CUDA device that is not there raises
    (the service never carries on on the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name}: no CUDA device is available (the cpu device "
            f"runs the kernels' plain versions: --device cpu)")
    return device


# ---------------------------------------------------------------------------
# latency statistics (shared: service healthz, serve --mode radon)
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# the ranks of a mesh service
# ---------------------------------------------------------------------------
_STOP, _EXECUTE, _FALLBACK = 0, 1, 2


class _RankLink:
    """The leader's and the followers' halves of a mesh service's
    batches, over the default process group (which the mesh spans).

    One *turn* per batch: the leader broadcasts ``[kind, batch, seq]``
    and then the stack; every rank computes; :meth:`agree` all-reduces
    each rank's success.  Turns are serialized by a lock on the leader
    (the batcher dispatches from several threads), so the followers see
    them in the leader's order."""

    def __init__(self, mesh, device: torch.device):
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(
                f"a mesh service's mesh must span every rank of the "
                f"process group: {mesh.mesh.numel()} of "
                f"{dist.get_world_size()}")
        self.device = device
        self.src = int(mesh.mesh.flatten()[0])
        self.leader = dist.get_rank() == self.src
        self.lock = threading.Lock()
        self.turns = 0

    def send(self, kind: int, batch: int = 0) -> None:
        """Leader: the header of the next turn."""
        dist.broadcast(torch.tensor([kind, batch, self.turns],
                                    dtype=torch.int64, device=self.device),
                       self.src)

    def recv(self) -> Tuple[int, int, int]:
        """Follower: the next header, ``(kind, batch, seq)``."""
        head = torch.empty(3, dtype=torch.int64, device=self.device)
        dist.broadcast(head, self.src)
        return tuple(head.tolist())

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """The turn's stack: the leader's ``x``, received in place on a
        follower."""
        dist.broadcast(x, self.src)
        return x

    def agree(self, ok: bool) -> bool:
        """Every rank's outcome of the turn: True when all succeeded."""
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        self.turns += 1
        return bool(flag.item())

    def total(self, count: int) -> int:
        """``count`` summed over the ranks."""
        t = torch.tensor([count], dtype=torch.int64, device=self.device)
        dist.all_reduce(t)
        return int(t.item())


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
class _Request:
    __slots__ = ("img", "future", "t_enqueue")

    def __init__(self, img, future, t_enqueue):
        self.img = img
        self.future = future
        self.t_enqueue = t_enqueue


class DPRTService:
    """Dynamic-batching front-end over the batched DPRT kernels.

    ``DPRTService((H, W), dtype)`` builds one operator chain per warm
    batch size (``warm_batch_sizes(max_batch)``); :meth:`warmup`
    compiles them on ``device`` (optionally through a persistent on-disk
    cache);
    :meth:`submit` is the async per-request entry point and
    :meth:`run_requests` the synchronous driver benchmarks and the CLI
    use.  ``datapath`` selects what a request computes:

    * ``"forward"``  -- image in, ``(P+1, P)`` projections out (the
      paper's coprocessor service pattern);
    * ``"inverse"``  -- projections in, reconstructed image out;
    * ``"roundtrip"`` -- image in, forward+inverse chained executables
      (K1 forward, then K1 inverse on the device), image out;
    * ``"conv"``     -- image in, fused projection-domain convolution
      against a fixed ``conv_kernel`` (one K2 launch per batch), image
      out;
    * ``"solve"``    -- (masked/weighted) projections in, least-squares
      reconstruction out via :func:`repro_torch.radon.solve_operator`
      (``solve_mask``/``solve_weight`` fix the projection-domain
      diagonal, ``solver``/``solve_tol``/``solve_maxiter`` the solver;
      the unmasked default serves the non-iterative Sherman-Morrison
      closed form).

    Transform knobs (``method``, ``strip_rows``, ``m_block``,
    ``stream_rows``, ``mesh``, ...) pass through to the operators
    unchanged; with ``mesh`` the leader rank serves and the others
    :meth:`follow` (module docstring).  The object is reusable across
    event loops: queue and batcher task are created per run, metrics
    accumulate on the object.
    Requests and responses are numpy arrays; ``device`` is where the
    kernels run (``"cuda"`` raises without a card).
    """

    def __init__(self, shape: Tuple[int, int], dtype=torch.int32, *,
                 max_batch: int = 16, max_wait_us: float = 2000.0,
                 warm_sizes: Optional[Sequence[int]] = None,
                 datapath: str = "forward", method: Optional[str] = None,
                 conv_kernel=None, solve_mask=None, solve_weight=None,
                 solver: str = "auto", solve_tol: float = 1e-6,
                 solve_maxiter: int = 50, aot_dir: Optional[str] = None,
                 fallback: bool = False, history: int = 65536,
                 device="cuda", **knobs):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError(f"service geometry must be (H, W), got {shape}")
        if datapath not in ("forward", "inverse", "roundtrip", "conv",
                            "solve"):
            raise ValueError(f"unknown datapath {datapath!r}")
        if (conv_kernel is None) != (datapath != "conv"):
            raise ValueError("conv_kernel is required for (exactly) the "
                             "'conv' datapath")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.shape = shape
        self.dtype = as_dtype(dtype)
        self.device = resolve_device(device)
        self.datapath = datapath
        self.max_wait_us = float(max_wait_us)
        if warm_sizes is not None:   # routed keys trim the ladder
            sizes = tuple(sorted({int(b) for b in warm_sizes}))
            if not sizes or sizes[0] < 1:
                raise ValueError(f"warm_sizes must be >= 1, got {warm_sizes}")
            self.sizes = sizes
        else:
            self.sizes = warm_batch_sizes(int(max_batch))
        self.max_batch = self.sizes[-1]
        #: stable identity at the fault seam and in typed rejections
        self.fault_key = (f"{shape[0]}x{shape[1]}/{dtype_name(self.dtype)}/"
                          f"{datapath}")
        self.persistent = (radon.PersistentAOTCache(aot_dir)
                           if aot_dir else None)
        self._want_fallback = bool(fallback)

        if conv_kernel is not None and not isinstance(conv_kernel,
                                                      torch.Tensor):
            conv_kernel = torch.as_tensor(np.asarray(conv_kernel))
        solve_mask, solve_weight = (
            None if t is None else torch.as_tensor(t).to(self.device)
            for t in (solve_mask, solve_weight))
        self._ops: Dict[int, tuple] = {}
        for b in self.sizes:
            bshape = (b,) + shape
            if datapath == "conv":
                stages = (radon.Conv2D(bshape, conv_kernel, self.dtype,
                                       method, **knobs),)
            elif datapath == "solve":
                stages = (radon.solve_operator(
                    bshape, self.dtype, mask=solve_mask,
                    weight=solve_weight, solver=solver, tol=solve_tol,
                    maxiter=solve_maxiter, method=method,
                    device=self.device, **knobs),)
            else:
                fwd = radon.DPRT(bshape, self.dtype, method, **knobs)
                stages = {"forward": (fwd,),
                          "inverse": (fwd.inverse,),
                          "roundtrip": (fwd, fwd.inverse)}[datapath]
            self._ops[b] = stages
        first = self._ops[self.sizes[0]][0]
        #: per-request input contract (leading batch dim stripped)
        self.request_shape = tuple(first.shape_in[1:])
        self.request_dtype = first.dtype_in
        #: the numpy dtype requests must carry
        self.request_np_dtype = np.dtype(dtype_name(first.dtype_in))
        self._exes: Dict[int, tuple] = {}
        mesh = knobs.get("mesh")
        self._link = (None if mesh is None
                      else _RankLink(mesh, self.device))
        self._closed = False

        # -- degraded path -------------------------------------------------
        self._fallback = None          # the staged/registry applier
        self._fallback_warmed = False

        # -- metrics ------------------------------------------------------
        self._metrics_lock = threading.Lock()   # execute() runs on threads
        self._latencies = collections.deque(maxlen=int(history))
        self._batch_sizes = collections.Counter()  # admitted (pre-pad) size
        self._requests_done = 0
        self._batches = 0
        self._padded_slots = 0
        self._occupancy_sum = 0.0
        self._queue_depth_max = 0
        self._failures = 0
        self._fallback_uses = 0
        self._rejected_shutdown = 0
        self._compute_s = 0.0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._traces_after_warmup: Optional[int] = None

        # -- per-run asyncio state ----------------------------------------
        self._queue: Optional[asyncio.Queue] = None
        self._batcher: Optional[asyncio.Task] = None
        self._pending: set = set()

    # -- compilation / persistent cache ------------------------------------
    def warmup(self) -> Dict[str, object]:
        """Build every warm-size executable on the service's device --
        from the persistent cache when one is configured (restart path:
        the blobs' libraries are installed, no nvcc), compiling and
        persisting otherwise.  Returns timing + cache counters; after
        warmup the steady state must build nothing (no plan, applier or
        nvcc build: :meth:`steady_state_retraces` reads 0)."""
        t0 = time.perf_counter()
        for b, stages in self._ops.items():
            if b in self._exes:
                continue
            self._exes[b] = tuple(
                (self.persistent.get_or_compile(op, self.device)
                 if self.persistent else op.compile(self.device))
                for op in stages)
        if self._want_fallback:      # degraded path builds at warmup, so
            self.prepare_fallback()  # an incident never pays for it
        dt = time.perf_counter() - t0
        self._traces_after_warmup = radon.trace_count()
        info: Dict[str, object] = {
            "warmup_s": dt,
            "executables": sum(len(v) for v in self._exes.values()),
            "warm_sizes": self.sizes,
        }
        if self.persistent is not None:
            info["persistent"] = self.persistent.stats()
        return info

    @property
    def warmed(self) -> bool:
        """True once :meth:`warmup` has built the executables."""
        return bool(self._exes)

    def plans(self) -> set:
        """Every :class:`RadonPlan` the operator stages reference.
        Plans are SHARED across services of one geometry (forward and
        roundtrip reuse the same cached plan), so the router's targeted
        eviction discards only plans no surviving route still holds."""
        out = set()
        for stages in self._ops.values():
            for op in stages:
                plan = getattr(op, "plan", None)
                if plan is not None:
                    out.add(plan)
        return out

    # -- degraded path -----------------------------------------------------
    def prepare_fallback(self) -> None:
        """Build and warm the degraded-path applier: the registry (for
        conv: the staged) composition on the service's device, through
        the hand-written kernels and not the executables -- the
        bit-exact alternative :meth:`execute_fallback` serves when the
        primary executables fail.  Warmed at the LARGEST warm size only
        (padding absorbs the rest).  Idempotent; ran from :meth:`warmup`
        when the service was built with ``fallback=True``."""
        if self._fallback is None:
            self._fallback = self._build_fallback()
        if not self._fallback_warmed:
            self._run_fallback(np.zeros(
                (self.max_batch,) + self.request_shape,
                self.request_np_dtype))
            self._fallback_warmed = True

    def _build_fallback(self):
        ops = self._ops[self.max_batch]
        if self.datapath == "conv":
            op = ops[0]
            plan, kernel = op.plan, op.kernel.to(self.device)
            if not plan.geometry.native:
                # non-native conv is already the staged folded
                # composition: run the operator itself
                return op
            # native conv: the explicit STAGED composition -- K1 forward
            # of the image and of the kernel, the exact 1-D convolution
            # of core/conv.py, K1 inverse -- the registry path a
            # fused-pipeline failure degrades to, replicating
            # RadonPlan.pipeline's staged branch
            from ..core.conv import circ_conv1d_exact
            p = plan.geometry.prime
            kplan = get_plan((p, p), plan.dtype_name, plan.method,
                             strip_rows=plan.strip_rows,
                             m_block=plan.m_block, mesh=plan.mesh)

            def staged(x):
                rf = plan.forward(x)
                rg = kplan.forward(kernel)
                rc = circ_conv1d_exact(rf, rg)
                return plan.inverse(rc.to(rf.dtype))
            return staged
        appliers = []
        for op in ops:
            kind = getattr(op, "kind", None)
            plan = getattr(op, "plan", None)
            if plan is not None and kind is not None \
                    and hasattr(plan, kind):
                appliers.append(getattr(plan, kind))  # raw registry path
            else:                     # solve etc.: the operator itself
                appliers.append(op)

        def chain(x):
            for fn in appliers:
                x = fn(x)
            return x
        return chain

    def _to_device(self, stack: np.ndarray) -> torch.Tensor:
        """The one host-to-device copy of a stack (a read-only array,
        which torch cannot wrap, is copied on the host first)."""
        stack = np.ascontiguousarray(stack)
        if not stack.flags.writeable:
            stack = stack.copy()
        return torch.from_numpy(stack).to(self.device)

    def _run_fallback(self, stack: np.ndarray) -> np.ndarray:
        with _on_device(self.device), torch.no_grad():
            return self._fallback(self._to_device(stack)).cpu().numpy()

    def _fallback_turn(self, x: torch.Tensor) -> torch.Tensor:
        self.prepare_fallback()
        return self._fallback(x)

    def execute_fallback(self, stack: np.ndarray) -> np.ndarray:
        """Run one admitted stack through the degraded path -- bit-exact
        vs the primary executables (integers), just slower (separate
        launches).  It runs only when the primary raised, on the same
        device and through the same hand-written kernels; counted in
        ``fallback_uses``.  A fallback that was never prepared builds
        here, mid-incident (on a mesh: on every rank, in the turn)."""
        b = int(stack.shape[0])
        if b > self.max_batch:
            raise ValueError(f"fallback stack of {b} exceeds max_batch "
                             f"{self.max_batch}")
        if b < self.max_batch:
            pad = np.zeros((self.max_batch - b,) + tuple(stack.shape[1:]),
                           stack.dtype)
            stack = np.concatenate([stack, pad])
        if self._link is None:
            self.prepare_fallback()
            perturb("fallback", key=self.fault_key)
            out = self._run_fallback(stack)
        else:
            # the fault seam fires before the turn: a local fault leaves
            # no follower waiting inside a collective
            perturb("fallback", key=self.fault_key)
            with _on_device(self.device), torch.no_grad():
                out = self._lead(_FALLBACK, self._to_device(stack),
                                 self._fallback_turn)
        with self._metrics_lock:
            self._fallback_uses += 1
            self._requests_done += b
            self._t_last = time.perf_counter()
        return out[:b]

    # -- async entry points ------------------------------------------------
    async def start(self) -> None:
        """Create the queue + batcher task on the running event loop
        (idempotent; :meth:`submit` calls it on first use)."""
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._batcher = asyncio.create_task(self._run())
            self._batcher.add_done_callback(self._on_batcher_done)

    def _on_batcher_done(self, task: "asyncio.Task") -> None:
        # a batcher that DIED (not: was cancelled by shutdown) can never
        # deliver the queued futures -- fail them typed instead of
        # leaving callers awaiting forever
        if task.cancelled() or task.exception() is None:
            return
        self._reject_queued(self._queue, cause=task.exception())

    def _reject_requests(self, requests,
                         cause: Optional[BaseException] = None) -> None:
        for r in requests:
            if not r.future.done():
                err = ServiceShutdown(
                    f"DPRTService({self.fault_key}) stopped with the "
                    f"request still queued")
                if cause is not None:
                    err.__cause__ = cause
                r.future.set_exception(err)
                self._rejected_shutdown += 1

    def _reject_queued(self, queue, cause: Optional[BaseException] = None) \
            -> None:
        if queue is None:
            return
        while True:
            try:
                r = queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            self._reject_requests((r,), cause)

    def submit_nowait(self, img) -> asyncio.Future:
        """Enqueue one request without awaiting it; returns the future
        carrying this request's slice of the coalesced batched kernel
        output.  Must run inside the event loop :meth:`start` ran on --
        the cheap path for drivers enqueueing many requests at once
        (one asyncio task per request costs more than a small-N
        kernel)."""
        if not self._exes:
            raise RuntimeError("DPRTService.warmup() must run before "
                               "traffic is admitted")
        if self._queue is None:
            raise RuntimeError("DPRTService.start() must run on the "
                               "event loop before submit_nowait")
        if self._batcher is not None and self._batcher.done():
            raise ServiceShutdown(f"DPRTService({self.fault_key}) batcher "
                                  "is no longer running")
        img = np.asarray(img)
        if img.shape != self.request_shape:
            raise ValueError(f"request shape {img.shape} != service "
                             f"contract {self.request_shape}")
        if img.dtype != self.request_np_dtype:
            raise ValueError(f"request dtype {img.dtype} != service "
                             f"contract {self.request_np_dtype.name}")
        t = time.perf_counter()
        if self._t_first is None:
            self._t_first = t
        fut = asyncio.get_running_loop().create_future()
        self._queue.put_nowait(_Request(img, fut, t))
        self._queue_depth_max = max(self._queue_depth_max,
                                    self._queue.qsize())
        return fut

    async def submit(self, img) -> np.ndarray:
        """Enqueue one request and await its result (the per-request
        entry point; see :meth:`submit_nowait` for the contract)."""
        await self.start()
        return await self.submit_nowait(img)

    async def drain(self) -> None:
        """Wait until every queued request has been dispatched and every
        in-flight batch has completed."""
        while (self._queue is not None and not self._queue.empty()) \
                or self._pending:
            if self._pending:
                await asyncio.gather(*list(self._pending),
                                     return_exceptions=True)
            # yield every pass: a gather of tasks that are already done
            # completes without yielding (Python >= 3.12), and their
            # done-callbacks -- which empty _pending -- must get to run
            await asyncio.sleep(0)

    async def shutdown(self, drain: bool = True) -> None:
        """Stop the batcher and detach from this event loop (the service
        object stays warm for the next run).  With ``drain`` (default)
        every queued request is dispatched first; without it -- and for
        anything that raced in after the drain -- still-queued requests
        are REJECTED with the typed :class:`ServiceShutdown`, because a
        cancelled batcher can never deliver their futures."""
        if drain:
            await self.drain()
        if self._batcher is not None:
            self._batcher.cancel()
            try:
                await self._batcher
            except asyncio.CancelledError:
                pass
        queue, self._queue = self._queue, None
        self._batcher = None
        self._reject_queued(queue)
        if self._pending:   # in-flight dispatches still complete
            await asyncio.gather(*list(self._pending),
                                 return_exceptions=True)

    # -- the batcher -------------------------------------------------------
    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self._queue.get()]
            try:
                deadline = loop.time() + self.max_wait_us * 1e-6
                while len(batch) < self.max_batch:
                    # drain already-queued requests synchronously first:
                    # wait_for costs a task + timer per call, which at
                    # small geometries would dwarf the kernel itself
                    try:
                        batch.append(self._queue.get_nowait())
                        continue
                    except asyncio.QueueEmpty:
                        pass
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(
                            await asyncio.wait_for(self._queue.get(),
                                                   remaining))
                    except asyncio.TimeoutError:
                        break
            except asyncio.CancelledError:
                # shutdown landed while this batch was still forming:
                # its requests are no longer on the queue, so reject
                # them here -- a future must ALWAYS resolve
                self._reject_requests(batch)
                raise
            except Exception as e:    # batcher bug: don't strand the batch
                self._reject_requests(batch, cause=e)
                raise
            task = asyncio.create_task(self._dispatch(batch))
            self._pending.add(task)
            task.add_done_callback(self._pending.discard)

    def _chain(self, warm: int, x: torch.Tensor) -> torch.Tensor:
        for exe in self._exes[warm]:
            x = exe(x)
        return x

    def _compute(self, warm: int, stack: np.ndarray) -> np.ndarray:
        """One host-to-device copy of the stack, the executable chain on
        the device (no host copy between stages), one device-to-host
        copy of the result; on a mesh, one turn of every rank."""
        with _on_device(self.device), torch.no_grad():
            x = self._to_device(stack)
            if self._link is None:
                return self._chain(warm, x).cpu().numpy()
            return self._lead(_EXECUTE, x,
                              lambda x: self._chain(warm, x))

    # -- the ranks of a mesh -----------------------------------------------
    def _lead(self, kind: int, x: torch.Tensor, fn) -> np.ndarray:
        """The leader's turn: header and stack to every rank, ``fn(x)``
        here as there, then the ranks' agreement; raises when any rank
        failed."""
        link = self._link
        if not link.leader:
            raise RuntimeError(f"DPRTService({self.fault_key}): only the "
                               f"mesh's first rank dispatches batches; "
                               f"the other ranks call follow()")
        if self._closed:
            raise ServiceShutdown(f"DPRTService({self.fault_key}) was "
                                  f"closed: its follower ranks are gone")
        with link.lock:
            link.send(kind, int(x.shape[0]))
            link.stack(x)
            out, err = None, None
            try:
                out = fn(x).cpu().numpy()
            except Exception as e:      # every rank must still agree
                err = e
            if not link.agree(err is None):
                raise err or RuntimeError(
                    f"DPRTService({self.fault_key}): a follower rank "
                    f"failed turn {link.turns - 1}")
        return out

    def follow(self) -> int:
        """A follower rank's half of a mesh service, after
        :meth:`warmup`: run every turn the leader sends -- the batch
        through this rank's executables, or the degraded path -- until
        it sends stop, then sum the builds after warmup with the
        leader's :meth:`close`.  Returns the turns run, which the stop's
        sequence number checks equal to the leader's."""
        link = self._link
        if link is None or link.leader:
            raise RuntimeError("follow() is for the ranks of a mesh "
                               "service other than its first")
        if not self._exes:
            raise RuntimeError("DPRTService.warmup() must run before "
                               "follow()")
        with _on_device(self.device), torch.no_grad():
            while True:
                kind, b, seq = link.recv()
                if seq != link.turns:
                    raise RuntimeError(
                        f"DPRTService({self.fault_key}): the leader sent "
                        f"turn {seq}, this rank ran {link.turns}")
                if kind == _STOP:
                    break
                x = link.stack(torch.empty(
                    (b,) + self.request_shape, dtype=self.request_dtype,
                    device=self.device))
                ok = True
                try:
                    if kind == _EXECUTE:
                        self._chain(b, x)
                    else:
                        self._fallback_turn(x)
                except Exception:       # the leader's execute raises
                    ok = False
                    with self._metrics_lock:
                        self._failures += b
                link.agree(ok)
        link.total(self.steady_state_retraces() or 0)
        return link.turns

    @property
    def turns(self) -> int:
        """Batches this rank has run as a turn of its mesh (0 without
        one)."""
        return 0 if self._link is None else self._link.turns

    def close(self) -> Optional[int]:
        """Release a mesh service's follower ranks (the leader's stop;
        their :meth:`follow` returns) and return the builds after warmup
        summed over every rank; None on a follower or without a mesh.
        The service serves no batch after it; a second call returns
        None."""
        link = self._link
        if link is None or not link.leader or self._closed:
            return None
        with link.lock:
            self._closed = True
            link.send(_STOP)
        return link.total(self.steady_state_retraces() or 0)

    def execute(self, stack: np.ndarray) -> np.ndarray:
        """Synchronous batched dispatch: pad the validated ``(b, …)``
        stack up to the nearest warm size, run the primary executable
        chain, return host results sliced back to ``b``.  This is the
        routed surface -- the in-process batcher and the
        :class:`~repro_torch.launch.router.ServiceRouter` both call it
        on worker threads (batch counters are lock-guarded).  The fault
        seam (:func:`repro_torch.launch.faults.perturb` at site
        ``"dispatch"``) fires before the kernel, so injected faults
        surface exactly like kernel failures; the sequential oracle
        (:meth:`run_sequential`) bypasses it."""
        b = int(stack.shape[0])
        warm = nearest_warm_batch(b, self.sizes)
        if warm > b:   # pad up to the nearest warm executable shape
            pad = np.zeros((warm - b,) + tuple(stack.shape[1:]),
                           stack.dtype)
            stack = np.concatenate([stack, pad])
        t0 = time.perf_counter()
        perturb("dispatch", key=self.fault_key)
        # one device-to-host transfer for the whole batch; per-request
        # responses are zero-copy views of that host array
        out = self._compute(warm, stack)
        now = time.perf_counter()
        with self._metrics_lock:
            self._compute_s += now - t0
            self._t_last = now
            self._batches += 1
            self._batch_sizes[b] += 1
            self._padded_slots += warm - b
            self._occupancy_sum += b / warm
            self._requests_done += b
        return out[:b]

    async def _dispatch(self, batch: list) -> None:
        try:
            stack = np.stack([r.img for r in batch])
            # off-loop thread: collection of the NEXT batch overlaps the
            # kernel execution of this one
            out = await asyncio.to_thread(self.execute, stack)
        except Exception as e:
            self._failures += len(batch)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        now = time.perf_counter()
        for i, r in enumerate(batch):
            self._latencies.append(now - r.t_enqueue)
            if not r.future.done():
                r.future.set_result(out[i])

    # -- synchronous driver ------------------------------------------------
    def run_requests(self, imgs: Sequence, arrival_us: float = 0.0,
                     repeats: int = 1) -> list:
        """Serve every image in ``imgs`` as an independent concurrent
        request (request i arrives ``i * arrival_us`` after the first)
        and return the per-request results in order.  This is the
        benchmark/CLI driver -- real deployments call :meth:`submit`
        from their own event loop.

        ``repeats`` replays the same traffic that many times on ONE
        event loop (batcher and thread pool stay up, as in a real
        deployment); the last pass's results are returned and the
        per-pass wall seconds land in ``self.last_pass_walls``, so
        benchmarks can take the min instead of paying loop setup in
        every sample.
        """
        async def driver():
            await self.start()

            async def one(i, img):
                await asyncio.sleep(i * arrival_us * 1e-6)
                return await self.submit(img)

            walls, results = [], None
            try:
                for _ in range(max(1, repeats)):
                    t0 = time.perf_counter()
                    if arrival_us > 0:
                        results = await asyncio.gather(
                            *(one(i, img) for i, img in enumerate(imgs)))
                    else:
                        # burst arrival: enqueue everything in one task;
                        # the requests are still coalesced individually
                        results = await asyncio.gather(
                            *[self.submit_nowait(img) for img in imgs])
                    walls.append(time.perf_counter() - t0)
            finally:
                await self.shutdown()
            return results, walls

        results, walls = asyncio.run(driver())
        #: wall seconds of each pass of the most recent run_requests call
        self.last_pass_walls = walls
        return results

    def run_sequential(self, imgs: Sequence) -> Tuple[list, list]:
        """The non-coalescing baseline: every image dispatched on its
        own through the batch-1 executable, one at a time -- what a
        front-end without dynamic batching would do.  Returns
        ``(results, per-request latencies in seconds)``; the comparison
        :meth:`run_requests` is judged against (and the bit-exactness
        reference for the coalesced path)."""
        if not self._exes:
            raise RuntimeError("DPRTService.warmup() must run before "
                               "traffic is admitted")
        results, lats = [], []
        for img in imgs:
            t0 = time.perf_counter()
            out = self._compute(1, np.asarray(img)[None])
            lats.append(time.perf_counter() - t0)
            results.append(out[0])
        return results, lats

    # -- observability -----------------------------------------------------
    def reset_metrics(self) -> None:
        """Zero the admission/latency counters (warmup state, compiled
        executables and the post-warmup build baseline are kept) -- call
        between a warming pass and a measured one."""
        self._latencies.clear()
        self._batch_sizes.clear()
        self._requests_done = 0
        self._batches = 0
        self._padded_slots = 0
        self._occupancy_sum = 0.0
        self._queue_depth_max = 0
        self._failures = 0
        self._fallback_uses = 0
        self._rejected_shutdown = 0
        self._compute_s = 0.0
        self._t_first = None
        self._t_last = None

    def stats(self) -> Dict[str, object]:
        """Counters + latency summary: the machine-readable health
        report (see :meth:`healthz` for the formatted one)."""
        lat = latency_summary(self._latencies)
        wall = (self._t_last - self._t_first
                if self._t_first is not None and self._t_last is not None
                else None)
        out: Dict[str, object] = {
            "geometry": self.shape,
            "dtype": dtype_name(self.dtype),
            "device": str(self.device),
            "datapath": self.datapath,
            "method": self._ops[self.sizes[0]][0].plan.method,
            "warm_sizes": self.sizes,
            "max_wait_us": self.max_wait_us,
            "requests": self._requests_done,
            "failures": self._failures,
            "fallback_uses": self._fallback_uses,
            "rejected_shutdown": self._rejected_shutdown,
            "batches": self._batches,
            "batch_size_counts": dict(sorted(self._batch_sizes.items())),
            "mean_batch": (self._requests_done / self._batches
                           if self._batches else None),
            "batch_occupancy": (self._occupancy_sum / self._batches
                                if self._batches else None),
            "padded_slots": self._padded_slots,
            "queue_depth_max": self._queue_depth_max,
            "latency": lat,
            "imgs_per_s": (self._requests_done / wall
                           if wall else None),
            "compute_s": self._compute_s,
            "steady_state_retraces": self.steady_state_retraces(),
            "plan_cache": plan_cache_info()._asdict(),
            "aot_cache": radon.aot_cache_info()["currsize"],
        }
        if self.persistent is not None:
            out["persistent"] = self.persistent.stats()
        return out

    def steady_state_retraces(self) -> Optional[int]:
        """Builds (plan, applier or nvcc) AFTER warmup -- the
        build-counter check: a healthy steady state is exactly 0."""
        if self._traces_after_warmup is None:
            return None
        return radon.trace_count() - self._traces_after_warmup

    def healthy(self) -> bool:
        """Zero post-warmup builds, zero request failures, zero
        persistent-cache errors."""
        retraces = self.steady_state_retraces()
        if retraces is None or retraces > 0 or self._failures > 0:
            return False
        if self.persistent is not None and self.persistent.errors > 0:
            return False
        return True

    def healthz(self) -> str:
        """The ``/healthz``-style report: one OK/FAIL verdict line, then
        admission, latency, and cache-counter lines (plan cache with its
        eviction counter, build counts, AOT + persistent executables)."""
        s = self.stats()
        verdict = "OK" if self.healthy() else "FAIL"
        lines = [
            f"[healthz] {verdict} geometry={s['geometry']} "
            f"dtype={s['dtype']} device={s['device']} "
            f"datapath={s['datapath']} "
            f"method={s['method']} warm_sizes={s['warm_sizes']} "
            f"max_wait_us={s['max_wait_us']:.0f}",
            f"[healthz] requests={s['requests']} failures={s['failures']} "
            f"fallback_uses={s['fallback_uses']} "
            f"rejected_shutdown={s['rejected_shutdown']} "
            f"batches={s['batches']} "
            + (f"mean_batch={s['mean_batch']:.1f} "
               f"occupancy={s['batch_occupancy']:.2f} "
               if s['batches'] else "")
            + f"padded_slots={s['padded_slots']} "
            f"queue_depth_max={s['queue_depth_max']}",
            "[healthz] " + format_latency(s["latency"], s["imgs_per_s"]),
            "[healthz] plan_cache hits={hits} misses={misses} "
            "currsize={currsize} evictions={evictions}".format(
                **s["plan_cache"]),
            f"[healthz] traces total={radon.trace_count()} "
            f"steady_state_retraces={s['steady_state_retraces']} "
            f"aot_executables={s['aot_cache']}",
            f"[healthz] warm_geometries={len(plan_cache_entries())}",
        ]
        if self.persistent is not None:
            p = s["persistent"]
            lines.append(
                "[healthz] persistent_aot hits={hits} misses={misses} "
                "errors={errors} degraded_compiles={degraded_compiles} "
                "dir={directory}".format(**p))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"DPRTService({self.shape}, {dtype_name(self.dtype)}, "
                f"datapath={self.datapath!r}, warm_sizes={self.sizes}, "
                f"max_wait_us={self.max_wait_us:.0f})")
