"""The port's router (``repro_torch.launch.router``) and fault seam
(``repro_torch.launch.faults``) against the JAX reference's on the CPU.

Mirrors ``tests/test_router.py``: manifest routing (bit-exact against the
per-operator oracle), spec normalization (the reference's route keys),
the warm-ladder trim, bounded admission with typed ``QueueFull`` and its
retry hint, deadlines (rejected, never served late; an early flush),
priority order, retry then degrade to the bit-exact fallback, a raw
failure only when the fallback fails too, LRU eviction in lockstep with
the plan cache, refused eviction when every route is busy, warmup under
traffic, shutdown rejecting queued work typed, the service's batcher
death and forming-batch paths, ``serve_jsonl`` and its framed mode
(the reference's wire bytes for the same frames), and a seeded chaos
burst (every response exact or typed, never a hang).  The fault
injector makes the reference's inject/no-inject decisions for the same
seed and calls.  Every event-loop run is bounded.
"""
import asyncio
import io
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as RR
from repro.launch import faults as RF
from repro.launch import pool as RP
from repro.launch.router import ServiceRouter as RRouter
from repro.launch.router import serve_jsonl as r_serve_jsonl
from repro_torch import radon as TR
from repro_torch.kernels.tuning import (ROUTER_TRIM_N, router_warm_sizes,
                                        warm_batch_sizes)
from repro_torch.launch import faults
from repro_torch.launch import pool as TP
from repro_torch.launch.errors import (DeadlineExceeded, QueueFull,
                                       ServiceError, ServiceShutdown)
from repro_torch.launch.router import ServiceRouter, serve_jsonl
from repro_torch.launch.service import DPRTService

N1, N2 = 13, 31
CPU = torch.device("cpu")
TIMEOUT_S = 120


def _imgs(n, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, (n, n)).astype(np.int32)
            for _ in range(count)]


def _oracle(n, img):
    return TR.DPRT((1, n, n), torch.int32)(
        torch.from_numpy(np.asarray(img)[None]))[0].numpy()


def _router(**kw):
    kw.setdefault("device", CPU)
    return ServiceRouter(**kw)


def _bounded(fn, timeout_s=TIMEOUT_S):
    """``fn()`` on a thread that must finish within ``timeout_s``."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:       # surfaced below
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"did not finish within {timeout_s} s"
    if err:
        raise err[0]
    return out[0]


def _run(router, reqs, **kw):
    return _bounded(lambda: router.run_requests(reqs, **kw))


# ---------------------------------------------------------------------------
# routing and exactness
# ---------------------------------------------------------------------------
def test_mixed_geometry_routing_bit_exact():
    a, b = _imgs(N1, 4, 1), _imgs(N2, 4, 2)
    want = [_oracle(N1, x) for x in a] + [_oracle(N2, x) for x in b]
    ref_op = {n: RR.DPRT((1, n, n), jnp.int32) for n in (N1, N2)}
    router = _router(max_batch=2, max_wait_us=500.0)
    router.prefill([{"n": N1}, {"n": N2}])
    reqs = [({"n": N1}, x) for x in a] + [({"n": N2}, x) for x in b]
    outs = _run(router, reqs)
    for (spec, x), out, w in zip(reqs, outs, want):
        np.testing.assert_array_equal(out, w)
        np.testing.assert_array_equal(
            out, np.asarray(ref_op[spec["n"]](x[None]))[0])
    assert router.verdict() == "OK" and router.pending() == 0
    assert router.delivered == len(reqs) == router.admitted
    assert len(router.stats()["routes"]) == 2


@pytest.mark.parametrize("spec", [{"n": N1}, {"shape": (N1, N1)},
                                  {"n": N1, "dtype": "int32",
                                   "datapath": "roundtrip"},
                                  {"shape": [N2, N2], "dtype": "float32",
                                   "datapath": "solve"}, 17])
def test_route_keys_match_the_reference(spec):
    assert ServiceRouter.route_key(spec) == RRouter.route_key(spec)
    with pytest.raises(ValueError):
        ServiceRouter._normalize({"dtype": "int32"})   # no geometry


def test_router_warm_sizes_trim():
    assert router_warm_sizes(N1, 16) == warm_batch_sizes(16)
    assert router_warm_sizes(ROUTER_TRIM_N, 16) == (1, 16)
    assert router_warm_sizes(ROUTER_TRIM_N + 2, 8) == (1, 8)
    assert router_warm_sizes(ROUTER_TRIM_N, 1) == (1,)
    router = _router(max_batch=8)
    route = router._ensure_route({"n": 251})
    assert route.service.sizes == (1, 2, 4, 8)       # 251 < the trim


# ---------------------------------------------------------------------------
# bounded admission: typed rejections
# ---------------------------------------------------------------------------
def test_queue_cap_rejects_typed_with_retry_hint():
    imgs = _imgs(N1, 12, 3)
    router = _router(max_batch=2, queue_cap=4, max_wait_us=200.0)
    router.prefill([{"n": N1}])
    outs = _run(router, [({"n": N1}, x) for x in imgs])
    full = [o for o in outs if isinstance(o, QueueFull)]
    served = [o for o in outs if not isinstance(o, Exception)]
    assert len(full) == len(imgs) - 4 and len(served) == 4
    assert router.rejected_admission["queue_full"] == len(full)
    assert all(e.retry_after_s is not None and e.retry_after_s > 0
               for e in full)
    assert router.verdict() == "WARN"
    for i, o in enumerate(outs):
        if not isinstance(o, Exception):
            np.testing.assert_array_equal(o, _oracle(N1, imgs[i]))


def test_global_inflight_budget():
    router = _router(max_batch=2, max_inflight=3, queue_cap=64)
    router.prefill([{"n": N1}])
    outs = _run(router, [({"n": N1}, x) for x in _imgs(N1, 6, 4)])
    assert sum(isinstance(o, QueueFull) for o in outs) == 3
    assert router.admitted == 3


def test_deadline_rejections_typed():
    imgs = _imgs(N1, 3, 5)
    router = _router(max_batch=2, max_wait_us=200.0)
    router.prefill([{"n": N1}])
    outs = _run(router, [({"n": N1}, imgs[0], {}),
                         ({"n": N1}, imgs[1], {"deadline_s": -1.0}),
                         ({"n": N1}, imgs[2], {"deadline_s": 1e-9})])
    np.testing.assert_array_equal(outs[0], _oracle(N1, imgs[0]))
    assert isinstance(outs[1], DeadlineExceeded)
    assert isinstance(outs[2], DeadlineExceeded)
    assert router.stats()["rejected"]["deadline_exceeded"] == 2
    assert router.verdict() == "WARN"


def test_deadline_flushes_batch_early():
    img = _imgs(N1, 1, 6)[0]
    router = _router(max_batch=16, max_wait_us=30_000_000.0)
    router.prefill([{"n": N1}])
    t0 = time.perf_counter()
    outs = _run(router, [({"n": N1}, img, {"deadline_s": 0.25})])
    assert time.perf_counter() - t0 < 10.0
    if isinstance(outs[0], Exception):
        assert isinstance(outs[0], DeadlineExceeded)
    else:
        np.testing.assert_array_equal(outs[0], _oracle(N1, img))


def test_priority_orders_the_queue():
    imgs = _imgs(N1, 4, 7)
    router = _router(max_batch=2)
    router.prefill([{"n": N1}])

    async def run():
        await router.start()
        route = router._ensure_route({"n": N1})
        futs = [router.submit_nowait({"n": N1}, img, priority=p)
                for img, p in zip(imgs, (0, 5, 1, 5))]
        items = []
        while not route.queue.empty():
            items.append(route.queue.get_nowait())
        assert [it[2].priority for it in items] == [5, 5, 1, 0]
        for it in items:
            route.queue.put_nowait(it)
        outs = await asyncio.gather(*futs)
        await router.shutdown()
        return outs

    outs = _bounded(lambda: asyncio.run(run()))
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, _oracle(N1, img))


# ---------------------------------------------------------------------------
# retry / degrade
# ---------------------------------------------------------------------------
def test_injected_fault_retries_then_succeeds():
    imgs = _imgs(N1, 2, 8)
    router = _router(max_batch=2, max_retries=2, retry_backoff_s=1e-3)
    router.prefill([{"n": N1}])
    with faults.FaultInjector(seed=0, error_count=1,
                              sites=("dispatch",)) as inj:
        outs = _run(router, [({"n": N1}, x) for x in imgs])
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, _oracle(N1, img))
    assert inj.injected_errors == 1
    assert router.retries == 1 and router.fallbacks == 0
    assert router.stats()["fallback_uses"] == 0
    assert router.verdict() == "WARN"


def test_exhausted_retries_degrade_to_fallback_bit_exact():
    imgs = _imgs(N1, 2, 9)
    router = _router(max_batch=2, max_retries=1, retry_backoff_s=1e-3)
    router.prefill([{"n": N1}])
    with faults.FaultInjector(seed=0, error_count=2, sites=("dispatch",)):
        outs = _run(router, [({"n": N1}, x) for x in imgs])
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, _oracle(N1, img))
    assert router.fallbacks == 1 and router.retries == 1
    assert router.stats()["fallback_uses"] == 1
    assert router.verdict() == "WARN"


def test_fallback_failure_is_raw_and_verdict_fail():
    img = _imgs(N1, 1, 10)[0]
    router = _router(max_batch=1, max_retries=0, retry_backoff_s=1e-3)
    router.prefill([{"n": N1}])
    with faults.FaultInjector(seed=0, error_count=10,
                              sites=("dispatch", "fallback")):
        outs = _run(router, [({"n": N1}, img)])
    assert isinstance(outs[0], faults.InjectedFault)
    assert not isinstance(outs[0], ServiceError)
    assert router.failed == 1 and router.pending() == 0
    assert router.verdict() == "FAIL"


def _decisions(mod, **kw):
    """Which of 60 seam calls raise and how long each sleeps (delays are
    recorded, not slept)."""
    out = []
    real_sleep = mod.time.sleep
    slept = []
    mod.time.sleep = slept.append
    try:
        with mod.FaultInjector(**kw) as inj:
            for i in range(60):
                key = ("13x13/int32/forward", "17x17/int32/forward")[i % 2]
                before = len(slept)
                try:
                    mod.perturb(("dispatch", "fallback")[i % 3 == 2], key)
                    out.append(("ok", len(slept) - before))
                except mod.InjectedFault as e:
                    out.append((str(e), len(slept) - before))
        stats = inj.stats()
    finally:
        mod.time.sleep = real_sleep
    return out, {k: v for k, v in stats.items() if k != "sites"}


@pytest.mark.parametrize("kw", [
    dict(seed=0, error_count=2, error_rate=0.3),
    dict(seed=7, error_rate=0.5, delay_s=1e-3, delay_rate=0.4,
         sites=("dispatch", "fallback")),
    dict(seed=3, error_count=1, error_rate=0.2, match="17x17",
         delay_s=1e-3, delay_rate=0.5)])
def test_fault_schedule_matches_the_reference(kw):
    assert _decisions(faults, **kw) == _decisions(RF, **kw)


def test_fault_injector_deterministic_and_scoped():
    with faults.FaultInjector(seed=3, error_count=2, sites=("dispatch",),
                              match="17x17") as inj:
        faults.perturb("dispatch", key="13x13/int32/forward")  # no match
        faults.perturb("fallback", key="17x17/int32/forward")  # wrong site
        with pytest.raises(faults.InjectedFault):
            faults.perturb("dispatch", key="17x17/int32/forward")
        with pytest.raises(faults.InjectedFault):
            faults.perturb("dispatch", key="17x17/int32/forward")
        faults.perturb("dispatch", key="17x17/int32/forward")  # spent
    assert inj.injected_errors == 2
    faults.perturb("dispatch", key="17x17/int32/forward")      # no-op
    assert faults.active_injector() is None


def test_service_warm_sizes_override():
    svc = DPRTService((N1, N1), torch.int32, max_batch=4,
                      warm_sizes=(4, 2, 2), device=CPU)
    assert svc.sizes == (2, 4)
    svc.warmup()
    img = _imgs(N1, 1, 24)[0]
    out = svc.execute(img[None])         # b=1 pads up to warm size 2
    np.testing.assert_array_equal(out[0], _oracle(N1, img))
    assert svc.stats()["padded_slots"] == 1


def test_conv_fallback_matches_fused_pipeline():
    svc = DPRTService((N1, N1), torch.int32, max_batch=2, datapath="conv",
                      conv_kernel=np.ones((3, 3), np.int32), fallback=True,
                      device=CPU)
    svc.warmup()
    imgs = np.stack(_imgs(N1, 2, 11))
    primary = svc.execute(imgs.copy())
    degraded = svc.execute_fallback(imgs.copy())
    np.testing.assert_array_equal(primary, degraded)
    assert svc.stats()["fallback_uses"] == 1


# ---------------------------------------------------------------------------
# bounded residency: LRU eviction in lockstep with the plan cache
# ---------------------------------------------------------------------------
def test_lru_eviction_discards_only_unshared_plans():
    from repro_torch.radon import operators as TO
    router = _router(max_batch=2, max_services=2)
    router.prefill([{"n": N1}, {"n": N1, "datapath": "roundtrip"}])
    n1_plans = set().union(*(r.service.plans()
                             for r in router._routes.values()))
    n1_keys = {k for k in TO._AOT_CACHE
               if any(TO._key_involves(k, p) for p in n1_plans)}
    assert n1_keys
    evict_before = TR.plan_cache_info().evictions
    router.prefill([{"n": N2}])
    assert router.evictions == 1
    labels = set(router.stats()["routes"])
    assert f"{N1}x{N1}/int32/forward" not in labels and len(labels) == 2
    # the forward route's plans are shared with the surviving roundtrip
    # route: nothing is discarded for them, executables included
    assert TR.plan_cache_info().evictions == evict_before
    assert n1_keys <= set(TO._AOT_CACHE)
    router.max_services = 1
    router.prefill([{"n": N2, "datapath": "roundtrip"}])
    assert router.evictions == 3
    assert TR.plan_cache_info().evictions > evict_before
    assert not n1_keys & set(TO._AOT_CACHE)   # dropped in lockstep
    img = _imgs(N2, 1, 12)[0]
    outs = _run(router, [({"n": N2, "datapath": "roundtrip"}, img)])
    np.testing.assert_array_equal(outs[0], img)


def test_eviction_refuses_when_every_route_busy():
    router = _router(max_batch=2, max_services=1)
    router.prefill([{"n": N1}])
    img = _imgs(N1, 1, 13)[0]

    async def run():
        await router.start()
        fut = router.submit_nowait({"n": N1}, img)
        with pytest.raises(QueueFull):
            router._ensure_route({"n": N2})
        out = await fut
        await router.shutdown()
        return out

    out = _bounded(lambda: asyncio.run(run()))
    np.testing.assert_array_equal(out, _oracle(N1, img))


def test_concurrent_submit_during_warmup():
    imgs = _imgs(N1, 6, 14)
    router = _router(max_batch=2, max_wait_us=500.0)   # no prefill
    outs = _run(router, [({"n": N1}, x) for x in imgs])
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, _oracle(N1, img))
    assert router.verdict() == "OK"


# ---------------------------------------------------------------------------
# shutdown semantics: a future ALWAYS resolves
# ---------------------------------------------------------------------------
def test_router_shutdown_rejects_queued_typed():
    router = _router(max_batch=2)      # cold route: requests queue
    imgs = _imgs(N1, 3, 16)

    async def run():
        await router.start()
        futs = [router.submit_nowait({"n": N1}, x) for x in imgs]
        await router.shutdown()
        return await asyncio.gather(*futs, return_exceptions=True)

    outs = _bounded(lambda: asyncio.run(run()))
    assert all(isinstance(o, ServiceShutdown) for o in outs)
    assert router.rejected_shutdown == len(imgs)
    assert router.pending() == 0 and router.verdict() == "WARN"


def test_service_shutdown_rejects_queued():
    svc = DPRTService((N1, N1), torch.int32, max_batch=2,
                      max_wait_us=5_000_000.0, device=CPU)
    svc.warmup()
    imgs = _imgs(N1, 3, 17)

    async def run():
        await svc.start()
        futs = [svc.submit_nowait(x) for x in imgs]
        await asyncio.sleep(0.05)
        await svc.shutdown(drain=False)
        return await asyncio.wait_for(
            asyncio.gather(*futs, return_exceptions=True), timeout=60)

    outs = _bounded(lambda: asyncio.run(run()))
    rejected = [o for o in outs if isinstance(o, ServiceShutdown)]
    assert rejected
    for o in outs:
        assert isinstance(o, (np.ndarray, ServiceShutdown))
    assert svc.stats()["rejected_shutdown"] == len(rejected)


def test_service_batcher_death_fails_fast_not_forever():
    svc = DPRTService((N1, N1), torch.int32, max_batch=2, device=CPU)
    svc.warmup()

    async def doomed(self):
        raise RuntimeError("batcher bug")

    svc._run = doomed.__get__(svc)

    async def run():
        await svc.start()
        f1 = svc.submit_nowait(_imgs(N1, 1, 18)[0])
        f2 = svc.submit_nowait(_imgs(N1, 1, 19)[0])
        outs = await asyncio.wait_for(
            asyncio.gather(f1, f2, return_exceptions=True), timeout=60)
        with pytest.raises(ServiceShutdown):
            svc.submit_nowait(_imgs(N1, 1, 20)[0])
        return outs

    outs = _bounded(lambda: asyncio.run(run()))
    assert all(isinstance(o, ServiceShutdown) for o in outs)
    assert all(isinstance(o.__cause__, RuntimeError) for o in outs)
    assert svc.stats()["rejected_shutdown"] == 2


def test_service_batcher_exception_rejects_forming_batch():
    svc = DPRTService((N1, N1), torch.int32, max_batch=4,
                      max_wait_us=5_000_000.0, device=CPU)
    svc.warmup()

    async def run():
        await svc.start()
        f1 = svc.submit_nowait(_imgs(N1, 1, 22)[0])
        await asyncio.sleep(0.05)
        real, armed = svc._queue.get_nowait, [True]

        def poisoned():
            if armed:
                armed.clear()
                raise RuntimeError("collect bug")
            return real()

        svc._queue.get_nowait = poisoned
        f2 = svc.submit_nowait(_imgs(N1, 1, 23)[0])
        return await asyncio.wait_for(
            asyncio.gather(f1, f2, return_exceptions=True), timeout=60)

    outs = _bounded(lambda: asyncio.run(run()))
    assert all(isinstance(o, ServiceShutdown) for o in outs)


# ---------------------------------------------------------------------------
# the jsonl transport front-end: the reference's wire bytes
# ---------------------------------------------------------------------------
def _messages(img):
    return [
        {"op": "submit", "id": "a", "n": N1, "data": img.tolist()},
        {"op": "submit", "id": "b", "n": N1, "data": [[1, 2], [3, 4]]},
        {"op": "submit", "id": "c", "n": N1, "data": img.tolist(),
         "deadline_ms": -5.0},
        {"op": "submit", "id": "d", "n": N1, "datapath": "roundtrip",
         "data": img.tolist(), "priority": 2},
        {"op": "healthz", "id": "h"},
        {"op": "nope", "id": "x"},
        {"op": "shutdown", "id": "z"},
    ]


def _jsonl(pkg, framed, img):
    router = (_router(max_batch=2, max_wait_us=200.0) if pkg == "port"
              else RRouter(max_batch=2, max_wait_us=200.0))
    router.prefill([{"n": N1}, {"n": N1, "datapath": "roundtrip"}])
    infile = io.StringIO()
    for m in _messages(img):
        if framed:
            (TP if pkg == "port" else RP).write_frame(infile, m)
        else:
            if m["op"] == "shutdown":
                infile.write("not json\n")
            infile.write(json.dumps(m) + "\n")
    infile.seek(0)
    outfile = io.StringIO()
    run = serve_jsonl if pkg == "port" else r_serve_jsonl
    _bounded(lambda: run(router, infile, outfile, framed=framed))
    assert router.pending() == 0
    raw = outfile.getvalue()
    if framed:       # frames of raw bytes, in the order written
        out, buf = [], io.StringIO(raw)
        while True:
            header = buf.readline()
            if not header:
                break
            payload = buf.read(int(header))
            buf.readline()
            out.append(header + payload + "\n")
        return out
    return [line + "\n" for line in raw.splitlines()]


@pytest.mark.parametrize("framed", [False, True])
def test_serve_jsonl_wire_bytes_match_the_reference(framed):
    img = _imgs(N1, 1, 21)[0]
    port = _jsonl("port", framed, img)
    ref = _jsonl("reference", framed, img)

    def by_id(chunks):
        out = {}
        for c in chunks:
            body = c.split("\n", 1)[1] if framed else c
            out[json.loads(body).get("id")] = c
        return out
    port_by, ref_by = by_id(port), by_id(ref)
    assert set(port_by) == set(ref_by) == {"a", "b", "c", "d", "h", "x",
                                           "z"} | ({None} if not framed
                                                   else set())
    for rid in port_by:
        if rid == "h":     # pid, stats and healthz text are per process
            continue
        assert port_by[rid] == ref_by[rid], rid
    h = json.loads(port_by["h"].split("\n", 1)[1] if framed
                   else port_by["h"])
    hr = json.loads(ref_by["h"].split("\n", 1)[1] if framed
                    else ref_by["h"])
    assert set(h) == set(hr)
    assert set(h["persistent"]) == set(hr["persistent"])
    assert h["retraces_since_start"] == 0 and h["faults_env"] is None
    a = json.loads(port_by["a"].split("\n", 1)[1] if framed
                   else port_by["a"])
    np.testing.assert_array_equal(np.asarray(a["data"]), _oracle(N1, img))


# ---------------------------------------------------------------------------
# chaos invariants (the in-process version of serve --chaos)
# ---------------------------------------------------------------------------
def test_chaos_burst_never_wrong_never_hangs(tmp_path):
    TR.aot_cache_clear()
    seeder = _router(max_batch=2, aot_dir=str(tmp_path))
    seeder.prefill([{"n": N1}, {"n": N2}])
    TR.aot_cache_clear()
    assert faults.corrupt_blobs(str(tmp_path), seed=0) > 0
    router = _router(max_batch=2, max_wait_us=300.0, queue_cap=6,
                     max_retries=1, retry_backoff_s=1e-3,
                     aot_dir=str(tmp_path))
    router.prefill([{"n": N1}, {"n": N2}])
    assert router.degraded_compiles() > 0
    rng = np.random.default_rng(1)
    traffic, oracles = [], []
    for i in range(20):
        n = (N1, N2)[i % 2]
        img = rng.integers(0, 50, (n, n)).astype(np.int32)
        kw = {"deadline_s": 1e-9} if i % 9 == 4 else {}
        traffic.append(({"n": n}, img, kw))
        oracles.append(None if kw else _oracle(n, img))
    with faults.FaultInjector(seed=2, error_count=2, error_rate=0.1,
                              delay_s=0.001, delay_rate=0.25,
                              sites=("dispatch",)):
        outs = _run(router, traffic)
    for out, want in zip(outs, oracles):
        if isinstance(out, BaseException):
            assert isinstance(out, ServiceError), f"untyped: {out!r}"
        elif want is not None:
            np.testing.assert_array_equal(out, want)
    assert router.pending() == 0 and router.failed == 0
    s = router.stats()
    accounted = (s["delivered"] + s["failed"] + s["pending"]
                 + router.rejected_deadline + router.rejected_shutdown)
    assert s["admitted"] == accounted
    assert router.verdict() == "WARN"
    assert "degraded" in router.healthz()
    TR.aot_cache_clear()


def test_serve_chaos_cli_passes(capsys):
    from repro_torch.launch import serve
    _bounded(lambda: serve.main(["--mode", "service", "--chaos", "--smoke",
                                 "--device", "cpu"]), 300)
    assert "[serve-chaos] PASS" in capsys.readouterr().out
