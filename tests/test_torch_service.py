"""The port's dynamic-batching service (``repro_torch.launch.service``)
against the JAX reference's (``repro.launch.service``) on the CPU.

Mirrors ``tests/test_service.py``: the latency helpers and the warm
batch sizes equal the reference's; admission, padding and occupancy
accounting; responses of all five datapaths equal the reference
service's on the same numpy requests (integers bit for bit, ``solve``
within SOLVE_REL of the image's peak); coalesced responses equal
``run_sequential``'s and padded slots never reach a response; a zero
(padding) right-hand side solves to 0 without stalling CG; the degraded
path equals the primary and runs only when asked; a warm restart from
the persistent cache builds nothing; the healthz reports and the
``serve --mode service`` CLI.  The port runs on CPU tensors (the
kernels' plain versions); every run that starts an event loop is
bounded.
"""
import asyncio
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as RR
from repro.kernels import tuning as RT
from repro.launch import service as RS
from repro_torch import radon as TR
from repro_torch.kernels import _build
from repro_torch.kernels import tuning as TT
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import service as TS
from repro_torch.launch.service import DPRTService
from repro_torch.radon import healthz

TSOLVE = importlib.import_module("repro_torch.radon.solve")

N = 13
CPU = torch.device("cpu")
#: float32 agreement of a solve response, relative to the image's peak
#: (tests/test_torch_solve.py's CG tolerance)
SOLVE_REL = 1e-4
TIMEOUT_S = 120


def _imgs(count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, (N, N), dtype=np.int32)
            for _ in range(count)]


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


def _svc(**kw):
    kw.setdefault("max_wait_us", 100.0)
    kw.setdefault("device", CPU)
    return DPRTService((N, N), torch.int32, **kw)


# ---------------------------------------------------------------------------
# the helpers the port copies
# ---------------------------------------------------------------------------
def test_latency_helpers_match_the_reference():
    xs = [0.004, 0.001, 0.003, 0.002, 0.0105]
    for q in (0, 13.5, 50, 95, 99, 100):
        assert TS.percentile(sorted(xs), q) == RS.percentile(sorted(xs), q)
    assert TS.latency_summary(xs) == RS.latency_summary(xs)
    assert TS.latency_summary([]) == RS.latency_summary([]) == {"n": 0}
    s = TS.latency_summary(xs)
    assert TS.format_latency(s, 123.4) == RS.format_latency(s, 123.4)
    assert TS.format_latency({"n": 0}) == "latency: no samples"
    with pytest.raises(ValueError):
        TS.percentile([], 50)


def test_warm_sizes_match_the_reference():
    assert TT.SERVE_WARM_BATCHES == RT.SERVE_WARM_BATCHES
    assert TT.ROUTER_TRIM_N == RT.ROUTER_TRIM_N
    for mb in range(1, 40):
        assert TT.warm_batch_sizes(mb) == RT.warm_batch_sizes(mb)
        for n in (13, 31, 251, 508, 509, 1021, 4099):
            assert TT.router_warm_sizes(n, mb) == RT.router_warm_sizes(n, mb)
        sizes = TT.warm_batch_sizes(mb)
        for count in range(1, mb + 1):
            assert TT.nearest_warm_batch(count, sizes) == \
                RT.nearest_warm_batch(count, sizes)
        for mod in (TT, RT):
            with pytest.raises(ValueError):
                mod.nearest_warm_batch(mb + 1, sizes)
    for mod in (TT, RT):
        with pytest.raises(ValueError):
            mod.warm_batch_sizes(0)


# ---------------------------------------------------------------------------
# admission contract
# ---------------------------------------------------------------------------
def test_constructor_validation():
    with pytest.raises(ValueError, match="geometry"):
        DPRTService((N,), torch.int32, device=CPU)
    with pytest.raises(ValueError, match="datapath"):
        _svc(datapath="sideways")
    with pytest.raises(ValueError, match="conv_kernel"):
        _svc(datapath="conv")
    with pytest.raises(ValueError, match="conv_kernel"):
        _svc(conv_kernel=np.ones((3, 3), np.int32))
    with pytest.raises(ValueError, match="max_wait_us"):
        _svc(max_wait_us=-1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _svc(device="cuda")       # never carries on on the CPU


def test_traffic_rejected_before_warmup_or_loop():
    svc = _svc(max_batch=2)
    with pytest.raises(RuntimeError, match="warmup"):
        svc.run_sequential(_imgs(1))
    with pytest.raises(RuntimeError, match="warmup"):
        svc.submit_nowait(np.zeros((N, N), np.int32))
    svc.warmup()
    with pytest.raises(RuntimeError, match="start"):
        svc.submit_nowait(np.zeros((N, N), np.int32))     # no event loop


def test_request_shape_dtype_validation():
    svc = _svc(max_batch=2)
    svc.warmup()

    async def go():
        await svc.start()
        with pytest.raises(ValueError, match="shape"):
            svc.submit_nowait(np.zeros((N, N + 1), np.int32))
        with pytest.raises(ValueError, match="dtype"):
            svc.submit_nowait(np.zeros((N, N), np.float32))
        out = await svc.submit(np.zeros((N, N), np.int32))
        await svc.shutdown()
        return out

    out = _bounded(lambda: asyncio.run(go()))
    assert out.shape == (N + 1, N)        # (P+1, P) projections per request


def test_drain_does_not_spin_on_finished_dispatches():
    # a dispatch task that finished before drain() looked at it must not
    # keep drain() spinning: its done-callback has to get a turn
    svc = _svc(max_batch=2)
    svc.warmup()

    async def go():
        await svc.start()
        out = await svc.submit_nowait(np.ones((N, N), np.int32))
        await svc.shutdown()
        return out

    assert _bounded(lambda: asyncio.run(go()), 30).shape == (N + 1, N)


# ---------------------------------------------------------------------------
# responses against the reference service
# ---------------------------------------------------------------------------
DATAPATHS = ["forward", "inverse", "roundtrip", "conv", "solve",
             "solve_masked"]


def _requests(datapath, imgs):
    if datapath in ("forward", "roundtrip", "conv"):
        return imgs
    fwd = RR.DPRT((N, N), jnp.int32)
    proj = [np.asarray(fwd(jnp.asarray(x))) for x in imgs]
    if datapath == "inverse":
        return proj
    if datapath == "solve":
        return [p.astype(np.float32) for p in proj]
    m = RR.MaskedDPRT(fwd, mask=RR.direction_mask(N, [2, 7]))
    return [np.asarray(m(jnp.asarray(x, jnp.float32))) for x in imgs]


def _knobs(pkg, datapath):
    dp = "solve" if datapath == "solve_masked" else datapath
    kw = {"datapath": dp, "max_batch": 4, "max_wait_us": 200.0}
    if dp == "conv":
        kw["conv_kernel"] = np.arange(9, dtype=np.int32).reshape(3, 3)
    if datapath == "solve_masked":
        kw.update(solver="cg", solve_tol=1e-6, solve_maxiter=100)
        kw["solve_mask"] = (RR.direction_mask(N, [2, 7]) if pkg == "ref"
                            else TR.direction_mask(N, [2, 7], device=CPU))
    if pkg == "ref":
        if dp == "conv":
            kw["conv_kernel"] = jnp.asarray(kw["conv_kernel"])
        return kw
    kw["device"] = CPU
    return kw


@pytest.mark.parametrize("datapath", DATAPATHS)
def test_responses_match_the_reference_service(datapath):
    reqs = _requests(datapath, _imgs(5, seed=3))
    ref = RS.DPRTService((N, N), jnp.int32, **_knobs("ref", datapath))
    ref.warmup()
    want = ref.run_requests(reqs)
    svc = DPRTService((N, N), torch.int32, **_knobs("port", datapath))
    assert svc.request_shape == ref.request_shape
    assert svc.request_np_dtype == np.dtype(ref.request_dtype.name)
    svc.warmup()
    got = _bounded(lambda: svc.run_requests(reqs))
    seq, _ = svc.run_sequential(reqs)
    for g, s, w in zip(got, seq, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if datapath.startswith("solve"):
            tol = SOLVE_REL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
            np.testing.assert_allclose(g, s, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, s)
    s = svc.stats()
    assert s["requests"] == 5 and s["failures"] == 0
    assert s["fallback_uses"] == 0 and svc.healthy()
    assert s["steady_state_retraces"] == 0


# ---------------------------------------------------------------------------
# coalescing: correctness + padding/occupancy accounting
# ---------------------------------------------------------------------------
def test_coalesced_matches_sequential_and_pads():
    imgs = _imgs(7)
    op = TR.DPRT((N, N), torch.int32)
    ref = [op(torch.from_numpy(x)).numpy() for x in imgs]
    svc = _svc(max_batch=8)
    svc.warmup()
    got = _bounded(lambda: svc.run_requests(imgs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    s = svc.stats()
    assert s["requests"] == 7 and s["failures"] == 0
    assert s["batches"] == 1              # burst of 7 coalesces into one
    assert s["batch_size_counts"] == {7: 1}
    assert s["padded_slots"] == 1         # 7 padded up to warm size 8
    assert s["batch_occupancy"] == pytest.approx(7 / 8)
    assert s["steady_state_retraces"] == 0
    assert svc.healthy()


def test_padded_slots_never_reach_a_response():
    imgs = _imgs(3, seed=4)
    svc = _svc(max_batch=4, datapath="roundtrip")
    svc.warmup()
    out = svc.execute(np.stack(imgs))     # padded 3 -> 4
    assert out.shape == (3, N, N)
    np.testing.assert_array_equal(out, np.stack(imgs))
    # the responses are views of one host array: the padding row is not
    # reachable from any of them
    assert out.base is not None and out.base.shape[0] == 4
    assert svc.stats()["padded_slots"] == 1


def test_batcher_splits_at_max_batch():
    imgs = _imgs(6)
    svc = _svc(max_batch=4)
    svc.warmup()
    ref, _ = svc.run_sequential(imgs)
    got = _bounded(lambda: svc.run_requests(imgs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    s = svc.stats()
    assert s["batch_size_counts"] == {4: 1, 2: 1}   # full batch + remainder
    assert s["padded_slots"] == 0
    assert s["queue_depth_max"] >= 1


def test_spaced_arrivals_and_repeats():
    imgs = _imgs(4, seed=3)
    svc = _svc(max_batch=4, max_wait_us=500.0)
    svc.warmup()
    ref, _ = svc.run_sequential(imgs)
    got = _bounded(lambda: svc.run_requests(imgs, arrival_us=200.0,
                                            repeats=2))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert len(svc.last_pass_walls) == 2
    assert svc.stats()["requests"] == 2 * len(imgs)


def test_zero_rhs_padding_solves_to_zero_and_stops_cg():
    mask = TR.direction_mask(N, [2, 7], device=CPU)
    m = TR.MaskedDPRT(TR.DPRT((3, N, N), torch.int32), mask=mask)
    b = m(torch.from_numpy(np.stack(_imgs(3, seed=8))).float())
    b[1] = 0                                       # a padding slot
    TSOLVE.reset_iteration_counts()
    res = TR.solve(m, b, "cg", tol=1e-6, maxiter=100)
    assert bool(torch.isfinite(res.image).all())
    assert torch.equal(res.image[1], torch.zeros(N, N))
    assert 0 < int(res.iterations) < 100 and bool(res.converged)
    alone = TR.solve(m, torch.zeros_like(b), "cg", tol=1e-6, maxiter=100)
    assert int(alone.iterations) == 0 and bool(alone.converged)
    assert torch.equal(alone.image, torch.zeros_like(alone.image))
    # and through the service: a single request pads 1 -> 2 with zeros
    svc = _svc(max_batch=2, datapath="solve", solve_mask=mask, solver="cg")
    svc.warmup()
    out = svc.execute(b[:1].numpy())
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], res.image[0].numpy(), rtol=0,
                               atol=SOLVE_REL * float(res.image.abs().max()))


@pytest.mark.parametrize("datapath", ["forward", "inverse", "roundtrip",
                                      "conv", "solve"])
def test_fallback_matches_primary_and_runs_only_when_asked(datapath):
    imgs = _imgs(3, seed=11)
    kw = {"datapath": datapath, "max_batch": 4}
    if datapath == "conv":
        kw["conv_kernel"] = np.ones((3, 3), np.int32)
    svc = _svc(**kw)
    stack = np.stack(imgs)
    if datapath in ("inverse", "solve"):
        op = TR.DPRT((3, N, N), torch.int32)
        stack = op(torch.from_numpy(stack)).numpy().astype(
            svc.request_np_dtype)
    svc.warmup()
    _bounded(lambda: svc.run_requests(list(stack)))
    assert svc.stats()["fallback_uses"] == 0     # no fault: never ran
    primary = svc.execute(stack.copy())
    degraded = svc.execute_fallback(stack.copy())
    if datapath == "solve":
        np.testing.assert_allclose(degraded, primary, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(degraded, primary)
    assert svc.stats()["fallback_uses"] == 1
    assert "fallback_uses=1" in svc.healthz()


def test_reset_metrics_keeps_executables():
    imgs = _imgs(2)
    svc = _svc(max_batch=2)
    svc.warmup()
    _bounded(lambda: svc.run_requests(imgs))
    svc.reset_metrics()
    s = svc.stats()
    assert s["requests"] == 0 and s["batches"] == 0
    assert s["latency"] == {"n": 0}
    assert s["steady_state_retraces"] == 0
    assert _bounded(lambda: svc.run_requests(imgs))


# ---------------------------------------------------------------------------
# persistent executable cache
# ---------------------------------------------------------------------------
def test_persistent_cache_warm_restart_zero_builds(tmp_path):
    TR.aot_cache_clear()
    svc1 = _svc(max_batch=2, aot_dir=str(tmp_path))
    info1 = svc1.warmup()
    p1 = info1["persistent"]
    assert p1["misses"] == info1["executables"] and p1["hits"] == 0
    # a simulated restart: in-memory executables gone, blobs remain
    TR.aot_cache_clear()
    t0 = TR.trace_count()
    svc2 = _svc(max_batch=2, aot_dir=str(tmp_path))
    info2 = svc2.warmup()
    p2 = info2["persistent"]
    assert p2["hits"] == info2["executables"]
    assert p2["misses"] == 0 and p2["errors"] == 0
    assert TR.trace_count() == t0          # the restore built nothing
    out = _bounded(lambda: svc2.run_requests([np.ones((N, N), np.int32)]))
    assert out[0].shape == (N + 1, N)
    assert svc2.healthy()
    assert "persistent_aot hits=" in svc2.healthz()
    TR.aot_cache_clear()


# ---------------------------------------------------------------------------
# thread safety of what the serving threads share
# ---------------------------------------------------------------------------
def test_launch_records_are_per_thread():
    seen = {}

    def worker(name):
        with _build.recording() as rec:
            for _ in range(100):
                _build.note_launch(name, (1, 2))
        seen[name] = rec

    threads = [threading.Thread(target=worker, args=(name,))
               for name in ("sfdprt", "pipeline", "stream")]
    with _build.recording() as outer:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    assert outer == {"libraries": set(), "tiles": []}
    for name, rec in seen.items():
        assert rec == {"libraries": {name}, "tiles": [(name, (1, 2))]}


# ---------------------------------------------------------------------------
# healthz surfaces and the CLI
# ---------------------------------------------------------------------------
def test_service_healthz_report():
    svc = _svc(max_batch=2)
    svc.warmup()
    _bounded(lambda: svc.run_requests(_imgs(3)))
    text = svc.healthz()
    assert text.startswith("[healthz] OK ")
    assert "device=cpu" in text and "plan_cache hits=" in text
    assert "latency p50=" in text and "steady_state_retraces=0" in text
    s = svc.stats()
    assert s["method"] == "cuda" and s["imgs_per_s"] > 0


def test_healthz_module_snapshot_and_report(capsys):
    TR.DPRT((N, N), torch.int32)(torch.ones((N, N), dtype=torch.int32))
    snap = healthz.snapshot(CPU)
    for key in ("fingerprint", "plan_cache", "plans", "traces_total",
                "traces", "aot_cache", "faults_env"):
        assert key in snap, key
    assert snap["fingerprint"] == TR.aot_fingerprint(CPU)
    assert snap["traces_total"] == sum(snap["traces"].values())
    assert "[healthz]" in healthz.report(CPU)
    assert healthz.main(["--device", "cpu"]) == 0
    assert "plan_cache" in capsys.readouterr().out


@pytest.mark.parametrize("datapath", ["forward", "solve"])
def test_serve_cli_service_smoke(capsys, datapath):
    _bounded(lambda: TSERVE.main([
        "--mode", "service", "--smoke", "--n", str(N), "--batch", "2",
        "--iters", "1", "--max-wait-us", "200", "--device", "cpu",
        "--datapath", datapath]))
    out = capsys.readouterr().out
    assert "[serve-service] warmup:" in out
    assert "coalescing speedup" in out and "responses exact=True" in out
    assert f"datapath={datapath}" in out


def test_serve_cli_refuses_only_lm():
    """Every mode of the reference's serve CLI is ported now: ``--mode
    lm`` runs (it was the last one refused)."""
    assert not hasattr(TSERVE, "NOT_PORTED")
    gen = TSERVE.main(["--mode", "lm", "--device", "cpu", "--smoke",
                       "--batch", "1", "--prompt-len", "4",
                       "--gen-tokens", "2"])
    assert tuple(gen.shape) == (1, 2)


def test_serve_cli_float_responses_agree_within_tolerance():
    a = np.linspace(0, 100, 16, dtype=np.float32).reshape(4, 4)
    assert TSERVE._agree([a], [a.copy()]) == (True, 0.0)
    ok, worst = TSERVE._agree([a + 1e-3], [a])
    assert ok and 0 < worst <= TSERVE.FLOAT_REL
    assert not TSERVE._agree([a + 1.0], [a])[0]
    i = np.arange(16, dtype=np.int32).reshape(4, 4)
    assert TSERVE._agree([i], [i.copy()]) == (True, 0.0)
    assert TSERVE._agree([i + 1], [i]) == (False, float("inf"))
