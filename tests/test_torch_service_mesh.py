"""The port's ``DPRTService`` on a mesh (``mesh=`` a DeviceMesh, the
leader rank batching and the other ranks following its turns) and
``serve --mode service --mesh-shape`` on the CPU.

* World size 1 (a ``(1, 1)`` ``("data", "model")`` gloo mesh of this
  process): each datapath's responses equal the unsharded port
  service's and the reference ``DPRTService`` on a ``(1, 1)`` JAX mesh
  (unsharded for the masked CG solve, which the reference cannot run on
  a mesh with the installed JAX),
  on the same numpy requests -- integers bit for bit, ``solve`` within
  SOLVE_REL of the image's peak; zero builds after warmup; a restart
  from ``aot_dir`` on the mesh plan builds nothing; the degraded path,
  the turn count and ``close``; the CLI.
* One slow test spawns 4 gloo ranks on a ``(2, 2)`` mesh under its own
  wall-clock limit: the leader serves every datapath, the followers run
  the same turns (``follow`` checks each turn's sequence number and
  the stop's count), the responses equal numpy oracles and the
  reference computed here, a restart from a shared ``aot_dir`` builds
  nothing on any rank, and every rank exits.
"""
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as RR
from repro.core.conv import circ_conv2d_direct
from repro.core.dprt import dprt_oracle_np
from repro.launch import service as RS
from repro_torch import radon as TR
from repro_torch.launch import serve as TSERVE
from repro_torch.launch.errors import ServiceShutdown
from repro_torch.launch.faults import FaultInjector, InjectedFault
from repro_torch.launch.service import DPRTService

from _torch_spawn import spawn_with_deadline

N = 13
CPU = torch.device("cpu")
DATAPATHS = ("forward", "inverse", "roundtrip", "conv", "solve",
             "solve_masked")
#: float32 agreement of a solve response, relative to the image's peak
#: (tests/test_torch_service.py's)
SOLVE_REL = 1e-4
#: wall-clock limit of the spawned 4-rank test, seconds
SPAWN_TIMEOUT_S = 240
KERNEL = np.arange(9, dtype=np.int32).reshape(3, 3)
MISSING = [2, 7]


@pytest.fixture(scope="module")
def mesh11():
    """A (1, 1) ("data", "model") mesh over a world-size-1 gloo group of
    this process, closed after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import close_world, init_world
    opened = not dist.is_initialized()
    init_world("cpu")
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    if opened:
        close_world()


#: seconds any one event-loop run in this process may take
TIMEOUT_S = 120


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


def _imgs(count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, (N, N), dtype=np.int32)
            for _ in range(count)]


def _requests(datapath, imgs):
    """The requests of ``datapath`` for phantom-like ``imgs``: images,
    or their projections (int32 for inverse, float32 for solve, masked
    for the masked solve)."""
    if datapath in ("forward", "roundtrip", "conv"):
        return imgs
    proj = [dprt_oracle_np(x).astype(np.int32) for x in imgs]
    if datapath == "inverse":
        return proj
    if datapath == "solve":
        return [p.astype(np.float32) for p in proj]
    keep = np.ones((N + 1, 1), np.float32)
    keep[MISSING] = 0
    return [p.astype(np.float32) * keep for p in proj]


def _knobs(datapath, mask):
    """DPRTService keywords of ``datapath`` (``mask``: the direction
    mask in the package's own array type)."""
    dp = "solve" if datapath == "solve_masked" else datapath
    kw = {"datapath": dp, "max_batch": 4, "max_wait_us": 200.0}
    if dp == "conv":
        kw["conv_kernel"] = KERNEL
    if datapath == "solve_masked":
        kw.update(solver="cg", solve_tol=1e-6, solve_maxiter=100,
                  solve_mask=mask)
    return kw


def _port(datapath, **kw):
    return DPRTService((N, N), torch.int32, device=CPU,
                       **_knobs(datapath, TR.direction_mask(
                           N, MISSING, device=CPU)), **kw)


def _agree(datapath, got, want):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if datapath.startswith("solve"):
            tol = SOLVE_REL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("datapath", DATAPATHS)
def test_mesh_service_matches_unsharded_and_reference(mesh11, datapath):
    reqs = _requests(datapath, _imgs(6, seed=3))
    rkw = _knobs(datapath, RR.direction_mask(N, MISSING))
    if "conv_kernel" in rkw:
        rkw["conv_kernel"] = jnp.asarray(rkw["conv_kernel"])
    # the reference's masked CG on a mesh raises a ShardingTypeError on
    # the installed JAX (a scatter of its residual norms): its unsharded
    # service is the reference there
    if datapath != "solve_masked":
        rkw["mesh"] = jax.make_mesh((1, 1), ("data", "model"))
    ref = RS.DPRTService((N, N), jnp.int32, **rkw)
    ref.warmup()
    want = _bounded(lambda: ref.run_requests(reqs))
    plain = _port(datapath)
    plain.warmup()
    unsharded = _bounded(lambda: plain.run_requests(reqs))
    svc = _port(datapath, mesh=mesh11)
    assert svc.stats()["method"] == "sharded_cuda"
    assert svc.request_shape == plain.request_shape
    svc.warmup()
    got = _bounded(lambda: svc.run_requests(reqs))
    seq, _ = svc.run_sequential(reqs)
    _agree(datapath, got, want)
    _agree(datapath, got, unsharded)
    _agree(datapath, seq, unsharded)
    s = svc.stats()
    assert s["requests"] == 6 and s["failures"] == 0
    assert s["fallback_uses"] == 0 and svc.healthy()
    assert s["steady_state_retraces"] == 0
    # one turn per batch, coalesced and sequential
    assert svc.turns == s["batches"] + len(reqs)
    assert svc.close() == 0


def test_mesh_service_aot_restart_zero_builds(mesh11, tmp_path):
    TR.aot_cache_clear()
    svc1 = _port("conv", mesh=mesh11, aot_dir=str(tmp_path))
    info1 = svc1.warmup()
    p1 = info1["persistent"]
    assert p1["misses"] == info1["executables"] and p1["hits"] == 0
    want = _bounded(lambda: svc1.run_requests(_imgs(3)))
    svc1.close()
    # a restart on the same mesh: in-memory executables gone, blobs stay
    TR.aot_cache_clear()
    t0 = TR.trace_count()
    svc2 = _port("conv", mesh=mesh11, aot_dir=str(tmp_path))
    info2 = svc2.warmup()
    p2 = info2["persistent"]
    assert p2["hits"] == info2["executables"]
    assert p2["misses"] == p2["errors"] == 0
    assert TR.trace_count() == t0          # the restore built nothing
    _agree("conv", _bounded(lambda: svc2.run_requests(_imgs(3))), want)
    assert svc2.healthy() and svc2.close() == 0
    # another mesh shape, or none, keys other blobs: it compiles its own
    from torch.distributed.device_mesh import init_device_mesh
    mesh1 = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    for kw in ({"mesh": mesh1}, {}):
        svc3 = _port("conv", aot_dir=str(tmp_path), **kw)
        p3 = svc3.warmup()["persistent"]
        assert p3["hits"] == 0 and p3["misses"] == info2["executables"]
        svc3.close()
    TR.aot_cache_clear()


def test_mesh_service_fallback_turns_and_close(mesh11):
    svc = _port("roundtrip", mesh=mesh11, fallback=True)
    svc.warmup()
    stack = np.stack(_imgs(3, seed=5))
    primary = svc.execute(stack)
    turns = svc.turns
    np.testing.assert_array_equal(svc.execute_fallback(stack), primary)
    np.testing.assert_array_equal(primary, stack)
    assert svc.turns == turns + 1
    assert svc.stats()["fallback_uses"] == 1
    with pytest.raises(RuntimeError, match="other than its first"):
        svc.follow()                    # the leader does not follow
    assert svc.close() == 0
    assert svc.close() is None          # once
    with pytest.raises(ServiceShutdown, match="closed"):
        svc.execute(stack)
    # without a mesh there is nothing to close or follow
    plain = _port("forward")
    assert plain.close() is None and plain.turns == 0
    with pytest.raises(RuntimeError, match="other than its first"):
        plain.follow()


def test_serve_cli_mesh_service(mesh11, capsys):
    for dp in ("forward", "conv"):
        out = TSERVE.main(["--mode", "service", "--mesh-shape", "1,1",
                           "--device", "cpu", "--smoke", "--datapath", dp,
                           "--iters", "1"])
        assert len(out) == 16
        text = capsys.readouterr().out
        assert "[healthz] OK" in text and "method=sharded_cuda" in text
        assert "responses exact=True" in text
        assert "builds after warmup on every rank: 0" in text
    with pytest.raises(SystemExit, match="needs --mesh-shape"):
        TSERVE.main(["--mode", "service", "--method", "sharded_cuda",
                     "--device", "cpu", "--smoke"])


# ---------------------------------------------------------------------------
# 4 gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------
SPAWN_DATAPATHS = ("forward", "inverse", "roundtrip", "conv",
                   "solve_masked")


def _spawn_expected():
    """What the leader's responses must equal, computed here: numpy
    oracles for the integer datapaths, the reference service's masked
    CG solve."""
    imgs = _imgs(7, seed=11)
    kimg = np.zeros((N, N), np.int32)
    kimg[:3, :3] = KERNEL
    want = {"forward": [dprt_oracle_np(x).astype(np.int32) for x in imgs],
            "inverse": imgs, "roundtrip": imgs,
            "conv": [np.asarray(circ_conv2d_direct(x, kimg))
                     for x in imgs]}
    reqs = _requests("solve_masked", imgs)
    ref = RS.DPRTService((N, N), jnp.int32,
                         **_knobs("solve_masked",
                                  RR.direction_mask(N, MISSING)))
    ref.warmup()
    want["solve_masked"] = [np.asarray(w) for w in
                            _bounded(lambda: ref.run_requests(reqs))]
    return imgs, want


def _spawn_worker(rank, world, port, imgs, want, aot_dir):
    """One rank: every SPAWN_DATAPATHS service on the (2, 2) mesh, then
    a restart from ``aot_dir``; the leader checks the responses."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for restart in (False, True):
            TR.aot_cache_clear()
            t0 = TR.trace_count()
            hits = 0
            for dp in SPAWN_DATAPATHS:
                svc = _port(dp, mesh=mesh, aot_dir=aot_dir)
                info = svc.warmup()["persistent"]
                hits += info["hits"]
                if restart:     # every rank restores what rank 0 saved
                    assert info["misses"] == info["errors"] == 0, info
                if rank != 0:
                    svc.follow()
                    continue
                reqs = _requests(dp, imgs)
                got = svc.run_requests(reqs)
                seq, _ = svc.run_sequential(reqs)
                _agree(dp, got, want[dp])
                _agree(dp, seq, want[dp])
                stack = np.stack(reqs[:3])
                primary = svc.execute(stack)
                np.testing.assert_array_equal(svc.execute_fallback(stack),
                                              primary)
                # a fault at either seam fails on the leader before its
                # turn: the followers are never left in a collective
                for site in ("dispatch", "fallback"):
                    with FaultInjector(sites=(site,), error_count=1):
                        with pytest.raises(InjectedFault):
                            (svc.execute if site == "dispatch"
                             else svc.execute_fallback)(stack)
                np.testing.assert_array_equal(svc.execute(stack), primary)
                assert svc.stats()["failures"] == 0
                assert svc.close() == 0
            if restart:
                assert TR.trace_count() == t0, "a restart built"
                assert hits > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_four_gloo_ranks_serve_the_same_turns(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    imgs, want = _spawn_expected()
    procs = spawn_with_deadline(_spawn_worker, 4,
                                (4, port, imgs, want, str(tmp_path)),
                                SPAWN_TIMEOUT_S)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
