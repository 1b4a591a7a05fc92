"""The port's multi-process tier (``repro_torch.launch.pool`` and
``repro_torch.launch.supervisor``) against the JAX reference's on the CPU.

Mirrors ``tests/test_pool.py``.  Frames, digests and the journal's WAL
are byte-identical to the reference's for the same inputs; the typed
error codes and the env-armed fault injector behave the same.  The
quick tier drives :class:`WorkerPool` against the jax-free stub worker
``tests/_pool_stub.py`` (dispatch, replay after a crash, restart, typed
worker loss, the pending budget, typed passthrough, probes, drain); the
``slow`` tests spawn real ``python -m repro_torch.launch.serve`` workers
on the CPU (``--device cpu``) for the SIGTERM drain, cross-process
compile coalescing past stale locks, and a pool end to end.  Every
subprocess call and every wait is bounded.
"""
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.launch import errors as RE
from repro.launch import pool as RP
from repro_torch import radon as TR
from repro_torch.checkpoint.store import _blob_path, list_blobs
from repro_torch.launch import errors as TE
from repro_torch.launch.errors import (QueueFull, ServiceError, WorkerLost,
                                       error_for_code)
from repro_torch.launch.faults import (FaultInjector, active_injector,
                                       install_from_env)
from repro_torch.launch.pool import (RequestJournal, payload_digest,
                                     read_frame, write_frame)
from repro_torch.launch.supervisor import WorkerPool, default_worker_cmd

HERE = os.path.dirname(os.path.abspath(__file__))
STUB = os.path.join(HERE, "_pool_stub.py")
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
N = 13
TIMEOUT_S = 60


def stub_pool(n_workers=2, *, stub_env=None, **kw):
    env = dict(os.environ)
    env.update(stub_env or {})
    kw.setdefault("probe_interval_s", 0.1)
    kw.setdefault("drain_timeout_s", 10.0)
    return WorkerPool(n_workers, cmd=[sys.executable, STUB], env=env, **kw)


def wait_for(cond, timeout_s=15.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# frame protocol, digests, journal: the reference's bytes
# ---------------------------------------------------------------------------
MSGS = [{"op": "submit", "id": "r1", "data": [[1, 2], [3, 4]]},
        {"ok": True, "nested": {"a": [1.5, None, "x"], "u": "é"}},
        {"id": "__probe__", "op": "healthz"}]


def test_frames_are_byte_identical_to_the_reference():
    port, ref = io.StringIO(), io.StringIO()
    for m in MSGS:
        write_frame(port, m)
        RP.write_frame(ref, m)
    assert port.getvalue() == ref.getvalue()
    for reader in (read_frame, RP.read_frame):
        buf = io.StringIO(ref.getvalue())
        assert [reader(buf) for _ in MSGS] == MSGS
        assert reader(buf) is None           # EOF


@pytest.mark.parametrize("noise", ["some stray log line\n\n",
                                   "[warning] x\n-3\n99999999999\n"])
def test_frame_reader_skips_noise_like_the_reference(noise):
    raw = noise + "".join(f"{len(p)}\n{p}\n" for p in
                          (json.dumps(m, separators=(",", ":"))
                           for m in MSGS))
    for reader in (read_frame, RP.read_frame):
        buf = io.StringIO(raw)
        assert [reader(buf) for _ in MSGS] == MSGS


def test_frame_torn_write_reads_as_eof():
    buf = io.StringIO()
    write_frame(buf, {"id": 1, "data": [0] * 50})
    whole = buf.getvalue()
    assert read_frame(io.StringIO(whole)) == {"id": 1, "data": [0] * 50}
    assert read_frame(io.StringIO(whole[:len(whole) - 20])) is None
    assert RP.read_frame(io.StringIO(whole[:len(whole) - 20])) is None


@pytest.mark.parametrize("arr", [np.arange(12, dtype=np.int32).reshape(3, 4),
                                 np.arange(12, dtype=np.int64).reshape(4, 3),
                                 np.linspace(0, 1, 7, dtype=np.float32),
                                 np.zeros((N, N), np.int32)])
def test_payload_digest_matches_the_reference(arr):
    assert payload_digest(arr) == RP.payload_digest(arr)
    assert payload_digest(arr) == payload_digest(arr.copy())
    assert payload_digest(arr) != payload_digest(arr.astype(np.float64))


def test_journal_counts_and_wal_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    outs = []
    for mod, name in ((RequestJournal, "port"), (RP.RequestJournal, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod(path)
        j.record("dispatch", "r1", worker=0, digest="abc")
        j.record("replay", "r1", worker=1, digest="abc")
        j.record("deliver", "r1", replayed=True)
        j.record("lost", "r2", digest="def")
        assert j.stats() == {"dispatch": 1, "deliver": 1, "typed": 0,
                             "fail": 0, "replay": 1, "lost": 1}
        with pytest.raises(ValueError):
            j.record("nonsense", "r3")
        j.close()
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]
    events = [json.loads(line) for line in outs[0].splitlines()]
    assert [e["ev"] for e in events] == ["dispatch", "replay", "deliver",
                                         "lost"]
    assert events[0]["digest"] == events[1]["digest"]


@pytest.mark.parametrize("code", ["service_error", "deadline_exceeded",
                                  "queue_full", "shutdown", "worker_lost",
                                  "no_such_code"])
def test_error_codes_match_the_reference(code):
    port, ref = error_for_code(code, "m", 1.25), RE.error_for_code(code, "m",
                                                                   1.25)
    assert type(port).__name__ == type(ref).__name__
    assert port.code == ref.code and port.retry_after_s == 1.25
    assert isinstance(port, ServiceError)
    assert {c.__name__: c.code for c in TE._CODE_MAP.values()} == \
        {c.__name__: c.code for c in RE._CODE_MAP.values()}


def test_fault_injector_from_spec():
    inj = FaultInjector.from_spec(
        "sites=dispatch|fallback;error_count=2;seed=7;match=13x13;"
        "delay_s=0.001;delay_rate=0.5;error_rate=0.25")
    assert inj.sites == ("dispatch", "fallback")
    assert inj.error_count == 2 and inj.seed == 7
    assert inj.match == "13x13" and inj.error_rate == 0.25
    assert inj.delay_s == 0.001 and inj.delay_rate == 0.5
    assert inj.stats()["spec"] == inj.spec and "error_count=2" in inj.spec
    with pytest.raises(ValueError):
        FaultInjector.from_spec("unknown_knob=1")
    with pytest.raises(ValueError):
        FaultInjector.from_spec("error_count")


def test_install_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    assert install_from_env() is None
    monkeypatch.setenv("REPRO_FAULTS", "sites=dispatch;error_count=1")
    inj = install_from_env()
    try:
        assert inj is not None and active_injector() is inj
        with pytest.raises(Exception):
            inj.perturb("dispatch", "any")
    finally:
        inj.__exit__(None, None, None)
    assert active_injector() is not inj


def test_default_worker_cmd_passes_the_device():
    cmd = default_worker_cmd(aot_dir="/x", manifest=[{"n": N}], max_batch=4,
                             device="cpu")
    assert cmd[1:3] == ["-m", "repro_torch.launch.serve"]
    for flag in ("--jsonl", "--framed", "--sigterm-drain"):
        assert flag in cmd
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert json.loads(cmd[cmd.index("--manifest") + 1]) == [{"n": N}]
    pool = WorkerPool(1, aot_dir="/x", manifest=[{"n": N}], device="cpu")
    assert pool.worker_cmd()[-2:] == ["--device", "cpu"]


# ---------------------------------------------------------------------------
# WorkerPool against the stub worker
# ---------------------------------------------------------------------------
def test_pool_roundtrip_and_identity():
    with stub_pool(2) as pool:
        assert pool.wait_ready(20.0)
        imgs = [np.full((2, 2), i, np.int64) for i in range(8)]
        futs = [pool.submit({"n": 2}, im) for im in imgs]
        outs = [f.result(timeout=TIMEOUT_S) for f in futs]
        for i, out in enumerate(outs):
            assert np.array_equal(out, 2 * imgs[i])
        report = pool.healthz(probe=True)
    assert report["identity_ok"]
    assert report["admitted"] == report["delivered"] == 8
    assert pool.verdict() == "OK"
    assert pool.journal.stats()["dispatch"] == 8
    assert pool.journal.stats()["deliver"] == 8
    assert all(w["pid"] for w in report["workers"])
    assert "[healthz] OK pool workers=" in pool.healthz_text(report)


def test_pool_sigkill_replays_then_restarts():
    with stub_pool(2, stub_env={"STUB_DELAY_S": "0.25"},
                   restart_backoff_s=0.1) as pool:
        assert pool.wait_ready(20.0)
        imgs = [np.full((2, 2), i, np.int64) for i in range(6)]
        futs = [pool.submit({"n": 2}, im) for im in imgs]
        time.sleep(0.05)
        assert pool.kill_worker(0)
        outs = [f.result(timeout=TIMEOUT_S) for f in futs]
        for i, out in enumerate(outs):
            assert np.array_equal(out, 2 * imgs[i])
        assert pool.replays > 0 and pool.workers_lost == 1
        wait_for(lambda: pool._workers[0].alive, 20.0, "worker restart")
        assert pool.wait_ready(20.0)
        out = pool.submit({"n": 2}, imgs[0]).result(timeout=TIMEOUT_S)
        assert np.array_equal(out, 2 * imgs[0])
        assert pool.worker_restarts >= 1
    assert pool.identity_ok() and pool.failed == 0
    assert pool.verdict() == "WARN"
    j = pool.journal.stats()
    assert j["replay"] > 0 and j["lost"] == 0


def test_pool_single_worker_loss_is_typed_worker_lost():
    with stub_pool(1, stub_env={"STUB_DELAY_S": "0.4"},
                   max_restarts=0) as pool:
        assert pool.wait_ready(20.0)
        futs = [pool.submit({"n": 2}, np.ones((2, 2), np.int64))
                for _ in range(3)]
        time.sleep(0.05)
        assert pool.kill_worker(0)
        for f in futs:
            with pytest.raises(WorkerLost):
                f.result(timeout=TIMEOUT_S)
    assert pool.rejected.get("worker_lost") == 3
    assert pool.identity_ok() and pool.pending() == 0
    assert pool.journal.stats()["lost"] == 3


def test_pool_crash_exit_detected_without_external_kill():
    with stub_pool(2, stub_env={"STUB_EXIT_AFTER": "2",
                                "STUB_DELAY_S": "0.05"},
                   restart_backoff_s=0.1) as pool:
        assert pool.wait_ready(20.0)
        futs = [pool.submit({"n": 2}, np.ones((2, 2), np.int64))
                for _ in range(10)]
        done = 0
        for f in futs:
            try:
                f.result(timeout=TIMEOUT_S)
                done += 1
            except ServiceError:
                pass
        assert done > 0 and pool.workers_lost >= 1
    assert pool.identity_ok() and pool.failed == 0


def test_pool_pending_budget_rejects_with_retry_hint():
    with stub_pool(1, stub_env={"STUB_DELAY_S": "0.3"},
                   pending_cap=3) as pool:
        assert pool.wait_ready(20.0)
        futs, hints = [], []
        for _ in range(8):
            try:
                futs.append(pool.submit({"n": 2},
                                        np.ones((2, 2), np.int64)))
            except QueueFull as e:
                hints.append(e.retry_after_s)
        assert len(futs) == 3 and len(hints) == 5
        assert all(h is not None and h > 0 for h in hints)
        for f in futs:
            f.result(timeout=TIMEOUT_S)
    assert pool.rejected_admission.get("queue_full") == 5
    assert pool.identity_ok() and pool.verdict() == "WARN"


def test_pool_typed_error_passthrough_with_hint():
    with stub_pool(1) as pool:
        assert pool.wait_ready(20.0)
        fut = pool.submit({"n": 2, "stub_error": "queue_full",
                           "retry_after_s": 1.5}, np.ones((2, 2), np.int64))
        with pytest.raises(QueueFull) as ei:
            fut.result(timeout=TIMEOUT_S)
        assert ei.value.retry_after_s == 1.5
    assert pool.rejected.get("queue_full") == 1 and pool.identity_ok()


def test_pool_probe_suspect_kill_of_hung_worker():
    with stub_pool(1, stub_env={"STUB_MUTE_AFTER": "1"},
                   probe_interval_s=0.05, probe_misses=2,
                   max_restarts=0) as pool:
        pool.wait_ready(5.0)
        wait_for(lambda: pool.suspect_kills >= 1, 15.0,
                 "suspect kill of the mute worker")
    assert pool.workers_lost >= 1 and pool.verdict() == "WARN"


def test_pool_drain_flushes_in_flight():
    pool = stub_pool(2, stub_env={"STUB_DELAY_S": "0.15"})
    pool.start()
    assert pool.wait_ready(20.0)
    imgs = [np.full((2, 2), i, np.int64) for i in range(4)]
    futs = [pool.submit({"n": 2}, im) for im in imgs]
    pool.drain()
    for i, f in enumerate(futs):
        assert f.done(), "drain left a future unresolved"
        try:
            assert np.array_equal(f.result(), 2 * imgs[i])
        except ServiceError:
            pass                            # typed shutdown is legal too
    assert pool.identity_ok() and pool.pending() == 0 and pool.failed == 0
    with pytest.raises(ServiceError):
        pool.submit({"n": 2}, imgs[0])


# ---------------------------------------------------------------------------
# real router workers on the CPU (slow: each spawn imports torch)
# ---------------------------------------------------------------------------
def worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker(args, aot):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "service", "--jsonl", "--batch", "2", "--manifest",
         json.dumps([{"n": N}]), "--aot-dir", aot, "--device", "cpu",
         *args], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=worker_env())


def _oracle(img):
    return TR.DPRT((1, N, N), torch.int32)(
        torch.from_numpy(img[None]))[0].numpy()


@pytest.mark.slow
def test_jsonl_sigterm_drains_and_emits_final_healthz(tmp_path):
    proc = _worker(["--sigterm-drain"], str(tmp_path))
    try:
        img = np.ones((N, N), np.int32)
        proc.stdin.write(json.dumps({"op": "submit", "id": "r1", "n": N,
                                     "data": img.tolist()}) + "\n")
        proc.stdin.flush()
        first = json.loads(proc.stdout.readline())
        assert first["id"] == "r1" and first["ok"]
        np.testing.assert_array_equal(np.asarray(first["data"]),
                                      _oracle(img))
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=TIMEOUT_S)
        rc = proc.returncode
    finally:
        proc.kill()
    assert rc == 0, "SIGTERM must drain, not kill the worker"
    finals = [json.loads(line) for line in rest.splitlines()
              if line.strip()]
    finals = [m for m in finals if m.get("id") == "__drain__"]
    assert finals and finals[-1].get("final") is True
    assert finals[-1]["verdict"] in ("OK", "WARN")
    assert finals[-1]["stats"]["pending"] == 0


@pytest.mark.slow
def test_cross_process_compile_coalescing_and_stale_lock(tmp_path):
    """Two fresh workers cold-start one aot_dir concurrently: one compile
    per cache token; a third comes up warm past stale dead-PID locks."""
    aot = str(tmp_path / "aot")

    def healthz(proc):
        write_frame(proc.stdin, {"op": "healthz", "id": "h"})
        while True:
            msg = read_frame(proc.stdout)
            assert msg is not None, "worker died before healthz reply"
            if msg.get("id") == "h":
                return msg

    def shutdown(proc):
        write_frame(proc.stdin, {"op": "shutdown", "id": "bye"})
        assert proc.wait(timeout=TIMEOUT_S) == 0

    p1, p2 = _worker(["--framed"], aot), _worker(["--framed"], aot)
    try:
        h1, h2 = healthz(p1), healthz(p2)
        shutdown(p1)
        shutdown(p2)
    finally:
        p1.kill()
        p2.kill()
    blobs = list_blobs(aot)
    assert blobs
    misses = h1["persistent"]["misses"] + h2["persistent"]["misses"]
    hits = h1["persistent"]["hits"] + h2["persistent"]["hits"]
    assert misses == len(blobs) and hits == len(blobs)
    assert not [f for f in os.listdir(aot) if f.endswith(".lock")]
    corpse = subprocess.Popen(["sleep", "0"])
    corpse.wait(timeout=TIMEOUT_S)
    for key in blobs:
        with open(_blob_path(aot, key) + ".lock", "w") as f:
            json.dump({"pid": corpse.pid, "key": key,
                       "time": time.time() - 3600.0}, f)
    p3 = _worker(["--framed"], aot)
    try:
        h3 = healthz(p3)
        shutdown(p3)
    finally:
        p3.kill()
    assert h3["persistent"]["misses"] == 0
    assert h3["persistent"]["hits"] == len(blobs)
    assert h3["persistent"]["lock_steals"] >= len(blobs)
    assert not [f for f in os.listdir(aot) if f.endswith(".lock")]


@pytest.mark.slow
def test_pool_of_real_workers_end_to_end(tmp_path):
    aot = str(tmp_path / "aot")
    spec = "sites=dispatch;error_count=1;seed=3"
    env = worker_env()
    env["REPRO_FAULTS"] = spec
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 50, (N, N)).astype(np.int32) for _ in range(8)]
    pool = WorkerPool(2, aot_dir=aot, manifest=[{"n": N}], max_batch=2,
                      env=env, probe_interval_s=1.0, device="cpu",
                      drain_timeout_s=TIMEOUT_S)
    with pool:
        assert pool.wait_ready(float(TIMEOUT_S))
        futs = [pool.submit({"n": N}, im) for im in imgs]
        outs = [f.result(timeout=TIMEOUT_S) for f in futs]
        report = pool.healthz(probe=True)
    for out, img in zip(outs, imgs):
        np.testing.assert_array_equal(np.asarray(out), _oracle(img))
    assert report["identity_ok"] and report["delivered"] == len(imgs)
    for w in report["workers"]:
        assert w["faults_env"] == spec
        assert w["retraces_since_start"] == 0
    misses = sum(w["persistent"]["misses"] for w in report["workers"])
    assert misses == len(list_blobs(aot))


@pytest.mark.slow
def test_serve_pool_chaos_cli_passes():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "pool",
         "--chaos", "--smoke", "--device", "cpu"], capture_output=True,
        text=True, env=worker_env(), timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[pool-chaos] PASS" in proc.stdout
