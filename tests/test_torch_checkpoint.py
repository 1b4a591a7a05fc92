"""The port's blob store (``repro_torch.checkpoint.store``) against the
JAX package's (``repro.checkpoint.store``) on the CPU.

Mirrors the blob half of ``tests/test_checkpoint.py`` and the lock tests
of ``tests/test_pool.py``: header/payload integrity, corruption
semantics, key sanitization, atomic publish, and the cross-process
advisory lock (contention, a dead PID's lock stolen, a live holder
respected until the timeout, an aged lock stolen).  The on-disk format
is the reference's: a blob written by either package loads in the
other, under the same file name.
"""
import json
import os
import subprocess
import threading
import time

import pytest

from repro.checkpoint import store as RS
from repro_torch.checkpoint import store as TS

PAYLOAD = bytes(range(256)) * 3


def _wait_for(cond, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("timed out")


# ---------------------------------------------------------------------------
# keyed blobs
# ---------------------------------------------------------------------------
def test_blob_roundtrip_with_meta(tmp_path):
    d = str(tmp_path)
    path = TS.save_blob(d, "exe_v1", PAYLOAD, meta={"fingerprint": "cpu1"})
    assert os.path.isfile(path) and path.endswith(".blob")
    data, meta = TS.load_blob(d, "exe_v1")
    assert data == PAYLOAD and meta == {"fingerprint": "cpu1"}
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_blob_format_is_shared_with_the_reference(tmp_path, writer, reader):
    d = str(tmp_path)
    save = (TS if writer == "port" else RS).save_blob
    load = (TS if reader == "port" else RS).load_blob
    key = "forward_2x13x13/int32 cuda"
    path = save(d, key, PAYLOAD, meta={"fingerprint": "f", "n": [1, 2]})
    assert path == TS._blob_path(d, key) == RS._blob_path(d, key)
    data, meta = load(d, key)
    assert data == PAYLOAD and meta == {"fingerprint": "f", "n": [1, 2]}
    lister = (TS if reader == "port" else RS).list_blobs
    assert lister(d) == [key]


def test_blob_bytes_match_the_reference_layout(tmp_path):
    d = str(tmp_path)
    TS.save_blob(d, "k", b"abc", meta={"v": 1})
    raw = open(TS._blob_path(d, "k"), "rb").read()
    hlen = int.from_bytes(raw[:8], "big")
    header = json.loads(raw[8:8 + hlen])
    assert set(header) == {"key", "meta", "size", "time"}
    assert (header["key"], header["meta"], header["size"]) == ("k",
                                                               {"v": 1}, 3)
    assert raw[8 + hlen:] == b"abc"


def test_blob_missing_returns_none(tmp_path):
    assert TS.load_blob(str(tmp_path), "nope") == (None, None)
    assert TS.load_blob(str(tmp_path / "no_dir"), "nope") == (None, None)


def test_blob_overwrite_replaces(tmp_path):
    d = str(tmp_path)
    TS.save_blob(d, "k", b"old", meta={"v": 1})
    TS.save_blob(d, "k", b"new", meta={"v": 2})
    assert TS.load_blob(d, "k") == (b"new", {"v": 2})
    assert TS.list_blobs(d) == ["k"]


@pytest.mark.parametrize("damage", ["torn", "garbage_header"])
def test_blob_corruption_raises_in_both_packages(tmp_path, damage):
    d = str(tmp_path)
    path = TS.save_blob(d, "k", b"x" * 100)
    raw = open(path, "rb").read()
    raw = raw[:-10] if damage == "torn" else b"\x00" * 8 + b"{nope" + raw[13:]
    open(path, "wb").write(raw)
    for mod in (TS, RS):
        with pytest.raises(ValueError, match="corrupt blob"):
            mod.load_blob(d, "k")


def test_blob_key_sanitized_but_preserved(tmp_path):
    d = str(tmp_path)
    key = "conv2d_1x13x13/int32:k=abc def"
    path = TS.save_blob(d, key, b"abc")
    assert "/" not in os.path.basename(path)[:-len(".blob")]
    assert TS.load_blob(d, key)[0] == b"abc"
    assert TS.list_blobs(d) == [key]


def test_list_blobs_skips_corrupt_entries(tmp_path):
    d = str(tmp_path)
    TS.save_blob(d, "good", b"1")
    with open(os.path.join(d, "bad.blob"), "wb") as f:
        f.write(b"\xff" * 16)
    assert TS.list_blobs(d) == RS.list_blobs(d) == ["good"]
    assert TS.list_blobs(str(tmp_path / "missing")) == []


def test_delete_blob(tmp_path):
    d = str(tmp_path)
    TS.save_blob(d, "k", b"1")
    assert TS.delete_blob(d, "k") is True
    assert TS.load_blob(d, "k") == (None, None)
    assert TS.delete_blob(d, "k") is False


# ---------------------------------------------------------------------------
# cross-process per-key advisory locks
# ---------------------------------------------------------------------------
def test_blob_lock_acquire_release(tmp_path):
    d = str(tmp_path)
    lock_file = TS._blob_path(d, "tok") + ".lock"
    with TS.blob_lock(d, "tok") as lk:
        assert json.load(open(lock_file))["pid"] == os.getpid()
        assert lk["steals"] == 0
        # the reference's lock sees the port's: same file, so one
        # process of either package excludes the other
        with pytest.raises(RS.LockTimeout):
            with RS.blob_lock(d, "tok", poll_s=0.01, timeout_s=0.1):
                pass
    assert not os.path.exists(lock_file)


def test_blob_lock_contention_waits(tmp_path):
    d = str(tmp_path)
    order = []

    def holder():
        with TS.blob_lock(d, "tok"):
            order.append("a-in")
            time.sleep(0.3)
            order.append("a-out")

    t = threading.Thread(target=holder)
    t.start()
    _wait_for(lambda: order == ["a-in"])
    with TS.blob_lock(d, "tok", poll_s=0.01, timeout_s=30.0) as lk:
        order.append("b-in")
    t.join(timeout=30)
    assert order == ["a-in", "a-out", "b-in"]
    assert lk["waited_s"] > 0.1 and lk["steals"] == 0


def test_blob_lock_steals_dead_pid(tmp_path):
    d = str(tmp_path)
    corpse = subprocess.Popen(["sleep", "0"])
    corpse.wait(timeout=30)
    lock_file = TS._blob_path(d, "tok") + ".lock"
    with open(lock_file, "w") as f:
        json.dump({"pid": corpse.pid, "key": "tok", "time": time.time()}, f)
    with TS.blob_lock(d, "tok", poll_s=0.01, timeout_s=30.0) as lk:
        assert lk["steals"] >= 1            # dead holder reclaimed
    assert not os.path.exists(lock_file)


def test_blob_lock_respects_live_holder_then_times_out(tmp_path):
    d = str(tmp_path)
    lock_file = TS._blob_path(d, "tok") + ".lock"
    with open(lock_file, "w") as f:         # held by THIS live process
        json.dump({"pid": os.getpid(), "key": "tok", "time": time.time()},
                  f)
    with pytest.raises(TS.LockTimeout):
        with TS.blob_lock(d, "tok", poll_s=0.02, timeout_s=0.2,
                          stale_s=100.0):
            pass
    assert os.path.exists(lock_file)        # never stolen from the living
    os.unlink(lock_file)


def test_blob_lock_steals_aged_lock(tmp_path):
    d = str(tmp_path)
    lock_file = TS._blob_path(d, "tok") + ".lock"
    with open(lock_file, "w") as f:         # live PID but ancient
        json.dump({"pid": os.getpid(), "key": "tok",
                   "time": time.time() - 3600.0}, f)
    with TS.blob_lock(d, "tok", stale_s=1.0, poll_s=0.01,
                      timeout_s=30.0) as lk:
        assert lk["steals"] >= 1
