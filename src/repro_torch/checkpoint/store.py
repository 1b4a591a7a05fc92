"""Keyed binary blobs and cross-process locks: the port's blob store.

The blob half of :mod:`repro.checkpoint.store` -- ``save_blob``,
``load_blob``, ``list_blobs``, ``delete_blob``, ``blob_lock`` and
``LockTimeout`` -- copied, with the same on-disk format, so a blob
written by either package loads in the other.  The persistent AOT cache
(:class:`repro_torch.radon.PersistentAOTCache`) rides on it.  The
pytree-checkpoint half (``save_checkpoint``, ``AsyncCheckpointer``) is
not ported yet.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Dict, Optional

__all__ = ["save_blob", "load_blob", "list_blobs", "delete_blob",
           "blob_lock", "LockTimeout"]


# ---------------------------------------------------------------------------
# keyed binary blobs (the persistent AOT-executable cache rides this)
#
# One file per key: an 8-byte big-endian header length, a JSON header
# {"key", "meta", "size"}, then the payload -- written to ``.tmp`` and
# atomically renamed like the step checkpoints, so readers never see a
# torn blob and a crash mid-write leaves only an ignorable ``.tmp``.
# ---------------------------------------------------------------------------
_BLOB_SUFFIX = ".blob"


def _blob_path(directory: str, key: str) -> str:
    fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + _BLOB_SUFFIX
    return os.path.join(directory, fname)


def save_blob(directory: str, key: str, data: bytes,
              meta: Optional[Dict] = None) -> str:
    """Atomically persist ``data`` under ``key``; returns the file path.

    ``meta`` (JSON-serializable) travels in the header and comes back
    from :func:`load_blob` -- version/topology stamps live there so a
    stale blob can be rejected without deserializing the payload.
    """
    os.makedirs(directory, exist_ok=True)
    final = _blob_path(directory, key)
    header = json.dumps({"key": key, "meta": meta or {},
                         "size": len(data), "time": time.time()}).encode()
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(header).to_bytes(8, "big"))
        f.write(header)
        f.write(data)
        # fsync BEFORE the rename: os.replace is atomic in the
        # namespace but not in the page cache -- without this, a crash
        # after the rename can leave a truncated file under the FINAL
        # name, which readers would see as a corrupt (not absent) blob
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)         # atomic publish
    try:                           # persist the rename itself
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:                # platform without dir fsync: best effort
        pass
    return final


def load_blob(directory: str, key: str):
    """``(data, meta)`` for ``key``, or ``(None, None)`` when absent.

    A torn or unparsable blob raises ``ValueError`` (callers treat that
    as a cache miss and overwrite it).
    """
    path = _blob_path(directory, key)
    if not os.path.isfile(path):
        return None, None
    with open(path, "rb") as f:
        raw = f.read()
    try:
        hlen = int.from_bytes(raw[:8], "big")
        header = json.loads(raw[8:8 + hlen].decode())
        data = raw[8 + hlen:]
        if header.get("key") != key or len(data) != header.get("size"):
            raise ValueError("header/key/size mismatch")
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt blob for key {key!r} at {path}: {e}")
    return data, header.get("meta", {})


def list_blobs(directory: str) -> list:
    """Keys of every intact-looking blob in ``directory`` (by header)."""
    if not os.path.isdir(directory):
        return []
    keys = []
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(_BLOB_SUFFIX):
            continue
        path = os.path.join(directory, fname)
        try:
            with open(path, "rb") as f:
                hlen = int.from_bytes(f.read(8), "big")
                if hlen > os.path.getsize(path):   # garbage length prefix
                    continue
                header = json.loads(f.read(hlen).decode())
            keys.append(header["key"])
        except (OSError, ValueError, KeyError, UnicodeDecodeError):
            continue
    return keys


def delete_blob(directory: str, key: str) -> bool:
    """Remove ``key``'s blob; True if something was deleted."""
    path = _blob_path(directory, key)
    try:
        os.remove(path)
        return True
    except FileNotFoundError:
        return False


# ---------------------------------------------------------------------------
# cross-process per-key advisory locks
#
# N worker processes cold-starting against one blob directory must not
# each pay (and each publish) the same expensive compile.  A lock here
# is an O_CREAT|O_EXCL sidecar file -- the only primitive that is
# atomic on every local filesystem -- holding JSON {pid, time} so a
# waiter can tell "held by live work" from "left behind by a SIGKILLed
# worker" and steal the latter.
# ---------------------------------------------------------------------------
_LOCK_SUFFIX = ".lock"


class LockTimeout(TimeoutError):
    """A :func:`blob_lock` waiter gave up: the lock stayed held (by a
    live process) past ``timeout_s``."""


def _lock_path(directory: str, key: str) -> str:
    return _blob_path(directory, key) + _LOCK_SUFFIX


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:        # exists, owned by someone else
        return True
    except OSError:
        return True                # unknowable: assume alive (don't steal)
    return True


def _read_lock(path: str):
    """Raw bytes of the lock file, or None if it vanished."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _lock_is_stale(raw: bytes, path: str, stale_s: float) -> bool:
    """True when the lock content ``raw`` (read from ``path``) belongs
    to a dead process or has outlived ``stale_s``.  Unreadable/partial
    content only counts as stale once the file's mtime is old -- a
    peer may be mid-write."""
    try:
        info = json.loads(raw.decode())
        pid = int(info["pid"])
        born = float(info.get("time", 0.0))
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        try:
            return time.time() - os.path.getmtime(path) > max(stale_s, 1.0)
        except OSError:
            return False           # vanished: next acquire attempt decides
    if not _pid_alive(pid):
        return True
    return time.time() - born > stale_s


@contextlib.contextmanager
def blob_lock(directory: str, key: str, *, stale_s: float = 120.0,
              poll_s: float = 0.05, timeout_s: float = 600.0):
    """Hold the cross-process advisory lock for ``key``.

    Yields a small stats dict: ``waited_s`` (how long acquisition
    blocked) and ``steals`` (stale locks reclaimed on the way in) --
    the AOT cache surfaces both.  Raises :class:`LockTimeout` if a
    *live* holder keeps the lock past ``timeout_s``.

    Stealing re-reads the lock file immediately before unlinking and
    skips the unlink if its content changed -- the window where waiter
    A decides "stale" while waiter B already stole and re-acquired is
    real, and unlinking B's fresh lock would let two processes inside.
    """
    os.makedirs(directory, exist_ok=True)
    path = _lock_path(directory, key)
    start = time.monotonic()
    steals = 0
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raw = _read_lock(path)
            if raw is None:
                continue                       # vanished: retry acquire
            if _lock_is_stale(raw, path, stale_s):
                if _read_lock(path) == raw:    # unchanged since judged
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                    steals += 1
                continue                       # immediate retry, no sleep
            if time.monotonic() - start > timeout_s:
                raise LockTimeout(
                    f"lock for key {key!r} at {path} held past "
                    f"{timeout_s}s by a live process")
            time.sleep(poll_s)
            continue
        break
    try:
        os.write(fd, json.dumps({"pid": os.getpid(), "key": key,
                                 "time": time.time()}).encode())
    finally:
        os.close(fd)
    try:
        yield {"waited_s": time.monotonic() - start, "steals": steals}
    finally:
        with contextlib.suppress(OSError):
            os.unlink(path)
