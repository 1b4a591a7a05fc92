"""Fault-tolerant checkpoints of tensor trees, keyed binary blobs and
cross-process locks: the port of :mod:`repro.checkpoint.store`, in the
reference's on-disk formats, so what either package writes the other
reads.

Tree checkpoints:  ``<dir>/step_<n:08d>/ {manifest.json, <leaf>.npy ...}``,
written into ``step_<n>.tmp`` and published by one rename, so a crash
mid-write never corrupts the newest checkpoint.  A leaf's key is its
tree path joined by ``"::"``, its file name the key with every character
outside ``[A-Za-z0-9_.-]`` turned into ``_``; the manifest holds
``step``, ``keys`` (each leaf's ``file``, ``shape`` and ``dtype``),
``extra`` and ``time``.  Leaves are stored whole on the host, so a
checkpoint restores onto any device or mesh.

A bfloat16 leaf is written as the reference writes one (NumPy's ``.npy``
of an ``ml_dtypes`` bfloat16 array: descr ``'<V2'``, the raw 2-byte
words, manifest dtype ``"bfloat16"``) and read back from the manifest's
dtype through a 16-bit integer view, with no ``ml_dtypes``.  (The
reference cannot read such a leaf back: JAX refuses the ``'|V2'`` array
NumPy loads.)

The blob half (``save_blob`` ... ``LockTimeout``) is a copy of the
reference's; the persistent AOT cache
(:class:`repro_torch.radon.PersistentAOTCache`) rides on it.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..tree import tree_items, tree_map, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "gc_checkpoints",
           "save_blob", "load_blob", "list_blobs", "delete_blob",
           "blob_lock", "LockTimeout"]

_SEP = "::"
_BF16_DESCR = "<V2"        # np.save's descr of an ml_dtypes bfloat16 array


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _flatten(tree) -> Dict[str, Any]:
    return {_key(path): leaf for path, leaf in tree_items(tree)}


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _to_host(leaf, copy: bool = False):
    """A leaf as a CPU tensor or a numpy array; ``copy`` makes sure it
    shares no storage with ``leaf`` (a CPU tensor's ``.cpu()`` is
    itself)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _write_leaf(path: str, leaf) -> tuple:
    """Write one host leaf as ``.npy``; returns ``(shape, dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            words = leaf.contiguous().view(torch.int16).numpy()
            return _write_bf16(path, words), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return _write_bf16(path, arr.view(np.int16)), "bfloat16"
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _write_bf16(path: str, words: np.ndarray) -> list:
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(words.shape)})
        f.write(np.ascontiguousarray(words).tobytes())
    return list(words.shape)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"{path}: dtype {arr.dtype}, the manifest says "
                         f"{dtype}")
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Blocking atomic save of a tree of tensors (or arrays) on any
    device.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "keys": {}, "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten(tree).items():
        fname = _fname(key)
        shape, dtype = _write_leaf(os.path.join(tmp, fname), _to_host(leaf))
        manifest["keys"][key] = {"file": fname, "shape": shape,
                                 "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def _steps(directory: str) -> list:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, like_tree, step: Optional[int] = None,
                       device=None, place=None):
    """Restore into the structure of ``like_tree`` (whose leaves may be
    meta tensors: only its keys and shapes are read).

    Each leaf comes back as a tensor of the dtype on disk, on ``device``
    (default: the CPU), or as ``place(path, leaf)`` makes it of the leaf
    read on the host (``path`` as :func:`tree_items` gives it), as soon as
    it is read: a rank's shard keeps at most one whole leaf on the host.
    Returns ``(tree, step, extra)``, or ``(None, None, None)`` when there
    is no checkpoint.
    """
    if place is not None and device is not None:
        raise ValueError("give device or place, not both")
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None, None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat_like = _flatten(like_tree)
    missing = set(flat_like) - set(manifest["keys"])
    if missing:
        raise ValueError(f"checkpoint at {path} missing keys: "
                         f"{sorted(missing)[:5]}")
    paths = [p for p, _ in tree_items(like_tree)]
    leaves = []
    for (key, like), leaf_path in zip(flat_like.items(), paths):
        info = manifest["keys"][key]
        shape = getattr(like, "shape", None)
        if shape is not None and tuple(shape) != tuple(info["shape"]):
            raise ValueError(f"checkpoint at {path}: {key} has shape "
                             f"{info['shape']}, the tree needs "
                             f"{tuple(shape)}")
        t = _read_leaf(os.path.join(path, info["file"]), info["dtype"])
        if place is not None:
            t = place(leaf_path, t)
        elif device is not None:
            t = t.to(device)
        leaves.append(t)
    return (tree_unflatten(like_tree, leaves), manifest["step"],
            manifest.get("extra", {}))


def gc_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one write in flight).

    ``save`` copies the tree to the host on the caller's thread, so the
    caller may update its tensors in place at once, and writes it on a
    background thread.  ``last_save`` holds the seconds of the newest
    save's host copy (``copy_s``) and write (``write_s``, once done).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Dict[str, float] = {}

    def save(self, step: int, tree, extra=None) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = tree_map(lambda x: _to_host(x, copy=True), tree)
        self.last_save = {"copy_s": time.perf_counter() - t0}

        def work():
            t1 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                gc_checkpoints(self.directory, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e
            self.last_save["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


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
