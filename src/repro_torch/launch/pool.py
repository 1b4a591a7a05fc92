"""Wire protocol + request journal for the port's multi-process pool.

The port's own copy of :mod:`repro.launch.pool` (byte-identical frames
and digests).

The supervisor (:mod:`repro_torch.launch.supervisor`) talks to its
``serve --mode service --jsonl --framed`` worker subprocesses over
plain pipes.  This module is the shared vocabulary of that boundary --
deliberately free of torch imports so the supervisor side stays cheap
to load and test:

* **Length-prefixed jsonl frames.**  Each message is one compact
  ASCII-JSON object sent as ``<byte length>\\n<payload>\\n``.  Newline
  JSON alone cannot distinguish "half a message" from "a message" when
  a worker is SIGKILLed mid-write; the length prefix makes truncation
  detectable (a torn final frame reads as EOF, never as a mangled
  request), and lets the reader skip stray non-protocol lines instead
  of desyncing forever.
* **Request journal (WAL).**  Every request the supervisor dispatches
  to a worker is recorded (with a payload digest) before the frame is
  written; delivery, typed rejection, failure, replay, and
  worker-lost events append to the same journal.  On worker death the
  journal is what makes "replay exactly once, bit-exact, or reject
  typed" an auditable property instead of a hope.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Dict, Optional

__all__ = ["write_frame", "read_frame", "payload_digest",
           "RequestJournal"]

#: largest frame the reader will accept (a corrupt length prefix must
#: not make it try to slurp gigabytes); giant-N images go through the
#: in-process router, not the pipe protocol.
MAX_FRAME_BYTES = 256 * 1024 * 1024


def write_frame(fp, obj: dict) -> None:
    """Write one length-prefixed JSON frame and flush.

    The payload is compact ASCII JSON, so its character length equals
    its UTF-8 byte length and text-mode pipes are safe on both ends.
    Callers serialize concurrent writers (frames must never interleave).
    """
    payload = json.dumps(obj, separators=(",", ":"))
    fp.write(f"{len(payload)}\n{payload}\n")
    fp.flush()


def read_frame(fp) -> Optional[dict]:
    """Read the next frame; ``None`` on EOF (including a torn final
    frame -- a crashed writer's partial output is EOF, not data).

    Non-protocol header lines (a stray print on a worker's stdout, a
    blank line) are skipped rather than treated as fatal: the length
    prefix is what lets the reader resynchronize on the next real
    frame.  A syntactically valid frame with undecodable JSON raises
    ``ValueError`` -- that is protocol corruption, not noise.
    """
    while True:
        header = fp.readline()
        if not header:
            return None
        header = header.strip()
        if not header:
            continue
        try:
            n = int(header)
        except ValueError:
            continue                   # stray line: resync on next header
        if not 0 <= n <= MAX_FRAME_BYTES:
            continue
        payload = fp.read(n)
        if payload is None or len(payload) < n:
            return None                # torn frame: writer died mid-write
        fp.readline()                  # trailing newline (may be absent at EOF)
        return json.loads(payload)


def payload_digest(payload) -> str:
    """Stable content digest of one request payload (numpy array): the
    journal records it at dispatch AND at replay, so "the replay was
    bit-exact the same request" is checkable from the WAL alone."""
    import numpy as np
    arr = np.ascontiguousarray(payload)
    h = hashlib.sha1()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


class RequestJournal:
    """Append-only journal of per-request lifecycle events.

    With ``path`` set, every event is appended (and flushed) to a jsonl
    file -- the small write-ahead log the supervisor keeps of what it
    handed to which worker; without it the journal still keeps the
    in-memory counters the pool healthz accounting rides on.  Events:

    * ``dispatch`` -- request handed to a worker (worker idx + digest);
    * ``deliver`` / ``typed`` / ``fail`` -- terminal outcomes;
    * ``replay``  -- worker died, request re-dispatched (once) to a
      healthy worker;
    * ``lost``    -- worker died and the request could NOT be replayed
      (already replayed, or no healthy worker): rejected typed as
      ``worker_lost``.

    Thread-safe: reader threads, the probe monitor and the dispatch
    path all record through one lock.
    """

    EVENTS = ("dispatch", "deliver", "typed", "fail", "replay", "lost")

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._fp = open(path, "a") if path else None
        self.counts: Dict[str, int] = {ev: 0 for ev in self.EVENTS}

    def record(self, event: str, rid, **fields) -> None:
        if event not in self.counts:
            raise ValueError(f"unknown journal event {event!r}")
        with self._lock:
            self.counts[event] += 1
            if self._fp is not None:
                self._fp.write(json.dumps(
                    {"t": time.time(), "ev": event, "id": rid, **fields},
                    separators=(",", ":")) + "\n")
                self._fp.flush()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def close(self) -> None:
        with self._lock:
            if self._fp is not None:
                self._fp.close()
                self._fp = None

    def __repr__(self) -> str:
        s = self.stats()
        return (f"RequestJournal({self.path!r}, dispatched={s['dispatch']}, "
                f"delivered={s['deliver']}, replayed={s['replay']}, "
                f"lost={s['lost']})")
