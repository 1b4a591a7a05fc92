"""First-class linear-operator objects over cached transform plans.

The port of :mod:`repro.radon.operators`.  ``op = radon.DPRT(shape,
dtype)`` builds (or fetches: plans are cached) the forward DPRT
operator for one input geometry:

    op(f)            # apply: (…, H, W) -> (…, P+1, P), differentiable
    op.inverse       # the exact inverse transform (crops the embedding)
    op.T             # the exact adjoint -- A^T, NOT the inverse
    op.inverse.T     # adjoint of the inverse == (A^T)^-1
    op2 @ op1        # composition (applied right-to-left)
    op.lower(dev)    # AOT: the resolved plan and token, nothing built
    op.compile(dev)  # AOT: the cached executable for one device
    op.as_matrix()   # dense (out_size, in_size) matrix (small N; tests)

**The AOT surface.**  What a cold start compiles in the port is the set
of nvcc libraries the operator's route launches (``kernels/_build.py``'s
``lib<name>_<hash>.so`` for ``sm_90a``) around the resolved plan.  So an
:class:`Executable` -- what ``compile(device)`` returns and keeps in the
in-process AOT cache under ``_aot_key(device)`` -- is the operator's
datapath on that device after one warm call, with the libraries that
call launched and the tiles it launched them with.
``export_executable(device)`` serializes it: a JSON header (token,
environment fingerprint, plan knobs, tiles, and each library's name,
source hash, size and sha256) followed by the raw ``.so`` bytes -- no
pickle.  ``import_executable(data, device)`` verifies every digest, the
token, the fingerprint and the plan *before* anything is written or
loaded, installs each library at its hashed path under
``_build.BUILD_DIR`` by atomic rename, and registers the executable
with no nvcc run.  On the CPU the route launches no library and the
payload carries none.  :class:`PersistentAOTCache` keeps these bytes on
disk through :mod:`repro_torch.checkpoint.store`, keyed by
:meth:`RadonOperator.cache_token`; :func:`aot_fingerprint` (torch and
CUDA versions, device name and capability, kernel sources' hash) makes
a blob of another environment -- or of edited kernels -- stale.

The projection-domain fusion surface: :class:`Conv2D` (exact circular
convolution by a fixed kernel) and ``op.inverse @ ProjectionFilter(w)
@ op``, which :class:`CompositeOperator` rewrites into one
:class:`FusedProjectionPipeline` -- each one K2 call on the ``cuda``
backend, the staged fallback elsewhere.

Operators are device-agnostic: they run on the device of the tensor
they are given.  Every application routes through
:mod:`repro_torch.radon.autodiff` or :mod:`repro_torch.radon.fusion`,
so gradients are exact for every backend.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.dprt import accum_dtype_for, as_dtype, dtype_name
from ..core.plan import (RadonPlan, _canonical_method,
                         _mesh_for_description, _topology_token as
                         _mesh_token, add_plan_evict_hook, get_plan)
from ..kernels import _build, pipeline as _kernel_pipeline
from . import ambient
from .autodiff import (_CACHE_LOCK, INVERSE_OF, TRANSPOSE_OF, apply_plan,
                       trace_count)
from .fusion import flip_image, pipeline_apply

__all__ = ["DPRT", "Conv2D", "ProjectionFilter", "FusedProjectionPipeline",
           "RadonOperator", "CompositeOperator", "operator_for",
           "conv2d_from_description", "projection_filter_from_numpy",
           "Executable", "Lowered", "aot_cache_info", "aot_cache_clear",
           "PersistentAOTCache", "aot_fingerprint"]


#: the profiler spans of ``Conv2D`` on a batched stack: the forward of the
#: kernel image, then the fused pipeline (K2) against its projections
CONV_KERNEL_SPAN = "repro_torch.conv2d.kernel_projections"
CONV_PIPELINE_SPAN = "repro_torch.conv2d.pipeline"


# ---------------------------------------------------------------------------
# the AOT surface: executables, their bytes, the in-process and disk caches
# ---------------------------------------------------------------------------
#: aot key -> Executable: the in-process cache behind ``op.compile()``.
#: A key is ``_aot_key(device)`` (composites: the tuple of their
#: operators' keys); entries drop with plan-cache evictions.
_AOT_CACHE: dict = {}

#: key -> tensors whose id() participates in the key, pinned for the
#: life of the entry so a dead weights tensor's id is never reused
_AOT_PINS: dict = {}

#: cache_token -> lock serializing PersistentAOTCache.get_or_compile of
#: one executable across the caches (services, routers) of a process
_COMPILE_LOCKS: dict = {}

#: first bytes of an exported executable
_EXE_MAGIC = b"RTXEXE1\n"


def _key_involves(key, plan) -> bool:
    return any(_key_involves(e, plan) if isinstance(e, tuple) else e is plan
               for e in key)


def _drop_plan_executables(plan) -> None:
    with _CACHE_LOCK:
        for key in [k for k in _AOT_CACHE if _key_involves(k, plan)]:
            del _AOT_CACHE[key]
            _AOT_PINS.pop(key, None)


add_plan_evict_hook(_drop_plan_executables)


def _aot_key_label(key) -> str:
    if isinstance(key[0], tuple):   # composite: one entry per operator
        return "@".join(_aot_key_label(e) for e in key)
    return key[0] if isinstance(key[0], str) else str(key[1])


def aot_cache_info() -> dict:
    with _CACHE_LOCK:
        return {"currsize": len(_AOT_CACHE),
                "keys": sorted(_aot_key_label(k) for k in _AOT_CACHE)}


def aot_cache_clear() -> None:
    with _CACHE_LOCK:
        _AOT_CACHE.clear()
        _AOT_PINS.clear()


def aot_fingerprint(device="cuda") -> str:
    """Environment stamp persisted next to exported executables: torch
    and CUDA versions, the device's name and compute capability, and the
    hash of the kernel sources.  A blob stamped otherwise is stale."""
    device = torch.device(device)
    if device.type == "cuda":
        idx = (torch.cuda.current_device() if device.index is None
               else device.index)
        major, minor = torch.cuda.get_device_capability(idx)
        where = f"{torch.cuda.get_device_name(idx)};sm_{major}{minor}"
    else:
        where = device.type
    return (f"torch={torch.__version__};cuda={torch.version.cuda};"
            f"device={where};kernels={_build.sources_hash()}")


def _topology_token(device: torch.device, mesh) -> str:
    """The device-topology component of a persistent cache token."""
    if mesh is not None:
        return _mesh_token(mesh)
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    return f"{device.type}{count}"


def _knob_token(plan) -> str:
    return "h{}_m{}_sr{}_br{}_bb{}".format(
        plan.strip_rows, plan.m_block, plan.stream_rows, plan.block_rows,
        plan.block_batch)


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _plan_record(plan) -> dict:
    """``plan.describe()`` as JSON gives it back (tuples -> lists)."""
    return json.loads(json.dumps(plan.describe()))


def _device(device) -> torch.device:
    """``device`` with a CUDA index filled in (the current card), so
    ``"cuda"`` and ``"cuda:0"`` key the same executable."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(device: torch.device):
    """The scope a call on ``device`` runs in: that card current on this
    thread (a no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Executable:
    """One operator's datapath built for one device -- what
    ``compile(device)`` returns and the in-process AOT cache holds.

    Calling it runs the datapath on a tensor on ``device`` without
    autograd, building nothing.  ``libraries`` are the nvcc libraries
    the warm call launched (none on the CPU), ``tiles`` the
    ``(library, tile)`` launches it made, ``plan`` the resolved plan
    knobs; ``token`` is the operator's :meth:`cache_token`.
    """

    __slots__ = ("fn", "token", "device", "plan", "libraries", "tiles")

    def __init__(self, fn, token: str, device: torch.device, plan,
                 libraries, tiles):
        self.fn = fn
        self.token = token
        self.device = device
        self.plan = plan
        self.libraries = tuple(libraries)
        self.tiles = [[name, list(tile)] for name, tile in tiles]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.fn(x)

    def __repr__(self) -> str:
        return (f"Executable({self.token!r}, device={self.device}, "
                f"libraries={self.libraries})")


class Lowered:
    """What ``lower(device)`` returns: one operator resolved for one
    device -- its token and plan knobs -- with nothing built yet.
    :meth:`compile` builds the libraries and makes the warm call."""

    __slots__ = ("op", "device", "token", "plan")

    def __init__(self, op, device):
        self.op = op
        self.device = _device(device)
        self.token = op.cache_token(self.device)
        self.plan = op._aot_plan()

    def compile(self) -> Executable:
        with _build.recording() as rec, _on_device(self.device):
            fn = self.op._aot_prepare(self.device)
            with torch.no_grad():
                fn(self.op._aot_warm_input(self.device))
            _sync(self.device)
        return Executable(fn, self.token, self.device, self.plan,
                          sorted(rec["libraries"]), rec["tiles"])

    def __repr__(self) -> str:
        return f"Lowered({self.token!r})"


def _register(key, exe: Executable, pins, replace: bool = False):
    with _CACHE_LOCK:
        if replace or key not in _AOT_CACHE:
            _AOT_CACHE[key] = exe
        if pins:    # keep id()-keyed tensors alive with the entry
            _AOT_PINS.setdefault(key, tuple(pins))
        return _AOT_CACHE[key]


def _export(exe: Executable) -> bytes:
    """An executable's bytes: magic, header length, the header's sha256,
    the JSON header, then each library's raw bytes."""
    libs, payloads = [], []
    for name in exe.libraries:
        path = _build.library_path(name)
        data = path.read_bytes()
        libs.append({"name": name, "file": path.name,
                     "source_hash": path.stem.rsplit("_", 1)[-1],
                     "size": len(data),
                     "sha256": hashlib.sha256(data).hexdigest()})
        payloads.append(data)
    header = json.dumps({
        "format": 1, "token": exe.token,
        "fingerprint": aot_fingerprint(exe.device),
        "plan": exe.plan, "tiles": exe.tiles, "libraries": libs},
        sort_keys=True).encode()
    return (_EXE_MAGIC + len(header).to_bytes(8, "big")
            + hashlib.sha256(header).digest() + header + b"".join(payloads))


def _parse(data: bytes) -> tuple:
    """``(header, payloads)`` of exported bytes; raises ValueError on any
    torn, rotten or inconsistent part -- before anything is installed."""
    data = bytes(data)
    if not data.startswith(_EXE_MAGIC):
        raise ValueError("not an exported executable (bad magic)")
    off = len(_EXE_MAGIC)
    hlen = int.from_bytes(data[off:off + 8], "big")
    off += 8
    digest, off = data[off:off + 32], off + 32
    raw, off = data[off:off + hlen], off + hlen
    if len(raw) != hlen or hashlib.sha256(raw).digest() != digest:
        raise ValueError("executable header torn or corrupt")
    try:
        header = json.loads(raw.decode())
        libs = header["libraries"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"executable header unreadable: {e}")
    payloads = []
    for lib in libs:
        size = int(lib["size"])
        blob, off = data[off:off + size], off + size
        if len(blob) != size \
                or hashlib.sha256(blob).hexdigest() != lib["sha256"]:
            raise ValueError(f"library {lib.get('name')!r} payload torn or "
                             f"corrupt (sha256 mismatch)")
        payloads.append(blob)
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing bytes after the "
                         f"executable's payloads")
    return header, payloads


def _check_header(op, header: dict, device: torch.device) -> None:
    """The header must describe ``op`` on ``device`` in this environment
    and with these kernel sources."""
    want = {"token": op.cache_token(device),
            "fingerprint": aot_fingerprint(device),
            "plan": op._aot_plan()}
    for field, value in want.items():
        if header.get(field) != value:
            raise ValueError(f"executable {field} {header.get(field)!r} "
                             f"does not match {value!r}")
    for lib in header["libraries"]:
        if lib["name"] not in _build.LIBRARIES:
            raise ValueError(f"unknown library {lib['name']!r}")
        if lib["file"] != _build.library_path(lib["name"]).name:
            raise ValueError(f"library {lib['file']} was built from other "
                             f"sources than this checkout's")


class _AOTSurface:
    """``lower`` / ``compile`` / ``export_executable`` /
    ``import_executable`` over an operator's ``_aot_key(device)``,
    ``cache_token(device)``, ``_aot_plan()``, ``_aot_pins()``,
    ``_aot_prepare(device)`` (the callable to warm and keep) and
    ``_aot_warm_input(device)``."""

    __slots__ = ()

    def _aot_pins(self) -> tuple:
        return ()

    def _aot_warm_input(self, device) -> torch.Tensor:
        # ones, not zeros: a solve of a zero right-hand side stops before
        # its first iteration and would launch (and so ship) no K2
        return torch.ones(self.shape_in, dtype=self.dtype_in, device=device)

    def lower(self, device="cuda") -> Lowered:
        """Resolve this operator for ``device``: its token and plan,
        nothing built (``.compile()`` the result, or use
        :meth:`compile` for the cached executable)."""
        return Lowered(self, device)

    def compile(self, device="cuda") -> Executable:
        """The executable of this operator on ``device``, built at most
        once per key process-wide: the plan, the nvcc libraries and the
        appliers its route needs, and one warm call.  Calling it
        rebuilds nothing -- the serving path's steady state."""
        device = _device(device)
        key = self._aot_key(device)
        with _CACHE_LOCK:
            exe = _AOT_CACHE.get(key)
        if exe is None:
            exe = _register(key, self.lower(device).compile(),
                            self._aot_pins())
        return exe

    def export_executable(self, device="cuda") -> bytes:
        """This operator's executable on ``device`` (compiled first if
        needed) as bytes a later process restores with
        :meth:`import_executable`, running no nvcc."""
        return _export(self.compile(device))

    def import_executable(self, data: bytes, device="cuda") -> Executable:
        """Verify ``data`` from :meth:`export_executable` (every digest,
        the token, the fingerprint, the plan, the libraries' source
        hashes) -- raising ValueError before anything is written or
        loaded -- then install its libraries under ``_build.BUILD_DIR``,
        make the warm call and register the executable under this
        operator's key.  No nvcc runs for a library the bytes carry."""
        device = _device(device)
        header, payloads = _parse(data)
        _check_header(self, header, device)
        for lib, blob in zip(header["libraries"], payloads):
            _build.install(lib["name"], blob)
        with _on_device(device):
            fn = self._aot_prepare(device)
            with torch.no_grad():
                fn(self._aot_warm_input(device))
            _sync(device)
        exe = Executable(fn, header["token"], device, header["plan"],
                         [lib["name"] for lib in header["libraries"]],
                         header["tiles"])
        return _register(self._aot_key(device), exe, self._aot_pins(),
                         replace=True)


def _collective_lead(op) -> Optional[bool]:
    """None unless ``op``'s plan is on a mesh of more than one rank;
    then whether this process is the mesh's first rank."""
    plan = getattr(op, "plan", None)
    mesh = None if plan is None else plan.mesh
    if mesh is None or mesh.mesh.numel() < 2:
        return None
    return torch.distributed.get_rank() == int(mesh.mesh.flatten()[0])


class PersistentAOTCache:
    """Disk-backed executable cache: :meth:`export_executable` bytes
    keyed by ``cache_token(device)`` and stored through the
    :mod:`repro_torch.checkpoint.store` blob machinery (atomic rename,
    header + payload), stamped with :func:`aot_fingerprint`.  A warm
    process restart installs the blob's nvcc libraries instead of
    running nvcc.

    ``get_or_compile(op, device)`` is the whole surface: in-memory AOT
    cache first, then disk (fingerprint-checked), then compile-and-
    persist.  Corrupt or stale blobs count as misses (``errors`` tallies
    the corrupt ones) and are overwritten; a failed save degrades to the
    in-memory executable, never to an outage.  ``degraded_compiles``
    counts restores that had a blob on disk but still had to compile
    (torn/rotten/stale blob) -- what a restarted service's healthz says
    when it came up, but not warm.

    Concurrent ``get_or_compile`` of one token is serialized at two
    scopes: a process-wide lock table and a cross-process
    :func:`~repro_torch.checkpoint.store.blob_lock` file lock (N worker
    processes cold-starting over one ``aot_dir``).  A waiter re-reads
    the blob once it holds the file lock, so whichever process compiled
    first publishes and the others restore -- one compile per unique
    executable across a pool.  Locks left by SIGKILLed workers carry
    the holder PID and are stolen once it is dead (``lock_steals``); a
    filesystem that cannot do O_EXCL degrades to unlocked operation
    (``lock_degraded``).

    An operator on a mesh of more than one rank is built *collectively*:
    its warm call is a collective that every rank of the mesh makes
    together, so no rank may wait on a peer's file lock across it.  Every
    rank restores or compiles without the file lock (a blob is published
    by an atomic rename, so a read sees all of it or none), and only the
    mesh's first rank writes the blob, under the lock.
    """

    def __init__(self, directory: str, *, lock_stale_s: float = 120.0,
                 lock_timeout_s: float = 600.0):
        self.directory = str(directory)
        self.lock_stale_s = float(lock_stale_s)
        self.lock_timeout_s = float(lock_timeout_s)
        self.hits = self.misses = self.errors = 0
        self.degraded_compiles = 0
        self.lock_steals = 0
        self.lock_degraded = 0
        self.lock_wait_s = 0.0

    def _compile_lock(self, key: str):
        with _CACHE_LOCK:
            return _COMPILE_LOCKS.setdefault(key, threading.Lock())

    def get_or_compile(self, op, device="cuda") -> Executable:
        """The executable of any operator with the AOT surface on
        ``device``."""
        from ..checkpoint.store import blob_lock
        device = _device(device)
        with _CACHE_LOCK:
            exe = _AOT_CACHE.get(op._aot_key(device))
        if exe is not None:
            return exe                      # in-memory: not a disk event
        key = op.cache_token(device)
        with self._compile_lock(key):
            with _CACHE_LOCK:               # racer finished while we waited
                exe = _AOT_CACHE.get(op._aot_key(device))
            if exe is not None:
                return exe
            leads = _collective_lead(op)
            if leads is not None:
                return self._restore_or_compile(op, key, device,
                                                publish=leads)
            try:
                with blob_lock(self.directory, key,
                               stale_s=self.lock_stale_s,
                               timeout_s=self.lock_timeout_s) as lk:
                    self.lock_steals += lk["steals"]
                    self.lock_wait_s += lk["waited_s"]
                    return self._restore_or_compile(op, key, device)
            except OSError:                 # O_EXCL unsupported / RO dir:
                self.lock_degraded += 1     # unlocked is worse, outage is
                return self._restore_or_compile(op, key, device)

    def _restore_or_compile(self, op, key: str, device: torch.device,
                            publish: Optional[bool] = None):
        """Disk-restore-else-compile for ``key``; the caller holds the
        in-process token lock and (normally) the cross-process file
        lock, so the load sees any blob a peer published meanwhile.  A
        collective build (``publish`` not None) holds no file lock: a
        compile is saved, under the lock, only where ``publish``."""
        from ..checkpoint.store import blob_lock, load_blob, save_blob
        data = None
        had_blob = False
        try:
            data, meta = load_blob(self.directory, key)
            had_blob = data is not None
        except ValueError:              # torn/corrupt blob: overwrite
            self.errors += 1
            had_blob = True
        fingerprint = aot_fingerprint(device)
        if data is not None and meta.get("fingerprint") == fingerprint:
            try:
                exe = op.import_executable(data, device)
                self.hits += 1
                return exe
            except Exception:           # rotten bytes: rebuild
                self.errors += 1
        self.misses += 1
        if had_blob:                    # blob existed but could not
            self.degraded_compiles += 1  # restore: degraded cold start
        exe = op.compile(device)
        if publish is False:
            return exe
        try:
            data = op.export_executable(device)
            with (blob_lock(self.directory, key, stale_s=self.lock_stale_s,
                            timeout_s=self.lock_timeout_s)
                  if publish else contextlib.nullcontext()):
                save_blob(self.directory, key, data,
                          meta={"fingerprint": fingerprint})
        except Exception:               # read-only disk etc.: serve
            self.errors += 1            # from memory, count it
        return exe

    def stats(self) -> dict:
        return {"directory": self.directory, "hits": self.hits,
                "misses": self.misses, "errors": self.errors,
                "degraded_compiles": self.degraded_compiles,
                "lock_steals": self.lock_steals,
                "lock_degraded": self.lock_degraded,
                "lock_wait_s": round(self.lock_wait_s, 6)}

    def __repr__(self) -> str:
        return (f"PersistentAOTCache({self.directory!r}, hits={self.hits}, "
                f"misses={self.misses}, errors={self.errors}, "
                f"degraded_compiles={self.degraded_compiles})")


class RadonOperator(_AOTSurface):
    """One linear datapath of a :class:`~repro_torch.core.plan.RadonPlan`.

    ``kind`` is one of ``forward`` / ``inverse`` / ``adjoint`` /
    ``inverse_adjoint``; ``dtype`` is the *image* dtype the operator was
    declared for (transform-domain inputs/outputs use its accumulator
    dtype, as the transforms themselves do).
    """

    __slots__ = ("plan", "kind", "dtype")

    def __init__(self, plan: RadonPlan, kind: str, dtype):
        if kind not in TRANSPOSE_OF:
            raise ValueError(f"unknown operator kind {kind!r}")
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "dtype", as_dtype(dtype))

    def __setattr__(self, name, value):
        raise AttributeError("RadonOperator is immutable")

    # -- shapes / dtypes ---------------------------------------------------
    @property
    def _image_side(self) -> bool:
        """True when the INPUT lives in image space (H, W)."""
        return self.kind in ("forward", "inverse_adjoint")

    @property
    def shape_in(self) -> Tuple[int, ...]:
        g = self.plan.geometry
        return g.image_shape if self._image_side else g.transform_shape

    @property
    def shape_out(self) -> Tuple[int, ...]:
        g = self.plan.geometry
        return g.transform_shape if self._image_side else g.image_shape

    @property
    def dtype_in(self) -> torch.dtype:
        # forward consumes raw images; every other datapath consumes
        # transform-domain / cotangent values in the accumulator dtype
        if self.kind == "forward":
            return self.dtype
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    @property
    def dtype_out(self) -> torch.dtype:
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    # -- application -------------------------------------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return apply_plan(self.plan, self.kind, x)

    # -- algebra -----------------------------------------------------------
    @property
    def T(self) -> "RadonOperator":
        """The exact adjoint: ``<op(x), y> == <x, op.T(y)>``."""
        return RadonOperator(self.plan, TRANSPOSE_OF[self.kind], self.dtype)

    @property
    def inverse(self) -> "RadonOperator":
        """The exact inverse transform (bit-exact round trip on ints)."""
        return RadonOperator(self.plan, INVERSE_OF[self.kind], self.dtype)

    def __matmul__(self, other):
        return _compose(self, other)

    # -- AOT ---------------------------------------------------------------
    def _aot_key(self, device):
        return (self.plan, self.kind, dtype_name(self.dtype_in), str(device))

    def _aot_plan(self) -> dict:
        return _plan_record(self.plan)

    def _aot_prepare(self, device):
        plan, kind = self.plan, self.kind
        return lambda x: getattr(plan, kind)(x)

    @property
    def input_sharding(self):
        """The mesh-natural placement of this operator's input: ``None``
        for a plan without a mesh, else ``(mesh, placements)`` -- a
        batched stack sharded over the mesh's data axes
        (:func:`repro_torch.core.distributed.batch_partition_spec`),
        anything else replicated."""
        mesh = self.plan.mesh
        if mesh is None:
            return None
        from torch.distributed.tensor import Replicate
        from ..core.distributed import batch_partition_spec
        if self.plan.geometry.batched:
            return mesh, batch_partition_spec(mesh)
        return mesh, tuple(Replicate() for _ in mesh.mesh_dim_names)

    def cache_token(self, device="cuda") -> str:
        """A process-independent identity of this operator's executable
        on ``device``'s kind: datapath, shape, dtype, resolved method and
        knobs, and the device topology -- the key of the persistent
        on-disk cache."""
        p = self.plan
        shape = "x".join(str(s) for s in self.shape_in)
        return (f"{self.kind}_{shape}_{dtype_name(self.dtype_in)}_"
                f"{p.method}_{_knob_token(p)}_"
                f"{_topology_token(torch.device(device), p.mesh)}")

    # -- introspection -----------------------------------------------------
    @property
    def trace_count(self) -> int:
        """Builds of this operator's plan so far (1 once it exists);
        pipeline appliers built on the same plan are counted under their
        own kind, not here."""
        return trace_count(self.plan, kind="plan")

    def as_matrix(self, device="cuda") -> torch.Tensor:
        """Dense (out_size, in_size) matrix of this linear map, one basis
        vector per input element -- O(P^4) memory, small primes only."""
        size_in = 1
        for s in self.shape_in:
            size_in *= s
        basis = torch.eye(size_in, dtype=self.dtype_in, device=device)
        cols = [self(e.reshape(self.shape_in)).reshape(-1) for e in basis]
        return torch.stack(cols, dim=1)

    def describe(self) -> dict:
        d = dict(self.plan.describe())
        d.update(kind=self.kind, dtype=dtype_name(self.dtype),
                 shape_in=self.shape_in, shape_out=self.shape_out)
        return d

    def __repr__(self) -> str:
        return (f"RadonOperator({self.kind}, {self.shape_in}->"
                f"{self.shape_out}, {self.dtype}, "
                f"method={self.plan.method!r})")

    def __eq__(self, other):
        return (isinstance(other, RadonOperator)
                and self.plan == other.plan and self.kind == other.kind
                and self.dtype == other.dtype)

    def __hash__(self):
        return hash((self.plan, self.kind, self.dtype))


def _compose(left, right):
    """``left @ right``: flatten into one CompositeOperator (which then
    recognizes fusible patterns)."""
    if not (_is_operator_like(left) and _is_operator_like(right)):
        return NotImplemented
    lops = left.ops if isinstance(left, CompositeOperator) else (left,)
    rops = right.ops if isinstance(right, CompositeOperator) else (right,)
    return CompositeOperator(lops + rops)


def _is_operator_like(x) -> bool:
    return callable(x) and hasattr(x, "shape_in") and hasattr(x, "shape_out")


def _fuse_ops(ops: Tuple) -> Tuple:
    """Recognize ``inv @ pointwise @ fwd`` triples over one plan and
    replace them with the fused projection pipeline (one K2 call on
    capable backends; staged fallback otherwise)."""
    fused, i = [], 0
    while i < len(ops):
        a = ops[i]
        if (i + 2 < len(ops)
                and isinstance(a, RadonOperator) and a.kind == "inverse"
                and isinstance(ops[i + 1], ProjectionFilter)
                and isinstance(ops[i + 2], RadonOperator)
                and ops[i + 2].kind == "forward"
                and a.plan == ops[i + 2].plan
                and tuple(ops[i + 1].weights.shape[-2:])
                == tuple(a.plan.geometry.transform_shape[-2:])):
            fused.append(FusedProjectionPipeline(
                a.plan, ops[i + 1].weights, ops[i + 2].dtype))
            i += 3
        else:
            fused.append(a)
            i += 1
    return tuple(fused)


class CompositeOperator(_AOTSurface):
    """Right-to-left composition of operators: ``(g @ f)(x) == g(f(x))``.

    Supports the same algebra (``.T`` reverses and transposes,
    ``.inverse`` reverses and inverts); shape chaining is validated at
    construction, and ``inverse @ ProjectionFilter @ forward`` triples
    over one plan are rewritten into the fused projection pipeline.
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Tuple):
        if not ops:
            raise ValueError("CompositeOperator needs at least one operator")
        ops = _fuse_ops(tuple(ops))
        for outer, inner in zip(ops[:-1], ops[1:]):
            if (outer.shape_in is not None and inner.shape_out is not None
                    and outer.shape_in != inner.shape_out):
                raise ValueError(
                    f"cannot compose {outer!r} after {inner!r}: "
                    f"{inner.shape_out} does not feed {outer.shape_in}")
        object.__setattr__(self, "ops", ops)

    def __setattr__(self, name, value):
        raise AttributeError("CompositeOperator is immutable")

    @property
    def shape_in(self):
        return self.ops[-1].shape_in

    @property
    def shape_out(self):
        return self.ops[0].shape_out

    @property
    def dtype_in(self):
        return self.ops[-1].dtype_in

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for op in reversed(self.ops):
            x = op(x)
        return x

    @property
    def T(self) -> "CompositeOperator":
        return CompositeOperator(tuple(op.T for op in reversed(self.ops)))

    @property
    def inverse(self) -> "CompositeOperator":
        return CompositeOperator(
            tuple(op.inverse for op in reversed(self.ops)))

    def __matmul__(self, other):
        return _compose(self, other)

    # -- AOT: the operators' keys, tokens and prepared callables, chained
    def _aot_key(self, device):
        return tuple(op._aot_key(device) for op in self.ops)

    def _aot_pins(self) -> tuple:
        return tuple(p for op in self.ops for p in op._aot_pins())

    def _aot_plan(self):
        return [op._aot_plan() for op in self.ops]

    def _aot_prepare(self, device):
        fns = [op._aot_prepare(device) for op in reversed(self.ops)]

        def chain(x):
            for fn in fns:
                x = fn(x)
            return x
        return chain

    def _aot_warm_input(self, device) -> torch.Tensor:
        shape = self.shape_in
        if shape is None:
            # a shape-polymorphic input operator (ProjectionFilter): its
            # weights' own shape is the natural input
            inner = self.ops[-1]
            if getattr(inner, "weights", None) is None:
                raise ValueError(f"cannot build a composite whose input "
                                 f"operator {inner!r} has no input shape")
            shape = tuple(inner.weights.shape)
        return torch.ones(shape, dtype=self.dtype_in, device=device)

    def cache_token(self, device="cuda") -> str:
        return "@".join(op.cache_token(device) for op in self.ops)

    def as_matrix(self, device="cuda") -> torch.Tensor:
        mats = [op.as_matrix(device) for op in self.ops]
        out = mats[-1]
        for m in reversed(mats[:-1]):
            out = m.to(out.dtype) @ out
        return out

    def __repr__(self) -> str:
        return " @ ".join(repr(op) for op in self.ops)

    def __eq__(self, other):
        return (isinstance(other, CompositeOperator)
                and self.ops == other.ops)

    def __hash__(self):
        return hash(self.ops)


class ProjectionFilter(_AOTSurface):
    """Pointwise projection-domain filter: ``r -> weights * r``.

    A diagonal (self-adjoint) linear operator on ``(…, P+1, P)``
    projections.  Its value is in composition:
    ``op.inverse @ ProjectionFilter(w) @ op`` is rewritten by
    :class:`CompositeOperator` into one fused pipeline call.
    Shape-polymorphic over leading batch dims (``shape_in`` /
    ``shape_out`` are ``None`` wildcards for chaining).
    """

    __slots__ = ("weights",)

    def __init__(self, weights):
        weights = torch.as_tensor(weights)
        if weights.ndim not in (2, 3) or \
                weights.shape[-2] != weights.shape[-1] + 1:
            raise ValueError(f"projection weights must be (…, P+1, P), "
                             f"got {tuple(weights.shape)}")
        object.__setattr__(self, "weights", weights)

    def __setattr__(self, name, value):
        raise AttributeError("ProjectionFilter is immutable")

    shape_in = None   # polymorphic: any (…, P+1, P) matching the weights
    shape_out = None

    @property
    def dtype_in(self) -> torch.dtype:
        return self.weights.dtype

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.weights.to(r.dtype).to(r.device)

    @property
    def T(self) -> "ProjectionFilter":
        return self    # diagonal and real: self-adjoint

    @property
    def inverse(self):
        raise TypeError(
            "ProjectionFilter has no exact inverse (1/weights is not an "
            "integer-exact operation); build the reciprocal filter "
            "explicitly if that is what you mean")

    def __matmul__(self, other):
        return _compose(self, other)

    def _aot_key(self, device):
        return ("proj_filter", tuple(self.weights.shape),
                dtype_name(self.weights.dtype), id(self.weights),
                str(device))

    def _aot_pins(self) -> tuple:
        return (self.weights,)

    def _aot_plan(self) -> dict:
        return {"kind": "proj_filter", "shape": list(self.weights.shape),
                "dtype": dtype_name(self.weights.dtype)}

    def _aot_prepare(self, device):
        w = self.weights.to(device)
        return lambda r: r * w.to(r.dtype)

    def _aot_warm_input(self, device) -> torch.Tensor:
        return torch.ones(self.weights.shape, dtype=self.dtype_in,
                          device=device)

    def cache_token(self, device="cuda") -> str:
        shape = "x".join(str(s) for s in self.weights.shape)
        return (f"projfilter_{shape}_{dtype_name(self.weights.dtype)}_"
                f"w{_digest(self.weights)}")

    def __repr__(self) -> str:
        return f"ProjectionFilter({tuple(self.weights.shape)})"


class FusedProjectionPipeline(_AOTSurface):
    """``inverse @ ProjectionFilter @ forward`` collapsed onto one plan:
    the fused ``mul`` pipeline (one K2 call on capable backends; staged
    fallback otherwise), exactly differentiable through
    :mod:`repro_torch.radon.fusion`."""

    __slots__ = ("plan", "weights", "dtype")

    def __init__(self, plan: RadonPlan, weights, dtype):
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "weights", torch.as_tensor(weights))
        object.__setattr__(self, "dtype", as_dtype(dtype))

    def __setattr__(self, name, value):
        raise AttributeError("FusedProjectionPipeline is immutable")

    @property
    def shape_in(self):
        return self.plan.geometry.image_shape

    shape_out = property(lambda self: self.plan.geometry.image_shape)

    @property
    def dtype_in(self) -> torch.dtype:
        # the forward operator it swallowed consumed raw images of the
        # declared dtype: fusion does not change the input signature
        return self.dtype

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        return pipeline_apply(self.plan, f, "mul", self.weights.to(f.device))

    @property
    def T(self) -> CompositeOperator:
        """(B W A)^T = A^T W B^T: the exact-adjoint datapaths around the
        self-adjoint filter (not itself a fusible pattern)."""
        return CompositeOperator((
            RadonOperator(self.plan, "adjoint", self.dtype),
            ProjectionFilter(self.weights),
            RadonOperator(self.plan, "inverse_adjoint", self.dtype)))

    @property
    def inverse(self):
        raise TypeError(
            "FusedProjectionPipeline (inverse @ filter @ forward) has no "
            "exact inverse: the pointwise filter is not invertible in "
            "exact arithmetic")

    def __matmul__(self, other):
        return _compose(self, other)

    def _aot_key(self, device):
        return ("fused_mul", self.plan, dtype_name(self.dtype),
                id(self.weights), str(device))

    def _aot_pins(self) -> tuple:
        return (self.weights,)

    def _aot_plan(self) -> dict:
        return _plan_record(self.plan)

    def _aot_prepare(self, device):
        plan, w = self.plan, self.weights.to(device)
        return lambda f: plan.pipeline(f, "mul", w)

    def cache_token(self, device="cuda") -> str:
        p = self.plan
        shape = "x".join(str(s) for s in self.shape_in)
        return (f"fusedmul_{shape}_{dtype_name(self.dtype)}_{p.method}_"
                f"w{_digest(self.weights)}_{_knob_token(p)}_"
                f"{_topology_token(torch.device(device), p.mesh)}")

    def __repr__(self) -> str:
        return (f"FusedProjectionPipeline({self.shape_in}, "
                f"method={self.plan.method!r})")


class Conv2D(_AOTSurface):
    """Exact circular 2-D convolution by a fixed kernel, as an operator.

    ``Conv2D(shape, kernel)`` convolves ``(H, W)`` images (or
    ``(B, H, W)`` stacks) with ``kernel`` on the ``(H, W)`` torus.  On
    square prime geometries the application is the fused projection
    pipeline: one K2 call on the ``cuda`` backend, against the kernel
    image (single images) or, for a stack, against the kernel's
    projections from one forward of the kernel alone.  Other geometries
    fold the exact prime-embedded linear convolution onto the torus.
    Autograd is exact in the image and in the kernel (a ``kernel`` that
    requires grad).

    ``op.T`` is the exact adjoint -- circular *correlation*, i.e.
    convolution by the torus-flipped kernel.  ``as_matrix()`` builds the
    dense circulant for small-N tests.
    """

    __slots__ = ("plan", "kernel", "dtype")

    def __init__(self, shape, kernel, dtype=None, method: Optional[str] = None,
                 *, strip_rows: Optional[int] = None,
                 m_block: Optional[int] = None,
                 batch_impl: Optional[str] = None,
                 block_rows: Optional[int] = None,
                 stream_rows: Optional[int] = None,
                 block_batch: Optional[int] = None,
                 mesh=None):
        kernel = torch.as_tensor(kernel)
        shape = tuple(int(s) for s in shape)
        h, w = shape[-2:]
        if kernel.ndim != 2 or kernel.shape[0] > h or kernel.shape[1] > w:
            raise ValueError(
                f"kernel must be 2-D and fit the {shape[-2:]} torus, "
                f"got {tuple(kernel.shape)}")
        dtype = kernel.dtype if dtype is None else as_dtype(dtype)
        # the kernel lives zero-padded on the full (H, W) torus
        kernel = F.pad(kernel.to(dtype),
                       (0, w - kernel.shape[1], 0, h - kernel.shape[0]))
        plan = DPRT(shape, dtype, method, strip_rows=strip_rows,
                    m_block=m_block, batch_impl=batch_impl,
                    block_rows=block_rows, stream_rows=stream_rows,
                    block_batch=block_batch, mesh=mesh).plan
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "kernel", kernel)
        object.__setattr__(self, "dtype", dtype)

    def __setattr__(self, name, value):
        raise AttributeError("Conv2D is immutable")

    @property
    def shape_in(self):
        return self.plan.geometry.image_shape

    shape_out = property(lambda self: self.plan.geometry.image_shape)

    @property
    def dtype_in(self) -> torch.dtype:
        return self.dtype

    @property
    def dtype_out(self) -> torch.dtype:
        return accum_dtype_for(self.dtype, self.plan.geometry.prime)

    def _knob_kwargs(self) -> dict:
        p = self.plan
        return dict(strip_rows=p.strip_rows, m_block=p.m_block,
                    batch_impl=p.batch_impl, block_rows=p.block_rows,
                    stream_rows=p.stream_rows, block_batch=p.block_batch,
                    mesh=p.mesh)

    def __call__(self, f: torch.Tensor) -> torch.Tensor:
        g = self.plan.geometry
        kernel = self.kernel.to(f.device)
        if g.native:
            if not g.batched:
                return pipeline_apply(self.plan, f, "conv", kernel)
            # one forward of the kernel serves the stack; the spans let a
            # profile split the call's device time between the two
            p = g.prime
            with record_function(CONV_KERNEL_SPAN):
                kernel = DPRT((p, p), self.dtype, self.plan.method,
                              **self._knob_kwargs())(kernel)
            _kernel_pipeline.CONV_KERNEL_FORWARDS += 1
            with record_function(CONV_PIPELINE_SPAN):
                return pipeline_apply(self.plan, f, "conv", kernel)
        # non-native: the true (H, W)-torus convolution = fold of the
        # exact linear convolution; the plan's knobs travel via an
        # ambient scope, which conv resolves per call
        from ..core.conv import circ_conv2d_dprt  # lazy: conv -> radon
        p = self.plan
        with ambient.config(mesh=p.mesh, batch_impl=p.batch_impl,
                            block_rows=p.block_rows,
                            stream_rows=p.stream_rows,
                            block_batch=p.block_batch):
            return circ_conv2d_dprt(f, kernel, method=p.method,
                                    strip_rows=p.strip_rows,
                                    m_block=p.m_block)

    @property
    def T(self) -> "Conv2D":
        """Circular correlation: convolution by the torus-flipped kernel
        (same plan knobs, blocking and batching included)."""
        return Conv2D(self.shape_in, flip_image(self.kernel), self.dtype,
                      self.plan.method, **self._knob_kwargs())

    def __matmul__(self, other):
        return _compose(self, other)

    @property
    def inverse(self):
        raise TypeError(
            "Conv2D has no exact inverse (deconvolution is not an "
            "integer-exact operation)")

    def as_matrix(self, device="cuda") -> torch.Tensor:
        """Dense (H*W, H*W) circulant of this convolution (small N)."""
        size = 1
        for s in self.shape_in:
            size *= s
        basis = torch.eye(size, dtype=self.dtype, device=device)
        cols = [self(e.reshape(self.shape_in)).reshape(-1) for e in basis]
        return torch.stack(cols, dim=1)

    # -- AOT ---------------------------------------------------------------
    def _aot_key(self, device):
        return ("conv2d", self.plan, dtype_name(self.dtype), id(self.kernel),
                str(device))

    def _aot_pins(self) -> tuple:
        return (self.kernel,)

    def _aot_plan(self) -> dict:
        return _plan_record(self.plan)

    def _aot_prepare(self, device):
        """The convolution with its operand made once, on ``device``: the
        kernel image, or for a stack the kernel's projections (one K1
        forward here, none per call) -- then each call is one fused
        pipeline call."""
        g = self.plan.geometry
        if not g.native:
            return self
        kernel = self.kernel.detach().to(device)
        if g.batched:
            p = g.prime
            kernel = DPRT((p, p), self.dtype, self.plan.method,
                          **self._knob_kwargs())(kernel)
        plan = self.plan
        return lambda f: plan.pipeline(f, "conv", kernel)

    def cache_token(self, device="cuda") -> str:
        """Like the transform operators' token, plus a digest of the
        kernel taps: different kernels never share a blob."""
        p = self.plan
        shape = "x".join(str(s) for s in self.shape_in)
        return (f"conv2d_{shape}_{dtype_name(self.dtype)}_{p.method}_"
                f"k{_digest(self.kernel)}_{_knob_token(p)}_"
                f"{_topology_token(torch.device(device), p.mesh)}")

    def describe(self) -> dict:
        d = dict(self.plan.describe())
        d.update(kind="conv2d", kernel_shape=tuple(self.kernel.shape),
                 pipeline=self.plan.backend.pipeline is not None)
        return d

    def __repr__(self) -> str:
        return (f"Conv2D({self.shape_in}, kernel="
                f"{tuple(self.kernel.shape)}, {dtype_name(self.dtype)}, "
                f"method={self.plan.method!r})")


def conv2d_from_description(desc: dict, kernel, mesh=None) -> Conv2D:
    """The port's :class:`Conv2D` for a reference ``Conv2D.describe()``
    dict and the reference operator's ``kernel`` as a numpy array: same
    geometry, dtype, method (``pallas`` -> ``cuda``, ``sharded_pallas``
    -> ``sharded_cuda``) and knobs, so both packages compute the same
    convolution.  A description on a mesh needs ``mesh=``, a DeviceMesh
    with its dim names and sizes."""
    if desc.get("kind") != "conv2d":
        raise ValueError(f"not a Conv2D description: kind="
                         f"{desc.get('kind')!r}")
    mesh = _mesh_for_description(desc, mesh)
    op = Conv2D(desc["image_shape"], torch.from_numpy(np.array(kernel)),
                desc["dtype"], desc["requested_method"],
                strip_rows=desc.get("strip_rows"),
                m_block=desc.get("m_block"),
                block_rows=desc.get("block_rows"),
                stream_rows=desc.get("stream_rows"),
                block_batch=desc.get("block_batch"),
                mesh=mesh)
    if op.plan.method != _canonical_method(desc["method"]):
        raise ValueError(f"description resolved to {desc['method']!r}, the "
                         f"port resolves {desc['requested_method']!r} to "
                         f"{op.plan.method!r}")
    if tuple(op.kernel.shape) != tuple(desc["kernel_shape"]):
        raise ValueError(f"kernel {tuple(op.kernel.shape)} does not match "
                         f"the description's {desc['kernel_shape']}")
    return op


def projection_filter_from_numpy(weights) -> ProjectionFilter:
    """The port's :class:`ProjectionFilter` for a reference filter's
    ``weights`` as a numpy array."""
    return ProjectionFilter(torch.from_numpy(np.array(weights)))


def DPRT(shape, dtype=torch.int32, method: Optional[str] = None, *,
         strip_rows: Optional[int] = None,
         m_block: Optional[int] = None,
         batch_impl: Optional[str] = None,
         block_rows: Optional[int] = None,
         stream_rows: Optional[int] = None,
         block_batch: Optional[int] = None,
         mesh=None) -> RadonOperator:
    """The forward DPRT operator for one input geometry.

    ``shape`` is ``(H, W)`` or ``(B, H, W)`` -- any size; non-prime
    geometries are zero-embedded into the next prime and ``op.inverse``
    crops back.  Knobs left unset resolve against the ambient
    :func:`repro_torch.radon.config` scope, then ``method="auto"`` (the
    ``cuda`` kernel backend for int/float images).  ``stream_rows=H``
    streams giant images through ONE launch of the streamed kernel (K5)
    each way, in strips of at most H rows.  ``mesh`` (a
    ``torch.distributed`` DeviceMesh with dims ``("data", "model")`` or
    ``("model",)``; call on every rank) resolves ``method="auto"`` to
    the ``sharded_cuda`` backend: image rows shard over ``"model"``, a
    batch over ``"data"``, each rank runs K1 on its block, and every
    rank gets the whole result.
    """
    plan = get_plan(
        tuple(int(s) for s in shape), dtype,
        ambient.resolve("method", method, "auto"),
        strip_rows=ambient.resolve("strip_rows", strip_rows),
        m_block=ambient.resolve("m_block", m_block),
        batch_impl=ambient.resolve("batch_impl", batch_impl, "auto"),
        block_rows=ambient.resolve("block_rows", block_rows),
        stream_rows=ambient.resolve("stream_rows", stream_rows),
        block_batch=ambient.resolve("block_batch", block_batch),
        mesh=ambient.resolve("mesh", mesh))
    return RadonOperator(plan, "forward", dtype)


def operator_for(shape, dtype, knobs: tuple) -> RadonOperator:
    """The cached forward operator for one geometry from an
    :func:`repro_torch.radon.ambient.snapshot_knobs` tuple."""
    return DPRT(shape, dtype, **ambient.knobs_kwargs(knobs))
