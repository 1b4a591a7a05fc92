"""Build and load the port's hand-written CUDA kernels.

Each library in :data:`LIBRARIES` is compiled from ``csrc/`` with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes`` -- no PyTorch headers, so a build takes
seconds.  Builds happen at first use (never at import), go to
``build/repro_torch/`` at the repository root, and are keyed by a hash
of the sources, every header in ``csrc/`` (``*.cuh``, which the sources
include) and the flags, so a second run reuses the ``.so`` and an edit
to a shared header rebuilds every library.
Several libraries build in parallel: one ``nvcc`` per library, all
started together.  The toolkit is found the way PyTorch finds it
(``torch.utils.cpp_extension.CUDA_HOME``); nothing else outside the
repository is used.

The serving tier's persistent executable cache ships these libraries:
:func:`recording` collects, per thread, the libraries (and tiles) that
the kernel wrappers launch (:func:`note_launch`), and :func:`install`
puts a library's bytes at its hashed path by atomic rename, so a
restarted process loads it with no nvcc run.  :data:`COUNT_LOCK` guards
the wrappers' launch counters, which serving threads update together.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

__all__ = ["LIBRARIES", "NVCC_FLAGS", "BUILD_DIR", "build", "load",
           "build_log", "add_build_hook", "library_path", "sources_hash",
           "install", "recording", "note_launch", "COUNT_LOCK"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: library name -> its sources under csrc/
LIBRARIES: Dict[str, tuple] = {"sfdprt": ("sfdprt.cu",),
                               "pipeline": ("pipeline.cu",),
                               "stream": ("stream.cu",)}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
_BUILD_HOOKS: list = []
#: guards the kernel wrappers' launch counters (serving threads launch
#: concurrently)
COUNT_LOCK = threading.Lock()
_TLS = threading.local()


def add_build_hook(fn: Callable[[str], None]) -> None:
    """``fn(name)`` runs after every compile of library ``name`` -- the
    radon layer counts these as retraces."""
    _BUILD_HOOKS.append(fn)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where library ``name`` of the current sources lives (its file name
    carries the hash of the sources, headers and flags)."""
    return _lib_path(name)


def sources_hash() -> str:
    """One hash of the flags and every file under ``csrc/``: an edit to
    any kernel source changes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def install(name: str, data: bytes) -> Path:
    """Put ``data``, a build of library ``name``, at its hashed path under
    :data:`BUILD_DIR` by atomic rename (a library already there is kept),
    so :func:`load` finds it and runs no nvcc.  The caller has verified
    the bytes."""
    path = _lib_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


@contextlib.contextmanager
def recording():
    """Collect what the kernel wrappers launch on this thread inside the
    scope: ``{"libraries": set of names, "tiles": [(name, tile), ...]}``
    (each distinct tile once, in launch order)."""
    rec = {"libraries": set(), "tiles": []}
    stack = _TLS.__dict__.setdefault("stack", [])
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def note_launch(name: str, tile=None) -> None:
    """A wrapper's record of one launch of library ``name``'s kernel with
    ``tile``, for the thread's open :func:`recording` scopes."""
    for rec in getattr(_TLS, "stack", ()):
        rec["libraries"].add(name)
        if tile is not None:
            entry = (name, tuple(int(v) for v in tile))
            if entry not in rec["tiles"]:
                rec["tiles"].append(entry)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (torch.utils.cpp_extension.CUDA_HOME is "
            "None): the port's kernels are built with nvcc for sm_90a")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of library ``name``, or '' when it was reused."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` per library, all started together.  Returns seconds per
    library (0.0 for a reused build); raises on a failed compile."""
    names = list(LIBRARIES if names is None else names)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    out = {n: 0.0 for n in names}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in LIBRARIES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        for fn in _BUILD_HOOKS:
            fn(name)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
