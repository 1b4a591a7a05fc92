"""The port's AOT surface (``repro_torch.radon.operators``: ``lower`` /
``compile`` / ``cache_token`` / ``export_executable`` /
``import_executable``, :class:`Executable`, the in-process cache and
:class:`PersistentAOTCache`) on the CPU, against the JAX reference where
the two must agree.

In the port an executable is an operator's datapath on one device after
one warm call, with the nvcc libraries that call launched; its bytes are
a JSON header and the raw ``.so`` payloads.  On the CPU the route
launches no library, so the round trip carries none; the install path
is driven with a stand-in library file in a ``tmp_path`` build
directory (there is no nvcc here), and every rotten or torn payload
must raise before anything is installed or handed to ``ctypes.CDLL``.
The persistent cache's counters follow the reference's for the same
sequence: cold, warm, ``corrupt_blobs(seed=0)``, stale fingerprint.
"""
import ctypes
import hashlib
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as RR
from repro.launch import faults as RF
from repro.radon import operators as RO
from repro_torch import radon as TR
from repro_torch.checkpoint.store import list_blobs, save_blob
from repro_torch.kernels import _build
from repro_torch.launch import faults as TF
from repro_torch.launch.router import ServiceRouter
from repro_torch.radon import operators as TO

N = 13
CPU = torch.device("cpu")


def _img(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 100, (b, N, N)).astype(np.int32)


@pytest.fixture(autouse=True)
def _fresh_cache():
    TR.aot_cache_clear()
    yield
    TR.aot_cache_clear()


# ---------------------------------------------------------------------------
# lower / compile / the in-process cache
# ---------------------------------------------------------------------------
def test_lower_resolves_without_building():
    op = TR.DPRT((2, N, N), torch.int32)
    before = TR.trace_count()
    low = op.lower(CPU)
    assert TR.trace_count() == before
    assert low.token == op.cache_token(CPU)
    assert low.plan == json.loads(json.dumps(op.plan.describe()))
    assert TR.aot_cache_info()["currsize"] == 0
    exe = low.compile()
    assert isinstance(exe, TR.Executable) and exe.libraries == ()
    x = torch.from_numpy(_img())
    assert torch.equal(exe(x), op(x))


def test_compile_is_cached_per_key_and_serves_the_same_bits():
    op = TR.DPRT((2, N, N), torch.int32)
    exe = op.compile(CPU)
    assert op.compile("cpu") is exe
    assert op.inverse.compile(CPU) is not exe
    assert TR.aot_cache_info() == {"currsize": 2,
                                   "keys": ["forward", "inverse"]}
    x = torch.from_numpy(_img())
    with TR.retrace_guard(max_traces=0):
        r = exe(x)
        back = op.inverse.compile(CPU)(r)
    assert torch.equal(back, x)
    ref = RR.DPRT((2, N, N), jnp.int32)
    np.testing.assert_array_equal(r.numpy(), np.asarray(ref(_img())))


def test_plan_eviction_drops_executables():
    op = TR.DPRT((3, N, N), torch.int32)
    op.compile(CPU)
    assert TR.aot_cache_info()["currsize"] == 1
    TR.plan_cache_discard([op.plan])
    assert TR.aot_cache_info()["currsize"] == 0


def test_cache_tokens_name_what_the_executable_bakes_in():
    op = TR.DPRT((2, N, N), torch.int32)
    tok = op.cache_token(CPU)
    assert tok.startswith(f"forward_2x{N}x{N}_int32_cuda_") and \
        tok.endswith("_cpu1")
    assert op.inverse.cache_token(CPU).startswith(
        f"inverse_2x{N + 1}x{N}_int32_")
    ref_tok = RR.DPRT((2, N, N), jnp.int32).cache_token()
    # the reference's token with the port's name of the kernel backend
    assert tok == ref_tok.replace("_pallas_", "_cuda_")
    k1 = TR.Conv2D((1, N, N), torch.ones(3, 3, dtype=torch.int32))
    k2 = TR.Conv2D((1, N, N), 2 * torch.ones(3, 3, dtype=torch.int32))
    assert k1.cache_token(CPU).startswith(f"conv2d_1x{N}x{N}_int32_")
    assert k1.cache_token(CPU) != k2.cache_token(CPU)   # kernel digest
    m1 = TR.solve_operator((N, N), torch.int32, mask=TR.direction_mask(
        N, [2], device=CPU), device=CPU)
    m2 = TR.solve_operator((N, N), torch.int32, mask=TR.direction_mask(
        N, [3], device=CPU), device=CPU)
    assert m1.cache_token(CPU).startswith(f"recon_{N + 1}x{N}_float32_")
    assert m1.cache_token(CPU) != m2.cache_token(CPU)   # diagonal digest


# ---------------------------------------------------------------------------
# export / import on the CPU
# ---------------------------------------------------------------------------
def _parse(data):
    header, payloads = TO._parse(data)
    return header, payloads


@pytest.mark.parametrize("kind", ["forward", "inverse", "conv2d", "recon",
                                  "composite"])
def test_export_import_roundtrip_on_cpu(kind):
    base = TR.DPRT((2, N, N), torch.int32)
    w = torch.from_numpy(np.random.default_rng(1).integers(
        0, 5, (N + 1, N)).astype(np.int32))
    op = {"forward": base, "inverse": base.inverse,
          "conv2d": TR.Conv2D((2, N, N), torch.ones(3, 3,
                                                    dtype=torch.int32)),
          "recon": TR.solve_operator((2, N, N), torch.int32,
                                     mask=TR.direction_mask(N, [4],
                                                            device=CPU),
                                     device=CPU),
          "composite": base.inverse @ TR.ProjectionFilter(w) @ base}[kind]
    x = torch.ones(op.shape_in, dtype=op.dtype_in) if kind == "recon" \
        else (torch.from_numpy(_img()) if kind != "inverse"
              else base(torch.from_numpy(_img())))
    want = op(x)
    data = op.export_executable(CPU)
    header, payloads = _parse(data)
    assert header["libraries"] == [] and payloads == []   # CPU: none
    assert header["token"] == op.cache_token(CPU)
    assert header["fingerprint"] == TR.aot_fingerprint(CPU)
    assert header["plan"] == op._aot_plan()
    TR.aot_cache_clear()
    before = TR.trace_count(kind="kernel")
    exe = op.import_executable(data, CPU)
    assert TR.trace_count(kind="kernel") == before
    assert exe.plan == op._aot_plan() and exe.token == op.cache_token(CPU)
    assert op.compile(CPU) is exe            # installed under the op's key
    assert torch.equal(exe(x), want)
    assert TR.aot_cache_info()["currsize"] == 1


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """A stand-in K1 library: a file at its hashed path under a build
    directory of ``tmp_path``, and an executable of a forward operator
    that names it.  Returns (op, the exported bytes, the library bytes,
    the empty build directory an import installs into)."""
    lib_bytes = b"\x7fELF stand-in for libsfdprt " + bytes(range(256)) * 8
    src = tmp_path / "src_build"
    monkeypatch.setattr(_build, "BUILD_DIR", src)
    src.mkdir()
    _build.library_path("sfdprt").write_bytes(lib_bytes)
    op = TR.DPRT((2, N, N), torch.int32)
    exe = op.compile(CPU)
    fake = TR.Executable(exe.fn, exe.token, CPU, exe.plan, ["sfdprt"],
                         [("sfdprt", (1, 2, 3))])
    data = TO._export(fake)
    dst = tmp_path / "dst_build"
    monkeypatch.setattr(_build, "BUILD_DIR", dst)

    def no_nvcc():
        raise AssertionError("nvcc must not run on an import")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    TR.aot_cache_clear()
    return op, data, lib_bytes, dst


def test_import_installs_the_library_at_its_hashed_path(standin):
    op, data, lib_bytes, dst = standin
    header, payloads = _parse(data)
    (lib,) = header["libraries"]
    assert lib["name"] == "sfdprt" and payloads == [lib_bytes]
    assert lib["sha256"] == hashlib.sha256(lib_bytes).hexdigest()
    assert lib["file"] == _build.library_path("sfdprt").name
    assert header["tiles"] == [["sfdprt", [1, 2, 3]]]
    exe = op.import_executable(data, CPU)
    path = _build.library_path("sfdprt")
    assert path.parent == dst and path.read_bytes() == lib_bytes
    assert not [p for p in dst.iterdir() if p.name.endswith(".tmp")]
    assert exe.libraries == ("sfdprt",)
    assert exe.tiles == [["sfdprt", [1, 2, 3]]]
    # a second import keeps the installed file
    op.import_executable(data, CPU)
    assert path.read_bytes() == lib_bytes


def _rotten(data: bytes, how: str, op) -> bytes:
    header, payloads = _parse(data)
    magic = TO._EXE_MAGIC
    if how == "bad_magic":
        return b"XX" + data[2:]
    if how.startswith("torn_"):
        return data[:int(len(data) * float(how.split("_")[1]))]
    if how == "header_byte":
        i = len(magic) + 8 + 32 + 5
        return data[:i] + bytes([data[i] ^ 1]) + data[i + 1:]
    if how == "payload_byte":
        return data[:-7] + bytes([data[-7] ^ 0x40]) + data[-6:]
    if how == "trailing":
        return data + b"\x00"
    if how == "corrupt_blobs":       # faults.corrupt_blobs' payload rot
        rng = np.random.default_rng(0)
        return rng.integers(0, 256, len(data), dtype=np.uint8).tobytes()
    # consistent bytes that describe something else
    if how == "other_token":
        header["token"] = TR.DPRT((3, N, N), torch.int32).cache_token(CPU)
    elif how == "stale_fingerprint":
        header["fingerprint"] = "torch=0.0;cuda=None;device=cpu;kernels=0"
    elif how == "other_plan":
        header["plan"]["m_block"] = 1
    elif how == "other_sources":
        header["libraries"][0]["file"] = "libsfdprt_0123456789abcdef.so"
    elif how == "unknown_library":
        header["libraries"][0]["name"] = "nope"
    raw = json.dumps(header, sort_keys=True).encode()
    return (magic + len(raw).to_bytes(8, "big")
            + hashlib.sha256(raw).digest() + raw + b"".join(payloads))


ROT = ["bad_magic", "torn_0.1", "torn_0.5", "torn_0.9", "torn_0.999",
       "header_byte", "payload_byte", "trailing", "corrupt_blobs",
       "other_token", "stale_fingerprint", "other_plan", "other_sources",
       "unknown_library"]


@pytest.mark.parametrize("how", ROT)
def test_rotten_bytes_raise_before_any_install_or_load(standin, monkeypatch,
                                                       how):
    op, data, _lib, dst = standin
    bad = _rotten(data, how, op)
    loads, installs = [], []

    def no_load(*a, **k):
        loads.append(a)
        raise AssertionError("a library reached ctypes.CDLL")
    monkeypatch.setattr(ctypes, "CDLL", no_load)
    real_install = _build.install
    monkeypatch.setattr(_build, "install",
                        lambda *a: installs.append(a) or real_install(*a))
    with pytest.raises(ValueError):
        op.import_executable(bad, CPU)
    assert not loads and not installs
    assert not dst.exists() or not list(dst.iterdir())
    assert TR.aot_cache_info()["currsize"] == 0


# ---------------------------------------------------------------------------
# the persistent cache: counters against the reference's
# ---------------------------------------------------------------------------
def _ops(pkg):
    if pkg == "port":
        base = TR.DPRT((2, N, N), torch.int32)
        return [base, base.inverse,
                TR.Conv2D((2, N, N), torch.ones(3, 3, dtype=torch.int32))]
    base = RR.DPRT((2, N, N), jnp.int32)
    return [base, base.inverse,
            RR.Conv2D((2, N, N), jnp.ones((3, 3), jnp.int32))]


def _sequence(pkg, directory, monkeypatch):
    """cold, warm, corrupt_blobs(seed=0), stale fingerprint: the counters
    of a fresh cache (a fresh in-memory AOT cache) at each step."""
    mod, faults = (TO, TF) if pkg == "port" else (RO, RF)
    clear = TR.aot_cache_clear if pkg == "port" else RR.aot_cache_clear
    kw = {"device": CPU} if pkg == "port" else {}
    out = []
    for step in ("cold", "warm", "corrupt", "stale"):
        clear()
        if step == "corrupt":
            assert faults.corrupt_blobs(directory, seed=0) == 3
        if step == "stale":
            monkeypatch.setattr(mod, "aot_fingerprint",
                                lambda *a: "stale-environment")
        cache = mod.PersistentAOTCache(directory)
        for op in _ops(pkg):
            cache.get_or_compile(op, **kw)
        s = cache.stats()
        out.append((step, s["hits"], s["misses"], s["errors"],
                    s["degraded_compiles"]))
    monkeypatch.undo()
    clear()
    return out


def test_persistent_counters_match_the_reference(tmp_path, monkeypatch):
    port = _sequence("port", str(tmp_path / "port"), monkeypatch)
    ref = _sequence("reference", str(tmp_path / "ref"), monkeypatch)
    assert port == ref
    assert port == [("cold", 0, 3, 0, 0), ("warm", 3, 0, 0, 0),
                    ("corrupt", 0, 3, 3, 3), ("stale", 0, 3, 0, 3)]


def test_persistent_cache_serves_from_memory_first(tmp_path):
    op = TR.DPRT((2, N, N), torch.int32)
    cache = TR.PersistentAOTCache(str(tmp_path))
    exe = cache.get_or_compile(op, CPU)
    assert cache.get_or_compile(op, CPU) is exe     # no disk event
    s = cache.stats()
    assert (s["hits"], s["misses"], s["errors"]) == (0, 1, 0)
    assert s["lock_steals"] == 0 and s["lock_degraded"] == 0
    assert list_blobs(str(tmp_path)) == [op.cache_token(CPU)]


def test_stale_blob_is_a_silent_miss(tmp_path):
    op = TR.DPRT((2, N, N), torch.int32)
    save_blob(str(tmp_path), op.cache_token(CPU), b"\x00",
              meta={"fingerprint": "torch=0.0;device=nowhere"})
    cache = TR.PersistentAOTCache(str(tmp_path))
    cache.get_or_compile(op, CPU)
    assert (cache.misses, cache.errors, cache.hits) == (1, 0, 0)
    assert cache.degraded_compiles == 1


def test_two_routers_share_one_aot_dir_and_compile_each_token_once(
        tmp_path):
    routers = [ServiceRouter(max_batch=2, aot_dir=str(tmp_path), device=CPU)
               for _ in range(2)]
    errs = []

    def boot(r):
        try:
            r.prefill([{"n": N}, {"n": 17}])
        except Exception as e:      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=boot, args=(r,)) for r in routers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    persistent = [route.service.persistent for r in routers
                  for route in r._routes.values()]
    unique = sum(len(stages) for route in routers[0]._routes.values()
                 for stages in route.service._ops.values())
    assert sum(p.misses for p in persistent) == unique
    assert sum(p.errors for p in persistent) == 0
    assert len(list_blobs(str(tmp_path))) == unique
