"""The forward of a narrow integer image sums in int32 and returns the
accumulator dtype (``core/dprt.py:forward_sum_dtype_for``).

An output of the forward, or of the bare skew-sum of N rows, is a sum of
at most N pixels, so for a dtype whose largest magnitude v has
``v*N < 2**31`` int32 sums are exact for every image, even where the
result is int64 (uint8 at N >= 2903, int16 at N >= 257).  The CPU cases
hold the raw functions' plain path against the reference run under x64
in a subprocess (one for the module); at N = 2903 they run strips of a
few rows, since the plain forward of a whole 2903 image takes minutes
on a CPU.  The ``cuda`` cases run K1 and K5 on the card against the int64
plain version; this file does not import JAX.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.core.dprt import accum_dtype_for, forward_sum_dtype_for
from repro_torch.kernels import _build, ops, sfdprt as S, stream as ST
from repro_torch.kernels.tuning import StreamTile

from conftest import run_subprocess

#: (dtype, N, rows of the operand (None: all N), image kinds): uint8 at
#: the first prime whose result is int64, int16 at the first two
CASES = [("uint8", 2903, 6, ("max",)),
         ("int16", 257, None, ("min", "random")),
         ("int16", 263, None, ("min", "random"))]
#: the row_offset strip partial: (first global row, rows) per N
STRIPS = {2903: (1000, 5), 257: (100, 20), 263: (250, 13)}
OPS = ("forward", "core+", "core-", "strip-forward", "strip-core")


def _image(dtype: str, n: int, kind: str) -> np.ndarray:
    info = np.iinfo(dtype)
    if kind == "max":
        return np.full((n, n), info.max, dtype=dtype)
    if kind == "min":
        return np.full((n, n), info.min, dtype=dtype)
    rng = np.random.default_rng(n)
    return rng.integers(info.min, int(info.max) + 1, (n, n), dtype=dtype)


def _operand(dtype, n, rows, kind, op):
    """The (rows, N) operand of ``op`` and its first global row."""
    f = _image(dtype, n, kind)
    if op.startswith("strip"):
        off, h = STRIPS[n]
        return f[off:off + h], off
    return f[:rows or n], 0


PARAMS = [(dt, n, rows, kind, op) for dt, n, rows, kinds in CASES
          for kind in kinds for op in OPS]

_REFERENCE = r"""
import numpy as np
import jax.numpy as jnp
from repro.core.dprt import align_partial, strip_partial
data = dict(np.load(sys.argv[1]))
out = {}
for key, g in data.items():
    if key.endswith("@off"):
        continue
    off = int(data[key + "@off"])
    n = g.shape[1]
    sign = -1 if key.endswith("core-") else 1
    u = align_partial(strip_partial(jnp.asarray(g), n, sign), off, sign)
    u = np.asarray(u)
    if key.split("/")[-1].endswith("forward"):
        row = np.zeros((1, n), dtype=u.dtype)
        row[0, off:off + g.shape[0]] = np.asarray(
            jnp.asarray(g).sum(1, dtype=u.dtype))
        u = np.concatenate([u, row])
    out[key] = u
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's expected output from the reference (strip partials
    aligned to global rows, plus the row-sum row for a forward), in one
    ``JAX_ENABLE_X64=1`` subprocess."""
    d = tmp_path_factory.mktemp("narrow")
    data = {}
    for dt, n, rows, kind, op in PARAMS:
        g, off = _operand(dt, n, rows, kind, op)
        key = f"{dt}/{n}/{kind}/{op}"
        data[key], data[key + "@off"] = g, np.array(off)
    np.savez(d / "in.npz", **data)
    run_subprocess(f"import sys\nsys.argv = ['-c', {str(d / 'in.npz')!r}, "
                   f"{str(d / 'out.npz')!r}]\n{_REFERENCE}", devices=1,
                   extra_env={"JAX_ENABLE_X64": "1"})
    with np.load(d / "out.npz") as out:   # one array in memory at a time
        yield out


@pytest.mark.parametrize("dtype,n,rows,kind,op", PARAMS)
def test_narrow_forward_sums_in_int32_exactly(reference, dtype, n, rows,
                                              kind, op):
    """The raw forward, core (both signs) and row_offset strip partials
    of the dtype's extreme and of seeded images: the accumulator dtype,
    every element equal to the reference's int64 sums."""
    g, off = _operand(dtype, n, rows, kind, op)
    x = torch.from_numpy(g)
    if op.endswith("forward"):
        got = S.dprt_raw(x[None], row_offset=off)[0]
    else:
        got = S.skew_sum_raw(x, -1 if op == "core-" else 1, row_offset=off)
    assert forward_sum_dtype_for(x.dtype, n) == torch.int32
    assert got.dtype == accum_dtype_for(x.dtype, n) == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  reference[f"{dtype}/{n}/{kind}/{op}"])


@pytest.mark.parametrize("dtype,n,want", [
    (torch.uint16, 32749, torch.int32), (torch.uint16, 32771, torch.int64),
    (torch.int16, 65521, torch.int32), (torch.int16, 65537, torch.int64),
    (torch.int16, 257, torch.int32), (torch.uint8, 2903, torch.int32),
    (torch.int8, 65537, torch.int32), (torch.int32, 4099, torch.int32),
    (torch.int64, 13, torch.int64), (torch.float32, 4099, torch.float32),
    (torch.float64, 13, torch.float64)])
def test_forward_sum_dtype_at_its_cliffs(dtype, n, want):
    """int32 while v*N <= 2**31 - 1 for a narrow integer dtype (uint16:
    65535*32768 fits, 65535*32771 does not; int16: 32768*65521 fits),
    else the accumulator dtype; never wider than the accumulator."""
    assert forward_sum_dtype_for(dtype, n) == want
    assert forward_sum_dtype_for(dtype, n).itemsize \
        <= accum_dtype_for(dtype, n).itemsize


def test_out_dtype_pairs_are_checked():
    """The launchers and their plain versions store ``g.dtype``, or int64
    from an int32 operand outside the inverse; nothing else."""
    g = torch.ones((1, 5, 5), dtype=torch.int32)
    corr = torch.zeros((1, 5), dtype=torch.int32)
    for fn, knob in ((S.sfdprt, "strip_rows"), (ST.stream_raw,
                                                 "stream_rows")):
        kw = {knob: 5, "m_block": 8}
        got = fn(g, sign=1, mode="forward", out_dtype=torch.int64, **kw)
        assert got.dtype == torch.int64 and int(got[0, 0, 0]) == 5
        with pytest.raises(TypeError):
            fn(g, sign=-1, mode="inverse", corr=corr, out_dtype=torch.int64,
               **kw)
        with pytest.raises(TypeError):
            fn(g.long(), sign=1, mode="core", out_dtype=torch.int32, **kw)
        with pytest.raises(TypeError):
            fn(g.float(), sign=1, mode="core", out_dtype=torch.float64, **kw)


def test_narrow_route_and_blocks_follow_the_operand(monkeypatch):
    """The route and the blocks follow the 4-byte operand, not the int64
    result: uint8 at N = 7177 (K1 holds 7168 columns of 8-byte sums and
    14336 of 4-byte ones) goes to K1, asking it for int64 outputs."""
    seen = []

    def record(name):
        def fake(g, **kw):
            seen.append((name, g.dtype, kw.get("out_dtype")))
            return torch.zeros(1)
        return fake

    monkeypatch.setattr(S, "sfdprt", record("K1"))
    monkeypatch.setattr(S, "stream_raw", record("K4/K5"))
    x = torch.zeros((1, 2, 7177), dtype=torch.uint8)
    S.dprt_raw(x, row_offset=3)
    S.skew_sum_raw(x[0], 1, row_offset=3)
    S.dprt_raw(x.to(torch.int32), row_offset=3)   # int32: no narrowing
    S.dprt_raw(x.to(torch.int64), row_offset=3)   # 8-byte sums: K5
    assert seen == [("K1", torch.int32, torch.int64),
                    ("K1", torch.int32, torch.int64),
                    ("K1", torch.int32, torch.int32),
                    ("K4/K5", torch.int64, torch.int64)]
    # the wrappers size K1's blocks by the operand (off the table, where
    # the itemsize counts): the same blocks as an int32 image
    sizes = []
    monkeypatch.setattr(ops, "resolve_blocks",
                        lambda n, itemsize, *a, **k: sizes.append(itemsize)
                        or (16, 8))
    monkeypatch.setattr(ops, "dprt_raw", lambda *a, **k: torch.zeros(1, 1))
    monkeypatch.setattr(ops, "idprt_raw", lambda *a, **k: torch.zeros(1, 1))
    ops.dprt_cuda(torch.zeros((3001, 3001), dtype=torch.uint8))
    ops.idprt_cuda(torch.zeros((3002, 3001), dtype=torch.uint8))
    assert sizes == [4, 8]


# ---------------------------------------------------------------------------
# the kernels (need the card)
# ---------------------------------------------------------------------------
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py covers the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["max", "random"])
def test_cuda_k5_uint8_forward_4099_is_exact(kind):
    """K5 at N = 4099, B = 1: the uint8 forward (int32 sums, int64 out)
    equals the int64 plain version bit for bit; one narrow launch per
    forward and none for the inverse, which returns the image."""
    dev = _card()
    n = 4099
    u8 = torch.from_numpy(_image("uint8", n, kind))[None].to(dev)
    before = (ST.NARROW_LAUNCHES, ST.LAUNCHES, S.LAUNCHES)
    r = S.dprt_raw(u8, m_block=64, stream_rows=256)
    torch.cuda.synchronize()
    assert r.dtype == torch.int64
    assert (ST.NARROW_LAUNCHES, ST.LAUNCHES, S.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    want = ST.stream_plain(u8.to(torch.int64), sign=1, mode="forward",
                           stream_rows=256)
    assert torch.equal(r, want)
    del want
    back = S.idprt_raw(r, m_block=64, stream_rows=256)
    torch.cuda.synchronize()
    assert ST.NARROW_LAUNCHES == before[0] + 1
    assert torch.equal(back, u8.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["min", "random"])
def test_cuda_k1_int16_forward_257_is_exact(kind):
    """K1 at N = 257: the int16 forward and core (int32 sums, int64 out,
    negative sums sign-extended) equal the int64 plain version."""
    dev = _card()
    n = 257
    x = torch.from_numpy(_image("int16", n, kind))[None].to(dev)
    x64 = x.to(torch.int64)
    for op, sign in (("forward", 1), ("core", 1), ("core", -1)):
        before = (S.NARROW_LAUNCHES, S.LAUNCHES, ST.LAUNCHES)
        got = (S.dprt_raw(x) if op == "forward"
               else S.skew_sum_raw(x, sign))
        torch.cuda.synchronize()
        assert got.dtype == torch.int64
        assert (S.NARROW_LAUNCHES, S.LAUNCHES, ST.LAUNCHES) == (
            before[0] + 1, before[1] + 1, before[2])
        assert torch.equal(got, S.sfdprt_plain(x64, sign=sign, mode=op))


@pytest.mark.cuda
def test_cuda_uint8_4099_forward_takes_the_4_byte_tile():
    """The uint8 forward at N = 4099, B = 4 streams with K5's 4-byte tile
    (13 columns a lane, 9 directions a block), not the 8-byte one."""
    dev = _card()
    u8 = torch.zeros((4, 4099, 4099), dtype=torch.uint8, device=dev)
    with _build.recording() as rec:
        S.dprt_raw(u8, m_block=64, stream_rows=256)
    torch.cuda.synchronize()
    tiles = [StreamTile(*t) for name, t in rec["tiles"] if name == "stream"]
    assert [(t.cols, t.m_block) for t in tiles] == [(13, 9)]


#: what ptxas reported for ``sfdprt_kernel<int, 8>`` (registers, stack
#: frame, spill stores, spill loads, static shared memory) before the
#: kernel took an output type (nvcc for sm_90a on an H100 host)
K1_INT32_K8_PTXAS = (128, 0, 0, 0, 0)


def _ptxas(log: str, instance: str) -> tuple:
    """(registers, stack bytes, spill stores, spill loads, smem bytes) of
    the kernel whose mangled name holds ``instance`` (the anonymous
    namespace's part of the name differs from build to build)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for " not in line or instance not in line:
            continue
        block = "\n".join(lines[i:i + 4])
        nums = [int(re.search(p, block).group(1)) if re.search(p, block)
                else 0 for p in (r"Used (\d+) registers",
                                 r"(\d+) bytes stack frame",
                                 r"(\d+) bytes spill stores",
                                 r"(\d+) bytes spill loads",
                                 r"(\d+) bytes smem")]
        return tuple(nums)
    raise AssertionError(f"no ptxas report for {instance}")


@pytest.mark.cuda
def test_cuda_k1_int32_instantiation_compiles_as_before():
    """``sfdprt_kernel<int, 8>`` (O = T) keeps its registers, stack and
    shared memory."""
    _card()
    _build.build(["sfdprt"])
    got = _ptxas(_build.build_log("sfdprt"), "13sfdprt_kernelIiLi8EiEEv")
    assert got == K1_INT32_K8_PTXAS
