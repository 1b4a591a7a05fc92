"""The streamed inverse of int64 projections sums each image in 32 bits
where that image's values allow it (``kernels/stream.py:inverse_gated``).

An inverse output sums N values of ``r[b, :N]``, so its true sum lies in
[N lo_b, N hi_b] for the image's least and largest values; where those fit
int32 and N (hi_b - lo_b) < 2**32 the wrapped 32-bit sum fixes it, and the
result is the int64 route's bit for bit.  The CPU cases run the raw
functions' plain pair (the same gate, int32 sums that wrap, the unsigned
rebuild, int64 ``corr``, floor) against the reference's inverse, run under
x64 in one subprocess for the module, and against the int64 route
(:func:`stream_plain` without bounds), on projections of uint8 and int16
images, at the gate's edges, on a batch that mixes both routes and on
inputs that are no projections.  The ``cuda`` cases run K5 (and K4) on the
card: the N = 4099 round trips of the benchmark's shape, a mixed batch
against today's int64 kernel, the no-sync contract and the forward's
compiled code.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, sfdprt as S, stream as ST

from conftest import run_subprocess

STRIP = 5
SPAN = {n: (2 ** 32 - 1) // n for n in (13, 31, 61)}
LO32, HI32 = -2 ** 31, 2 ** 31 - 1


def _image(dtype: str, n: int, b: int, seed: int) -> np.ndarray:
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, int(info.max) + 1, (b, n, n), dtype=dtype)


def _projections(dtype: str, n: int) -> np.ndarray:
    """The int64 projections of two random images of ``dtype``."""
    x = torch.from_numpy(_image(dtype, n, 2, n).astype(np.int64))
    return S.dprt_raw(x).numpy()


def _spread(n: int, lo: int, span: int, seed: int) -> np.ndarray:
    """One (N+1, N) int64 input, no projection, whose least value is
    ``lo`` and whose largest is ``lo + span``."""
    rng = np.random.default_rng(seed)
    r = rng.integers(lo, lo + span + 1, (n + 1, n), dtype=np.int64)
    r[0, 0], r[n - 1, 1] = lo, lo + span
    return r


#: name -> (the (B, N+1, N) int64 input, images the gate sends to 32 bits)
EDGES = {
    "span-fits-13": (_spread(13, -7, SPAN[13], 1)[None], 1),
    "span-past-13": (_spread(13, -7, SPAN[13] + 1, 2)[None], 0),
    "span-fits-61": (_spread(61, 10 ** 6, SPAN[61], 3)[None], 1),
    "span-past-61": (_spread(61, 10 ** 6, SPAN[61] + 1, 4)[None], 0),
    "lo-at-int32-min": (_spread(31, LO32, SPAN[31], 5)[None], 1),
    "lo-below-int32-min": (_spread(31, LO32 - 1, SPAN[31], 6)[None], 0),
    "hi-at-int32-max": (_spread(31, HI32 - SPAN[31], SPAN[31], 7)[None], 1),
    "hi-past-int32-max": (_spread(31, HI32 + 1 - SPAN[31], SPAN[31], 8)[None],
                          0),
    "negative-numerators": (np.random.default_rng(9).integers(
        -1000, 1000, (3, 14, 13), dtype=np.int64), 3),
    "mixed": (np.stack([_projections("uint8", 13)[0],
                        _spread(13, -2 ** 40, 2 ** 41, 10)]), 1),
}
PROJ = [(dt, n) for dt in ("uint8", "int16") for n in (13, 31, 61)]

_REFERENCE = r"""
import numpy as np
import jax.numpy as jnp
from repro.core.dprt import idprt
data = dict(np.load(sys.argv[1]))
np.savez(sys.argv[2], **{k: np.asarray(idprt(jnp.asarray(r)))
                         for k, r in data.items()})
"""


def _inputs() -> dict:
    out = {f"{dt}-{n}": _projections(dt, n) for dt, n in PROJ}
    out.update({k: r for k, (r, _) in EDGES.items()})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's inverse of every CPU case, in one
    ``JAX_ENABLE_X64=1`` subprocess."""
    d = tmp_path_factory.mktemp("narrow_inverse")
    np.savez(d / "in.npz", **_inputs())
    run_subprocess(f"import sys\nsys.argv = ['-c', {str(d / 'in.npz')!r}, "
                   f"{str(d / 'out.npz')!r}]\n{_REFERENCE}", devices=1,
                   extra_env={"JAX_ENABLE_X64": "1"})
    with np.load(d / "out.npz") as out:
        yield {k: out[k] for k in out.files}


def _int64_route(r: torch.Tensor) -> torch.Tensor:
    """Today's int64 inverse of ``r``: the plain version, no bounds."""
    n = r.shape[-1]
    corr = (r[:, n] - r[:, 0].sum(1, keepdim=True)).contiguous()
    return ST.stream_plain(r[:, :n].contiguous(), sign=-1, mode="inverse",
                           stream_rows=STRIP, corr=corr)


def _gated(r: torch.Tensor) -> tuple:
    """(result, gated calls, images sent to 32 bits) of one raw inverse."""
    ST.reset_launch_counts()
    got = S.idprt_raw(r, m_block=8, stream_rows=STRIP)
    return (got, ST.NARROW_INVERSE_LAUNCHES,
            ST.narrow_inverse_images("cpu"))


@pytest.mark.parametrize("dtype,n", PROJ)
def test_projections_of_narrow_images_sum_in_32_bits(reference, dtype, n):
    """The int64 projections of uint8 and int16 images: every image takes
    32-bit sums, and the result is the reference's, the int64 route's and
    the image itself."""
    r = torch.from_numpy(_projections(dtype, n))
    got, calls, narrow = _gated(r)
    assert (calls, narrow) == (1, 2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), reference[f"{dtype}-{n}"])
    assert torch.equal(got, _int64_route(r))
    np.testing.assert_array_equal(got.numpy(), _image(dtype, n, 2, n))


@pytest.mark.parametrize("name", list(EDGES))
def test_gate_edges_and_mixed_batches_match_the_int64_route(reference, name):
    """At the gate's edges (N (hi - lo) at and one past 2**32 - 1; lo at
    and below -2**31; hi at and past 2**31 - 1), on inputs that are no
    projections (inexact floor divides of negative numerators) and on a
    batch of one narrow and one wide image: the images the gate sends to
    32 bits are counted, and every element is the int64 route's and the
    reference's."""
    r = torch.from_numpy(EDGES[name][0])
    n = r.shape[-1]
    got, calls, narrow = _gated(r)
    assert (calls, narrow) == (1, EDGES[name][1])
    bounds = torch.stack([r[:, :n].amin((1, 2)), r[:, :n].amax((1, 2))])
    assert int(ST.narrow_fits(bounds, n).sum()) == EDGES[name][1]
    assert torch.equal(got, _int64_route(r))
    np.testing.assert_array_equal(got.numpy(), reference[name])


def test_the_halves_write_only_their_images():
    """Each half of the pair, run alone, writes the images its gate gives
    it and leaves the others as ``out`` holds them; the narrow half adds
    its images to the tally."""
    r = torch.from_numpy(EDGES["mixed"][0])
    n = r.shape[-1]
    g = r[:, :n].contiguous()
    corr = (r[:, n] - r[:, 0].sum(1, keepdim=True)).contiguous()
    bounds = torch.stack([g.amin((1, 2)), g.amax((1, 2))]).contiguous()
    want = _int64_route(r)
    ST.reset_launch_counts()
    out = torch.full_like(want, -5)
    kw = dict(sign=-1, mode="inverse", stream_rows=STRIP, m_block=8,
              corr=corr, bounds=bounds, out=out)
    ST.stream_raw(g.to(torch.int32), out_dtype=torch.int64, **kw)
    assert torch.equal(out[0], want[0]) and (out[1] == -5).all()
    assert ST.narrow_inverse_images("cpu") == 1
    ST.stream_raw(g, **kw)
    assert torch.equal(out, want)
    assert ST.narrow_inverse_images("cpu") == 1


def test_counters_and_the_routes_that_keep_one_launch(monkeypatch):
    """NARROW_INVERSE_LAUNCHES counts gated calls and the tally their
    narrow images; NARROW_LAUNCHES keeps counting the narrow forward
    only; K1's inverse (no stream_rows) and the int32 inverse keep their
    single call; the gated pair keeps the caller's ``stream_impl``,
    and N too wide for K1's 8-byte block takes it in strips of
    ``strip_rows``, each half picking K5 or K4 by its own width."""
    r = torch.from_numpy(np.concatenate([_projections("uint8", 13),
                                         EDGES["mixed"][0]]))
    ST.reset_launch_counts()
    S.idprt_raw(r, m_block=8, stream_rows=STRIP)
    S.idprt_raw(r[:1], m_block=8, stream_rows=STRIP)
    assert ST.NARROW_INVERSE_LAUNCHES == 2
    assert ST.narrow_inverse_images("cpu") == 3 + 1
    assert ST.NARROW_LAUNCHES == ST.LAUNCHES == 0
    S.idprt_raw(r, m_block=8)                          # K1: no gate
    S.idprt_raw(r.to(torch.int32), m_block=8, stream_rows=STRIP)
    assert ST.NARROW_INVERSE_LAUNCHES == 2
    assert ST.narrow_inverse_images("cpu") == 4
    ST.reset_launch_counts()
    assert (ST.NARROW_INVERSE_LAUNCHES, ST.narrow_inverse_images("cpu")) \
        == (0, 0)

    seen = []
    real = ST.stream_raw

    def record(g, **kw):
        seen.append((g.dtype, kw["stream_impl"], kw["stream_rows"],
                     kw["bounds"] is not None))
        return real(g, **kw)

    monkeypatch.setattr(ST, "stream_raw", record)
    S.idprt_raw(r, m_block=8, stream_rows=STRIP)      # the caller's impl
    S.idprt_raw(r, m_block=8, stream_rows=STRIP, stream_impl="grid")
    assert seen == [(torch.int32, None, STRIP, True),
                    (torch.int64, None, STRIP, True),
                    (torch.int32, "grid", STRIP, True),
                    (torch.int64, "grid", STRIP, True)]
    seen.clear()
    monkeypatch.setattr(S, "skew_holds", lambda n, itemsize: False)
    S.idprt_raw(r, strip_rows=7, m_block=8, stream_impl="grid")
    assert seen == [(torch.int32, "dma", 7, True),
                    (torch.int64, "dma", 7, True)]
    seen.clear()        # N past K5's 8-byte ring, within its 4-byte one
    monkeypatch.setattr(S, "stream_dma_holds",
                        lambda n, itemsize: itemsize == 4)
    S.idprt_raw(r, strip_rows=7, m_block=8)
    assert seen == [(torch.int32, "dma", 7, True),
                    (torch.int64, "grid", 7, True)]


def test_bounds_and_out_are_checked():
    """Bounds gate only the inverse of an int32 or int64 operand, need an
    int64 ``corr`` and (for int32) an int64 output; ``out`` must match;
    without bounds an int32 inverse still refuses an int64 output."""
    g = torch.ones((2, 5, 5), dtype=torch.int32)
    corr64 = torch.zeros((2, 5), dtype=torch.int64)
    bounds = torch.zeros((2, 2), dtype=torch.int64)
    kw = dict(sign=-1, mode="inverse", stream_rows=5, m_block=8)
    got = ST.stream_raw(g, corr=corr64, bounds=bounds,
                        out_dtype=torch.int64, **kw)
    assert got.dtype == torch.int64
    with pytest.raises(ValueError):                   # int32 corr
        ST.stream_raw(g, corr=corr64.int(), bounds=bounds,
                      out_dtype=torch.int64, **kw)
    with pytest.raises(TypeError):                    # int32 output
        ST.stream_raw(g, corr=corr64, bounds=bounds, **kw)
    with pytest.raises(TypeError):                    # no bounds
        ST.stream_raw(g, corr=corr64.int(), out_dtype=torch.int64, **kw)
    with pytest.raises(ValueError):                   # (B, 2), not (2, B)
        ST.stream_raw(g, corr=corr64, bounds=torch.zeros((2, 3),
                                                         dtype=torch.int64),
                      out_dtype=torch.int64, **kw)
    with pytest.raises(ValueError):                   # not the inverse
        ST.stream_raw(g, sign=1, mode="forward", stream_rows=5, m_block=8,
                      bounds=bounds, out_dtype=torch.int64)
    with pytest.raises(ValueError):                   # a float operand
        ST.stream_raw(g.float(), corr=corr64.float(), bounds=bounds, **kw)
    with pytest.raises(ValueError):                   # out of another dtype
        ST.stream_raw(g.long(), corr=corr64, bounds=bounds,
                      out=torch.empty((2, 5, 5), dtype=torch.int32), **kw)


# ---------------------------------------------------------------------------
# the kernels (need the card)
# ---------------------------------------------------------------------------
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py covers the kernels")
    return torch.device("cuda")


def _u8_batch(kind: str, n: int, b: int) -> np.ndarray:
    """``b`` uint8 images: all 255, random, or rows alternately 255 and 0
    (its row sums R(N, i) span 0 .. 255 N: the widest projections)."""
    if kind == "max":
        return np.full((b, n, n), 255, dtype=np.uint8)
    if kind == "random":
        return _image("uint8", n, b, n)
    x = np.zeros((b, n, n), dtype=np.uint8)
    x[:, ::2] = 255
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["max", "random", "widest"])
def test_cuda_k5_uint8_roundtrip_4099_sums_in_32_bits(kind):
    """K5 at N = 4099, B = 4: the uint8 round trip is exact, the inverse
    is one gated call of two launches, and all 4 images take 32 bits."""
    dev = _card()
    n, b = 4099, 4
    u8 = torch.from_numpy(_u8_batch(kind, n, b)).to(dev)
    r = S.dprt_raw(u8, m_block=64, stream_rows=256)
    torch.cuda.synchronize()
    ST.reset_launch_counts()
    back = S.idprt_raw(r, m_block=64, stream_rows=256)
    torch.cuda.synchronize()
    assert (ST.NARROW_INVERSE_LAUNCHES, ST.LAUNCHES,
            ST.IMPL_MODE_LAUNCHES[("dma", "inverse")]) == (1, 2, 2)
    assert ST.narrow_inverse_images(dev) == b
    assert torch.equal(back, u8.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("stream_impl", ["grid", "dma"])
@pytest.mark.parametrize("n", [61, 4099])
def test_cuda_mixed_batch_matches_the_int64_kernel(n, stream_impl):
    """A batch of a narrow image (uint8 projections), a wide one (values
    spread over 2**40) and one at the gate's edge: the gated pair equals
    today's int64 kernel, run without bounds, bit for bit."""
    dev = _card()
    rng = np.random.default_rng(n)
    proj = S.dprt_raw(torch.from_numpy(_image("uint8", n, 1, n)).to(dev)
                      .to(torch.int64), m_block=64, stream_rows=256)
    wide = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (1, n + 1, n),
                                         dtype=np.int64)).to(dev)
    edge = torch.from_numpy(_spread(n, LO32, (2 ** 32 - 1) // n, n)[None]
                            ).to(dev)
    r = torch.cat([proj, wide, edge])
    ST.reset_launch_counts()
    got = S.idprt_raw(r, m_block=64, stream_rows=256, stream_impl=stream_impl)
    corr = (r[:, n] - r[:, 0].sum(1, keepdim=True)).contiguous()
    want = ST.stream_raw(r[:, :n], sign=-1, mode="inverse", stream_rows=256,
                         m_block=64, corr=corr, stream_impl=stream_impl)
    torch.cuda.synchronize()
    assert ST.narrow_inverse_images(dev) == 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_inverse_adds_no_host_sync():
    """``op.inverse(r)`` of a uint8 image at N = 4099 with ``stream_rows``
    (the gated pair) runs under ``set_sync_debug_mode("error")``."""
    from repro_torch import radon
    dev = _card()
    n = 4099
    op = radon.DPRT((1, n, n), torch.uint8, stream_rows=256)
    x = torch.from_numpy(_u8_batch("random", n, 1)).to(dev)
    r = op(x)
    op.inverse(r)                                   # warm: plan, tally
    torch.cuda.synchronize()
    ST.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        back = op.inverse(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ST.NARROW_INVERSE_LAUNCHES == 1
    assert torch.equal(back, x.to(torch.int64))


#: what ptxas reported for the forward's ``stream_kernel<int, 1, long>``
#: (registers, stack frame, spill stores, spill loads, static shared
#: memory) before the narrow inverse (nvcc for sm_90a on an H100 host)
K5_INT32_INT64_DMA_PTXAS = (128, 0, 0, 0, 0)


@pytest.mark.cuda
def test_cuda_k5_forward_instantiation_compiles_as_before():
    """The forward's instantiation keeps its registers, stack, spills and
    shared memory; the narrow variant spills nothing."""
    from test_torch_narrow_sums import _ptxas
    _card()
    _build.build(["stream"])
    log = _build.build_log("stream")
    assert _ptxas(log, "13stream_kernelIiLi1ElLb0EE") \
        == K5_INT32_INT64_DMA_PTXAS
    narrow = _ptxas(log, "13stream_kernelIiLi1ElLb1EE")
    assert narrow[1:4] == (0, 0, 0)


def test_launch_argtypes_match_the_c_signature():
    """The ctypes signature of ``stream_launch`` has the C function's
    parameters, pointer for pointer: a pointer passed where ctypes has
    no type left is truncated to a C int."""
    import ctypes
    import re
    src = (_build.CSRC / "stream.cu").read_text()
    sig = re.search(r'extern "C" int stream_launch\((.*?)\)\s*\{', src,
                    re.S).group(1)
    kinds = []
    for param in sig.split(","):
        words = param.split()
        kinds.append(ctypes.c_void_p if "*" in param
                     else ctypes.c_longlong if words[:2] == ["long", "long"]
                     else ctypes.c_int)
    assert tuple(kinds) == ST.LAUNCH_ARGTYPES
