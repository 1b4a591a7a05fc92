"""The giant-N streaming slice of the port (``stream_rows``, kernels K4/K5)
against the reference's streamed Pallas kernel on the CPU.

The reference's ``stream_impl="grid"`` kernel runs in interpret mode here
(its ``"dma"`` variant needs TPU memory spaces this JAX does not have), so
the port's ``"grid"`` and ``"dma"`` are both held against it and against
the numpy oracle.  On a CPU tensor the port's wrapper runs the kernel's
plain version (:func:`repro_torch.kernels.stream.stream_plain`); integer
results are bit-exact, including strip heights that do not divide N (a
short last strip), ``row_offset`` partials, adjoints, the staged pipeline
route and int32 overflow.  The CUDA kernel itself runs only on a card: the
``cuda``-marked test skips here, and ``chip_smoke.py`` covers the kernel
on the card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as R
from repro.core.dprt import dprt_oracle_np
from repro.core.plan import get_plan as r_get_plan
from repro.kernels.sfdprt import (dprt_pallas_raw, idprt_pallas_raw,
                                  skew_sum_pallas_raw)
from repro.kernels.tuning import resolve_blocks as r_resolve_blocks
from repro_torch import radon as T
from repro_torch.core import plan as TP
from repro_torch.kernels import ops, sfdprt as S, stream as ST
from repro_torch.kernels import tuning as TT

IMPLS = ["grid", "dma"]


def _img(n, b=None, seed=0, lo=0, hi=250):
    rng = np.random.default_rng(seed)
    shape = (n, n) if b is None else (b, n, n)
    return rng.integers(lo, hi, shape, dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _ref_raw(n, sr):
    """The reference's streamed grid kernel on a (3, N, N) stack: forward,
    inverse of the forward, skew-sums of both signs."""
    fb = jnp.asarray(_img(n, b=3, seed=n))
    r = dprt_pallas_raw(fb, stream_rows=sr, m_block=8, stream_impl="grid")
    back = idprt_pallas_raw(r, stream_rows=sr, m_block=8,
                            stream_impl="grid")
    skews = {s: np.asarray(skew_sum_pallas_raw(fb, s, stream_rows=sr,
                                               m_block=8,
                                               stream_impl="grid"))
             for s in (1, -1)}
    return np.asarray(fb), np.asarray(r), np.asarray(back), skews


# ---------------------------------------------------------------------------
# raw functions: streamed == reference == oracle, short last strip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stream_impl", IMPLS)
@pytest.mark.parametrize("n,sr", [(13, 5), (61, 7)])
def test_streamed_raw_matches_reference(n, sr, stream_impl):
    assert n % sr != 0, "the test wants a short last strip"
    f, want_r, want_back, want_skew = _ref_raw(n, sr)
    r = S.dprt_raw(_t(f), m_block=8, stream_rows=sr,
                   stream_impl=stream_impl)
    np.testing.assert_array_equal(r.numpy(), want_r)
    for b in range(3):
        np.testing.assert_array_equal(r[b].numpy(), dprt_oracle_np(f[b]))
    back = S.idprt_raw(r, m_block=8, stream_rows=sr, stream_impl=stream_impl)
    np.testing.assert_array_equal(back.numpy(), want_back)
    np.testing.assert_array_equal(back.numpy(), f)
    for sign in (1, -1):
        got = S.skew_sum_raw(_t(f), sign, m_block=8, stream_rows=sr,
                             stream_impl=stream_impl)
        np.testing.assert_array_equal(got.numpy(), want_skew[sign])


@pytest.mark.parametrize("stream_impl", IMPLS)
def test_streamed_row_offset_partials(stream_impl):
    """A streamed partial over a row strip at global row 7 (core and
    forward) equals the reference's streamed partial."""
    n, rows, off = 13, 6, 7
    g = _img(n, seed=5)[:rows]
    want = skew_sum_pallas_raw(jnp.asarray(g), 1, stream_rows=4, m_block=8,
                               row_offset=off, stream_impl="grid")
    got = S.skew_sum_raw(_t(g), 1, m_block=8, row_offset=off, stream_rows=4,
                         stream_impl=stream_impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_f = dprt_pallas_raw(jnp.asarray(g)[None], stream_rows=4, m_block=8,
                             row_offset=off, stream_impl="grid")
    got_f = S.dprt_raw(_t(g)[None], m_block=8, row_offset=off,
                       stream_rows=4, stream_impl=stream_impl)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_streamed_plain_wraps_int32_like_the_reference():
    """Sums past 2**31 wrap in the streamed plain version exactly as the
    reference's int32 kernel wraps them, and the inverse of the wrapped
    projections matches the reference's inverse."""
    n = 13
    big = 2 ** 28
    f = np.random.default_rng(9).integers(big // 2, big, (2, n, n)).astype(
        np.int32)
    want = np.asarray(dprt_pallas_raw(jnp.asarray(f), stream_rows=5,
                                      m_block=8, stream_impl="grid"))
    exact = dprt_oracle_np(f[0].astype(np.int64))
    assert exact.max() >= 2 ** 31          # the int32 sums wrap
    assert (want[0] != exact).any()
    got = S.dprt_raw(_t(f), m_block=8, stream_rows=5)
    np.testing.assert_array_equal(got.numpy(), want)
    want_i = idprt_pallas_raw(jnp.asarray(want), stream_rows=5, m_block=8,
                              stream_impl="grid")
    got_i = S.idprt_raw(_t(want), m_block=8, stream_rows=5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_streamed_plain_n251_table_blocks_vs_oracle():
    """One N = 251 image through the streamed wrappers with the table's
    m_block and stream_rows 64 (four strips, the last one short)."""
    n = 251
    f = _img(n, b=1, seed=251)
    r = ops.dprt_cuda(_t(f), stream_rows=64)
    np.testing.assert_array_equal(r[0].numpy(), dprt_oracle_np(f[0]))
    np.testing.assert_array_equal(ops.idprt_cuda(r, stream_rows=64).numpy(),
                                  f)


def test_stream_impl_is_validated():
    f = _t(_img(13, b=1))
    with pytest.raises(ValueError, match="stream_impl must be 'grid' or "
                                         "'dma'") as port_err:
        S.dprt_raw(f, m_block=8, stream_rows=5, stream_impl="bogus")
    with pytest.raises(ValueError) as ref_err:
        dprt_pallas_raw(jnp.asarray(f.numpy()), stream_rows=5, m_block=8,
                        stream_impl="bogus")
    assert str(port_err.value) == str(ref_err.value)
    assert ST.resolve_impl(None) == "dma"


# ---------------------------------------------------------------------------
# the Hopper tile: sums in registers, shared memory for stages only
# ---------------------------------------------------------------------------
def _block_map(n, tile, out_rows, block):
    """The outputs the lanes of block ``block`` of an image hold, as in
    ``csrc/stream.cu``: the block owns directions ``[block*D,
    (block+1)*D)``; its item ``q = warp*items + item`` is direction
    ``block*D + q // runs`` (m < N; row N is no item) and column run
    ``c = q % runs``, and lane L holds columns ``32*cols*c + L + 32*j``,
    j < cols, below N.  Returns arrays (warp, item, lane, j, m, d)."""
    m0 = block * tile.m_block
    m_skew = max(0, min(tile.m_block, out_rows - m0, n - m0))
    warp, item, lane, j = np.meshgrid(
        np.arange(tile.warps), np.arange(tile.items), np.arange(32),
        np.arange(tile.cols), indexing="ij")
    q = warp * tile.items + item
    m = m0 + q // tile.runs
    d = 32 * tile.cols * (q % tile.runs) + lane + 32 * j
    keep = (q < m_skew * tile.runs) & (d < n)
    return tuple(a[keep] for a in (warp, item, lane, j, m, d))


def _window(n, tile, m, d, sign, row):
    """The padded-row column the lane holding output (m, d) loads at
    global image row ``row``: its item's window base, which the kernel
    steps by ``<sign*m>_N`` per row from ``<32*cols*c>_N`` and wraps by
    subtracting N, plus ``d - 32*cols*c``.  Column x of a padded row is
    image column ``x mod N``."""
    c = d // (32 * tile.cols)
    step = m if sign > 0 or m == 0 else n - m
    w = (32 * tile.cols * c) % n
    for _ in range(row):
        w = w + step - n if w + step >= n else w + step
    return w + d - 32 * tile.cols * c


@pytest.mark.parametrize("n,itemsize,impl,want", [
    (4099, 4, "dma", (4, 3, 9, 15)), (4099, 8, "dma", (2, 3, 4, 13)),
    (4099, 4, "grid", (12, 1, 7, 12)), (2053, 4, "dma", (7, 3, 16, 14)),
    (13, 4, "dma", (5, 3, 6, 1))])
def test_stream_tile_fits_shared_memory(n, itemsize, impl, want):
    """(stage rows, ring slots, directions per block, consumer warps) of
    the giant-N shapes (N = 4099 int32 at the serve batch of 4) and a
    small one.  The block's registers (its accumulators) and shared
    memory (its stages) stay within one SM's; ``stream_rows`` caps the
    stage, ``m_block`` the directions; every row slot is a 16-byte
    multiple that holds the row, its padding and the lead that puts it at
    its source's address mod 16, so each row's aligned interior moves as
    one bulk copy whatever the stage height."""
    stream_rows = 5 if n == 13 else 256
    m_block = 8 if n == 13 else 64
    batch = 4 if (n, itemsize) == (4099, 4) else 1
    t = TT.stream_tile(n, n, itemsize, stream_rows, m_block, n + 1, impl,
                       batch=batch)
    assert (t.stage_rows, t.slots, t.m_block, t.warps) == want
    # registers: each thread's accumulators (two registers for 8 bytes),
    # a window base and a step per item, and ~14 more, for every thread
    # of the block (K5: one producer warp more), within the SM's 65,536
    regs = t.items * (t.cols * itemsize // 4 + 2) + 14
    assert 32 * (t.warps + (impl == "dma")) * regs <= 65536
    assert t.warps <= TT.STREAM_WARPS[impl]
    assert t.warps * t.items >= t.m_block * t.runs
    assert t.runs * 32 * t.cols >= n and t.pad == 32 * t.cols - 1
    assert t.smem == TT.stream_smem(n, itemsize, t.stage_rows, t.slots)
    assert t.smem <= TT.STREAM_SMEM_BUDGET
    assert t.stage_rows <= min(stream_rows, n) and t.m_block <= m_block
    assert t.row_bytes % 16 == 0
    assert t.row_bytes >= (n + t.pad) * itemsize + 16 - itemsize
    if impl == "grid":       # one stage of all the rows that fit
        assert t.slots == 1 and (t.stage_rows == min(stream_rows, n) or
                                 TT.stream_smem(n, itemsize, t.stage_rows
                                                + 1, 1)
                                 > TT.STREAM_SMEM_BUDGET)
    else:                    # a ring of at least two stages
        assert t.slots >= min(2, -(-n // t.stage_rows))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [5, 13, 61, 251, 4099])
def test_stream_thread_map_covers_each_output_once(n, itemsize):
    """The launcher's tile maps (direction block, warp, item, lane, j)
    onto every output (m, d), m < N, exactly once, for the forward's N + 1
    rows (row N is summed apart) and the inverse's N; and each lane's
    window, stepped along the rows, loads column <d + sign*m*i>_N from
    inside its padded row.  N = 251 and 4099 are arithmetic only."""
    m_block = TT.pallas_block_spec(n, itemsize)[1]
    rng = np.random.default_rng(n * itemsize)
    for out_rows in (n + 1, n):
        tile = TT.stream_tile(n, n, itemsize, 256, m_block, out_rows,
                              batch=4)
        covered, seen = 0, []
        for blk in range(tile.blocks):
            warp, item, lane, j, m, d = _block_map(n, tile, out_rows, blk)
            m0 = blk * tile.m_block
            here = max(0, min(tile.m_block, out_rows - m0, n - m0))
            assert (warp < tile.warps).all() and (item < tile.items).all()
            assert ((m >= m0) & (m < m0 + here)).all() and (d < n).all()
            hits = np.bincount((m - m0) * n + d, minlength=here * n)
            assert hits.size == here * n and (hits == 1).all()
            covered += here
            pick = (slice(None) if n <= 61
                    else rng.choice(len(m), min(len(m), 60), replace=False))
            seen.append(np.stack([m[pick], d[pick]], 1))
        assert covered == n
        outputs = np.concatenate(seen)
        if n > 61:
            outputs = outputs[rng.choice(len(outputs), 500, replace=False)]
            rows = rng.choice(n, 4, replace=False)
        else:
            rows = range(n)
        for m, d in outputs:
            for i in rows:
                for sign in (1, -1):
                    x = _window(n, tile, int(m), int(d), sign, int(i))
                    assert 0 <= x < n + tile.pad
                    assert x % n == (d + sign * m * i) % n


def test_stream_tile_raises_when_no_row_fits():
    with pytest.raises(ValueError, match="N=40009 8-byte"):
        TT.stream_tile(40009, 40009, 8, 256, 64, 40010)


# ---------------------------------------------------------------------------
# the plan layer
# ---------------------------------------------------------------------------
def test_streamed_plan_matches_reference():
    """forward / inverse / adjoint / inverse_adjoint of a stream_rows plan
    on the cuda backend equal the reference's pallas plan."""
    n, sr = 61, 7
    f = _img(n, seed=2)
    rp = r_get_plan(f.shape, jnp.int32, "pallas", stream_rows=sr)
    tp = TP.get_plan(f.shape, torch.int32, "pallas", stream_rows=sr)
    assert tp.method == "cuda" and tp.stream_rows == sr
    assert tp._scan_rows is None
    oracle = dprt_oracle_np(f)
    r = tp.forward(_t(f))
    np.testing.assert_array_equal(r.numpy(), oracle)
    np.testing.assert_array_equal(tp.inverse(r).numpy(), f)
    ra = oracle.astype(np.int32)
    np.testing.assert_array_equal(tp.adjoint(_t(ra)).numpy(),
                                  np.asarray(rp.adjoint(jnp.asarray(ra))))
    np.testing.assert_array_equal(
        tp.inverse_adjoint(_t(f)).numpy(),
        np.asarray(rp.inverse_adjoint(jnp.asarray(f))))


def test_streamed_plan_description_round_trip():
    desc = r_get_plan((3, 13, 13), jnp.int32, "pallas",
                      stream_rows=5).describe()
    plan = TP.plan_from_description(desc)
    assert plan.stream_rows == 5 and plan.describe()["stream_rows"] == 5
    want = dict(desc, method="cuda")
    assert plan.describe() == want


def test_streamed_noncapable_backends_scan():
    """stream_rows on gather / horner / strips takes the scan at the same
    strip height and stays exact; cuda streams natively."""
    n, sr = 13, 5
    f = _img(n, seed=3)
    oracle = dprt_oracle_np(f)
    for method in ("gather", "horner", "strips"):
        p = TP.get_plan(f.shape, torch.int32, method, stream_rows=sr)
        assert p._scan_rows == sr, method
        assert not p.backend.takes_stream_rows
        np.testing.assert_array_equal(p.forward(_t(f)).numpy(), oracle)
        np.testing.assert_array_equal(
            p.inverse(_t(oracle.astype(np.int32))).numpy(), f)
    assert TP.get_plan(f.shape, torch.int32, "cuda",
                       stream_rows=sr)._scan_rows is None
    caps = {row["name"]: row for row in TP.backend_capabilities()}
    assert caps["cuda"]["stream"] and not caps["horner"]["stream"]


@pytest.mark.parametrize("method", ["cuda", "horner", "gather", "strips"])
def test_block_rows_stream_rows_conflict_rejected(method):
    with pytest.raises(ValueError, match="mutually exclusive") as port_err:
        TP.get_plan((61, 61), torch.int32, method, block_rows=8,
                    stream_rows=7)
    with pytest.raises(ValueError) as ref_err:
        r_get_plan((61, 61), jnp.int32,
                   "pallas" if method == "cuda" else method,
                   block_rows=8, stream_rows=7)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TT.resolve_blocks(61, 4, block_rows=8, stream_rows=7)
    # the conflict fires before anything else, the mesh check included
    with pytest.raises(ValueError, match="mutually exclusive"):
        TP.get_plan((61, 61), torch.int32, method, block_rows=8,
                    stream_rows=7, mesh=object())
    with pytest.raises(ValueError, match="stream_rows must be >= 1") as e0:
        TP.get_plan((61, 61), torch.int32, method, stream_rows=0)
    with pytest.raises(ValueError) as r0:
        r_resolve_blocks(61, 4, stream_rows=0)
    assert str(e0.value) == str(r0.value)


def test_streamed_ambient_config_carries_through():
    n = 61
    f = _img(n, seed=4)
    with T.config(method="pallas", stream_rows=9):
        op = T.DPRT(f.shape, torch.int32)
    assert op.plan.stream_rows == 9 and op.plan.method == "cuda"
    r = op(_t(f))
    np.testing.assert_array_equal(r.numpy(), dprt_oracle_np(f))
    np.testing.assert_array_equal(op.inverse(r).numpy(), f)


@pytest.mark.parametrize("op_name", ["mul", "conv"])
def test_streamed_plan_pipeline_is_staged_and_exact(op_name):
    """RadonPlan.pipeline on a streamed plan takes the staged route
    (streamed forward, exact 1-D stage, streamed inverse) and equals the
    reference's."""
    n = 13
    f = _img(n, b=2, seed=21)
    rng = np.random.default_rng(22)
    if op_name == "mul":
        w = rng.integers(-9, 10, (n + 1, n)).astype(np.int32)
    else:
        w = rng.integers(-9, 10, (n, n)).astype(np.int32)
    rp = r_get_plan(f.shape, jnp.int32, "pallas", stream_rows=5)
    want = np.asarray(rp.pipeline(jnp.asarray(f), op_name, jnp.asarray(w)))
    tp = TP.get_plan(f.shape, torch.int32, "cuda", stream_rows=5)
    from repro_torch.kernels import pipeline as P
    before = dict(P.OP_LAUNCHES)
    got = tp.pipeline(_t(f), op_name, _t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert dict(P.OP_LAUNCHES) == before


# ---------------------------------------------------------------------------
# routing: which wrapper a plan's datapaths reach
# ---------------------------------------------------------------------------
@pytest.fixture
def calls(monkeypatch):
    """Count the calls of the streamed launcher and of K1's launcher, by
    mode, as the raw functions make them."""
    seen = []

    def wrap(name, fn):
        def counted(g, **kw):
            seen.append((name, kw["mode"], kw.get("stream_rows")))
            return fn(g, **kw)
        return counted

    monkeypatch.setattr(S, "stream_raw", wrap("stream", S.stream_raw))
    monkeypatch.setattr(S, "sfdprt", wrap("sfdprt", S.sfdprt))
    return seen


@pytest.mark.parametrize("sr", [7, 14])
def test_streamed_plan_routes_through_stream_raw(calls, sr):
    """One streamed call per forward / inverse / adjoint whatever the
    strip count, and K1 never; a block_rows plan never streams (on cuda
    it scans K1 launches, one per strip)."""
    n = 61
    f = _t(_img(n, b=2, seed=7))
    p = TP.get_plan(tuple(f.shape), torch.int32, "cuda", stream_rows=sr)
    r = p.forward(f)
    p.inverse(r)
    p.adjoint(r)
    assert calls == [("stream", "forward", sr), ("stream", "inverse", sr),
                     ("stream", "core", sr)]
    del calls[:]
    pb = TP.get_plan(tuple(f.shape), torch.int32, "cuda", block_rows=16)
    np.testing.assert_array_equal(pb.forward(f).numpy(), r.numpy())
    assert [c[0] for c in calls] == ["sfdprt"] * 4   # ceil(61 / 16)


def test_streamed_float_gradient_is_the_adjoint(calls):
    """A float32 gradient on a streamed operator runs the streamed kernel
    in core mode (the adjoint's datapath), never K1, and equals op.T
    within float32 rounding (sums of N terms of size ~1)."""
    n = 13
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.random((2, n, n), dtype=np.float32))
    w = torch.from_numpy(rng.random((2, n + 1, n), dtype=np.float32))
    op = T.DPRT((2, n, n), torch.float32, stream_rows=5)
    xg = x.clone().requires_grad_(True)
    (w * op(xg)).sum().backward()
    assert ("stream", "core", 5) in calls
    assert all(c[0] == "stream" for c in calls)
    torch.testing.assert_close(xg.grad, op.T(w), rtol=1e-5, atol=1e-5 * n)


def test_serve_streamed_route_matches_reference():
    """serve --stream-rows on the CPU: the streamed route's projections
    equal the reference's streamed projections of the same images."""
    from repro.data.synthetic import radon_images as r_radon_images
    from repro_torch.launch import serve
    r = serve.main(["--mode", "radon", "--smoke", "--device", "cpu",
                    "--stream-rows", "7", "--batch", "2", "--iters", "1"])
    imgs = r_radon_images(31, 2, kind="phantom")
    want = R.DPRT(imgs.shape, jnp.int32, "pallas", stream_rows=7)(
        jnp.asarray(imgs))
    np.testing.assert_array_equal(r.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the kernel itself (needs the card)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_stream_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py covers the kernel")
    dev = torch.device("cuda")
    n = 61
    g = _t(_img(n, b=3, seed=n)).to(dev)
    corr = _t(_img(n, b=3, seed=n + 1)[:, :, 0]).to(dev).contiguous()
    for impl in IMPLS:
        for kw in (dict(sign=1, mode="core"), dict(sign=-1, mode="core"),
                   dict(sign=1, mode="forward"),
                   dict(sign=-1, mode="inverse", corr=corr)):
            before = ST.LAUNCHES
            got = ST.stream_raw(g, stream_rows=7, m_block=16,
                                stream_impl=impl, **kw)
            torch.cuda.synchronize()
            assert ST.LAUNCHES == before + 1
            assert torch.equal(got, ST.stream_plain(g, stream_rows=7, **kw))
