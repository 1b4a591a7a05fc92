"""K1, the port's fused SFDPRT kernel (``repro_torch.kernels``), against
the reference Pallas kernel run in interpret mode on the CPU.

On a CPU tensor the port's wrapper runs the kernel's plain PyTorch
version; that is what these tests hold against
``repro.kernels.sfdprt.{skew_sum,dprt,idprt}_pallas_raw`` with the same
explicit ``strip_rows``/``m_block``, in all three modes.  Integer
results are bit-exact, including the inverse's floor division on
non-transform inputs with negatives.  The CUDA kernel itself runs only
on a card: the one ``cuda``-marked test below skips here, and
``chip_smoke.py`` covers the kernel on the card.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import tuning as RT
from repro.kernels.sfdprt import (dprt_pallas_raw, idprt_pallas_raw,
                                  skew_sum_pallas_raw)
from repro_torch.core import get_plan
from repro_torch.kernels import ops, sfdprt as S, tuning as TT

# (N, strip_rows, m_block): strip and direction blocks that do not
# divide N, and blocks larger than N
AWKWARD = [(5, 3, 8), (7, 5, 3), (13, 13, 16)]


def _ints(shape, seed, lo=-300, hi=300):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _port(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,h,mb", AWKWARD)
@pytest.mark.parametrize("mode", ["core+", "core-", "forward", "inverse"])
def test_plain_k1_matches_pallas_interpret(n, h, mb, mode):
    if mode == "inverse":     # not a transform: Z + corr is rarely % N == 0
        x = _ints((3, n + 1, n), seed=n * 10 + mb)
        want = idprt_pallas_raw(jnp.asarray(x), strip_rows=h, m_block=mb)
        got = S.idprt_raw(_port(x), strip_rows=h, m_block=mb)
    elif mode == "forward":
        x = _ints((3, n, n), seed=n * 20 + mb)
        want = dprt_pallas_raw(jnp.asarray(x), strip_rows=h, m_block=mb)
        got = S.dprt_raw(_port(x), strip_rows=h, m_block=mb)
    else:
        sign = 1 if mode == "core+" else -1
        x = _ints((3, n, n), seed=n * 30 + mb + sign)
        want = skew_sum_pallas_raw(jnp.asarray(x), sign=sign, strip_rows=h,
                                   m_block=mb)
        got = S.skew_sum_raw(_port(x), sign=sign, strip_rows=h, m_block=mb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inverse_floor_division_on_negative_numerators():
    """C rounds toward zero, JAX toward -inf: pin the reference's floor."""
    n = 7
    x = _ints((1, n + 1, n), seed=3, lo=-1000, hi=10)
    want = np.asarray(idprt_pallas_raw(jnp.asarray(x), strip_rows=7,
                                       m_block=8))
    got = S.idprt_raw(_port(x), strip_rows=7, m_block=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any()
    # and the numerators were not all divisible by N
    z = S.skew_sum_raw(_port(x[:, :n]), sign=-1, strip_rows=7,
                       m_block=8).numpy()
    num = z - x[:, 0].sum(-1)[:, None, None] + x[:, n][:, :, None]
    assert (num % n != 0).any() and (num < 0).any()


def test_batch_one_stack_and_single_image():
    n = 7
    f = _ints((1, n, n), seed=9, lo=0, hi=256)
    want = np.asarray(dprt_pallas_raw(jnp.asarray(f), strip_rows=5,
                                      m_block=3))
    np.testing.assert_array_equal(
        S.dprt_raw(_port(f), strip_rows=5, m_block=3).numpy(), want)
    np.testing.assert_array_equal(ops.dprt_cuda(_port(f[0])).numpy(),
                                  want[0])
    np.testing.assert_array_equal(
        ops.idprt_cuda(_port(want[0])).numpy(), f[0])


@pytest.mark.parametrize("sign", [1, -1])
def test_row_offset_partials(sign):
    """A row strip at a nonzero global row (the mesh path's shard-local
    partial), in core and forward mode."""
    n, rows, off = 13, 5, 4
    g = _ints((2, rows, n), seed=17 + sign)
    if sign > 0:
        want = dprt_pallas_raw(jnp.asarray(g), strip_rows=3, m_block=8,
                               row_offset=off)
        got = ops.dprt_cuda_strip(_port(g), row_offset=off, strip_rows=3,
                                  m_block=8)
    else:
        want = skew_sum_pallas_raw(jnp.asarray(g), sign=-1, strip_rows=3,
                                   m_block=8, row_offset=off)
        got = ops.skew_sum_cuda_strip(_port(g), -1, row_offset=off,
                                      strip_rows=3, m_block=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_partials_of_all_strips_sum_to_the_skew_sum():
    n = 11
    g = _ints((n, n), seed=4)
    full = ops.skew_sum_cuda(_port(g), -1).numpy()
    parts = sum(ops.skew_sum_cuda_strip(_port(g[r:r + 4]), -1,
                                        row_offset=r).numpy()
                for r in range(0, n, 4))
    np.testing.assert_array_equal(parts, full)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32,
                                   torch.float64])
def test_plain_k1_accumulator_dtypes(dtype):
    n = 13
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.random((2, n, n)) * 100).to(dtype)
    r = ops.dprt_cuda(f)
    assert r.dtype == dtype
    back = ops.idprt_cuda(r)
    if dtype.is_floating_point:
        torch.testing.assert_close(back, f, rtol=1e-5, atol=1e-4 * n * 100)
    else:
        assert torch.equal(back, f)


def test_k1_int32_overflow_wraps_like_the_reference():
    """Sums past 2**31 wrap in K1's plain version exactly as the
    reference's int32 kernel wraps them (the kernel adds in the unsigned
    type of the same width for this), and the inverse of the wrapped
    projections matches the reference's inverse."""
    n = 13
    big = 2 ** 28
    f = np.random.default_rng(10).integers(-big, big, (3, n, n)).astype(
        np.int32)
    f[0] = np.abs(f[0])                    # image 0's sums all pass 2**31
    want = np.asarray(dprt_pallas_raw(jnp.asarray(f), strip_rows=5,
                                      m_block=8))
    from repro.core import dprt_oracle_np
    assert dprt_oracle_np(f[0].astype(np.int64)).max() >= 2 ** 31
    got = S.dprt_raw(_port(f), strip_rows=5, m_block=8)
    np.testing.assert_array_equal(got.numpy(), want)
    want_i = idprt_pallas_raw(jnp.asarray(want), strip_rows=5, m_block=8)
    got_i = S.idprt_raw(_port(want), strip_rows=5, m_block=8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_wrapper_checks():
    with pytest.raises(ValueError, match="prime"):
        ops.dprt_cuda(torch.zeros(9, 9, dtype=torch.int32))
    with pytest.raises(ValueError, match="N\\+1"):
        ops.idprt_cuda(torch.zeros(7, 7, dtype=torch.int32))
    # stream_rows is ported (the streamed kernel's plain version on CPU)
    f7 = torch.from_numpy(_ints((7, 7), seed=7))
    from repro.core import dprt_oracle_np
    np.testing.assert_array_equal(
        ops.dprt_cuda(f7, stream_rows=4).numpy(), dprt_oracle_np(f7.numpy()))
    g = torch.zeros(1, 7, 7, dtype=torch.int32)
    with pytest.raises(TypeError, match="accumulator dtype"):
        S.sfdprt(g.to(torch.int16), sign=1, mode="core", strip_rows=7,
                 m_block=8)
    with pytest.raises(ValueError, match="fixes sign"):
        S.sfdprt(g, sign=-1, mode="forward", strip_rows=7, m_block=8)
    with pytest.raises(ValueError, match="corr"):
        S.sfdprt(g, sign=-1, mode="inverse", strip_rows=7, m_block=8)
    with pytest.raises(ValueError, match="contiguous"):
        S.sfdprt(g.transpose(1, 2), sign=1, mode="core", strip_rows=7,
                 m_block=8)


# ---------------------------------------------------------------------------
# block resolution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 5, 13, 31, 61, 251, 509, 4099, 37, 97,
                               257, 1031, 8191])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_resolve_blocks_matches_reference(n, itemsize):
    with warnings.catch_warnings():   # off-table N warns once, in both
        warnings.simplefilter("ignore")
        assert TT.resolve_blocks(n, itemsize) == \
            RT.resolve_blocks(n, itemsize)
    assert TT.resolve_blocks(n, itemsize, 3, 5) == (3, 5)
    assert TT.wasted_direction_rows(n, 8) == RT.wasted_direction_rows(n, 8)
    assert TT.wasted_direction_rows(n, 8, forward=False) == \
        RT.wasted_direction_rows(n, 8, forward=False)


def test_resolve_blocks_rejects_like_reference():
    for fn in (TT.resolve_blocks, RT.resolve_blocks):
        with pytest.raises(ValueError, match="mutually exclusive"):
            fn(13, 4, block_rows=4, stream_rows=4)
        with pytest.raises(ValueError, match=">= 1"):
            fn(13, 4, strip_rows=0)
        with pytest.raises(ValueError, match=">= 1"):
            fn(13, 4, m_block=0)
        with pytest.raises(ValueError, match=">= 1"):
            fn(13, 4, stream_rows=0)
    assert TT.PALLAS_TUNE == RT.PALLAS_TUNE


def test_smem_tile_rows_caps_the_staged_strip():
    """K1's stage of padded rows: a whole 251 x 251 int32 image does not
    fit a block's share of the SM's shared memory, so it streams through
    a ring of stages; ``strip_rows`` and the operand's rows cap a stage."""
    t = TT.skew_tile(251, 251, 4, 251, 32, 252, batch=256)
    assert (t.stage_rows, t.slots) == (17, 2)
    assert t.smem == 192 + t.slots * t.stage_rows * t.row_bytes
    assert t.smem <= TT.SKEW_SMEM_BUDGET
    assert TT.skew_tile(251, 251, 4, 8, 32, 252).stage_rows == 8
    assert TT.skew_tile(5, 3, 4, 16, 8, 6).stage_rows == 3


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to ``csrc/skew_tile.cuh``, which K1 and K2 include, gives
    both libraries a new build path (a stale ``.so`` is never reused);
    a library that does not include it is rebuilt too, as every header
    joins every key."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    for src in ("sfdprt.cu", "pipeline.cu"):
        assert '#include "skew_tile.cuh"' in (csrc / src).read_text()
    before = {name: _build._lib_path(name) for name in _build.LIBRARIES}
    assert before == {name: _build._lib_path(name)
                      for name in _build.LIBRARIES}
    header = csrc / "skew_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._lib_path(name) for name in _build.LIBRARIES}
    for name in _build.LIBRARIES:
        assert after[name] != before[name], name
        assert after[name].parent == before[name].parent


@pytest.mark.parametrize("n,dtype,route", [
    (14327, torch.int32, "k1"), (14341, torch.int32, "dma"),
    (28619, torch.int32, "grid"), (7159, torch.int64, "k1"),
    (7177, torch.int64, "dma"), (14293, torch.int64, "grid")])
def test_raw_functions_stream_n_too_wide_for_k1(monkeypatch, n, dtype,
                                                route):
    """Where K1 cannot hold one direction of N in a block (N > 14336 for
    int32 sums, 7168 for int64), the raw functions stream the operand
    through K5 in stages of at most ``strip_rows`` rows, and through K4
    where K5's ring cannot hold two padded rows: every mode, as K1 ran
    up to 28928 / 14464 before its register tile."""
    calls = []

    def k1(g, **kw):
        calls.append(("k1", kw))
        return "k1"

    def streamed(g, **kw):
        calls.append((kw["stream_impl"], kw))
        return "streamed"

    monkeypatch.setattr(S, "sfdprt", k1)
    monkeypatch.setattr(S, "stream_raw", streamed)
    g = torch.zeros((1, 2, n), dtype=dtype)
    S.dprt_raw(g, strip_rows=5, row_offset=3)
    S.skew_sum_raw(g, -1, strip_rows=5, row_offset=n - 1)
    S._skew(g, sign=-1, mode="inverse", strip_rows=5, m_block=8,
            corr=torch.zeros((1, n), dtype=dtype))
    assert [c[0] for c in calls] == [route] * 3
    assert [c[1]["mode"] for c in calls] == ["forward", "core", "inverse"]
    if route != "k1":
        assert all(c[1]["stream_rows"] == 5 for c in calls)
    assert TT.skew_holds(n, dtype.itemsize) == (route == "k1")


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------
def test_cuda_backend_on_cpu_tensor_uses_plain_version():
    S.reset_launch_counts()
    n = 13
    f = _port(_ints((3, n, n), seed=1, lo=0, hi=256))
    plan = get_plan(tuple(f.shape), torch.int32)
    assert plan.method == "cuda"
    back = plan.inverse(plan.forward(f))
    assert torch.equal(back, f)
    plan.adjoint(plan.forward(f))
    assert S.LAUNCHES == 0
    assert S.MODE_LAUNCHES == {"core": 0, "forward": 0, "inverse": 0}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py covers the kernel")
    dev = torch.device("cuda")
    for n, h, mb in AWKWARD + [(251, 251, 32)]:
        g = _port(_ints((3, n, n), seed=n)).to(dev)
        corr = _port(_ints((3, n), seed=n + 1)).to(dev)
        for kw in (dict(sign=1, mode="core"), dict(sign=-1, mode="core"),
                   dict(sign=1, mode="forward"),
                   dict(sign=-1, mode="inverse", corr=corr)):
            before = S.LAUNCHES
            got = S.sfdprt(g, strip_rows=h, m_block=mb, **kw)
            torch.cuda.synchronize()
            assert S.LAUNCHES == before + 1
            assert torch.equal(got, S.sfdprt_plain(g, **kw))


def test_paper_n251_table_blocks_vs_oracle():
    """The main path's size with the table's blocks (H=251, M=32)."""
    from repro.core import dprt_oracle_np
    n = 251
    f = _ints((1, n, n), seed=251)
    r = ops.dprt_cuda(_port(f))
    np.testing.assert_array_equal(r[0].numpy(), dprt_oracle_np(f[0]))
    assert torch.equal(ops.idprt_cuda(r), _port(f))
