"""The port's exact convolution (``repro_torch.core.conv``), DPRT-based
DFT (``repro_torch.core.dft``) and tiling helpers
(``repro_torch.core.geometry``) against the JAX reference on the CPU.

The same numpy inputs go through both packages; the reference runs its
``horner`` backend (the same integers as its Pallas kernels, cheaper in
interpret mode), the port its default ``cuda`` backend -- the fused
pipeline K2 and K1, as their plain versions on these CPU tensors -- and
its staged route.  Integer results are bit-exact and also match the
direct oracles; the DFT agrees with the reference and with
``numpy.fft.fft2`` within 1e-5 of the spectrum's peak.  The one N=251
case holds the port's fused route against its own staged route.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import conv as RC
from repro.core import dft as RF
from repro.core import geometry as RG
from repro_torch.core import conv as TC
from repro_torch.core import dft as TF
from repro_torch.core import geometry as TG


def _ints(shape, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


# ---------------------------------------------------------------------------
# the exact 1-D circular convolution
# ---------------------------------------------------------------------------
CONV1D_SHAPES = [
    ("batched", (4, 11), (4, 11)),
    ("mixed-rank", (2, 3, 4, 11), (3, 4, 11)),
    ("shared-row", (5, 7), (7,)),
    ("size-1-batch", (1, 6, 13), (6, 13)),
]


@pytest.mark.parametrize("label,ashape,bshape", CONV1D_SHAPES,
                         ids=[c[0] for c in CONV1D_SHAPES])
def test_circ_conv1d_exact_matches_reference(label, ashape, bshape):
    a = _ints(ashape, 1, -50, 50)
    b = _ints(bshape, 2, -10, 10)
    want = np.asarray(RC.circ_conv1d_exact(_j(a), _j(b)))
    got = TC.circ_conv1d_exact(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_circ_conv1d_exact_wraps_int32_like_reference():
    a = _ints((3, 13), 3, -2 ** 30, 2 ** 30)
    b = _ints((3, 13), 4, -2 ** 30, 2 ** 30)
    np.testing.assert_array_equal(
        TC.circ_conv1d_exact(_t(a), _t(b)).numpy(),
        np.asarray(RC.circ_conv1d_exact(_j(a), _j(b))))


def test_circ_conv1d_exact_chunks_rows():
    """More rows than one chunk holds: the chunked loop is exact."""
    a = _ints((3, 40, 61), 5, -9, 10)
    b = _ints((40, 61), 6, -9, 10)
    old = TC._CONV_CHUNK
    TC._CONV_CHUNK = 61 * 61 * 7          # 7 rows per chunk
    try:
        got = TC.circ_conv1d_exact(_t(a), _t(b))
    finally:
        TC._CONV_CHUNK = old
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RC.circ_conv1d_exact(_j(a), _j(b))))


# ---------------------------------------------------------------------------
# circular 2-D convolution
# ---------------------------------------------------------------------------
CIRC_CASES = [
    ("prime-fused", (13, 13), (13, 13), dict()),
    ("prime-staged", (13, 13), (13, 13), dict(fuse=False)),
    ("prime-fuse-true-horner", (7, 7), (7, 7),
     dict(fuse=True, method="horner")),
    ("stack-shared-kernel", (3, 11, 11), (11, 11), dict()),
    ("kernel-stack-commutes", (11, 11), (2, 11, 11), dict()),
    ("stack-pairs", (2, 7, 7), (2, 7, 7), dict(fuse=False)),
    ("torus-6x8", (6, 8), (6, 8), dict()),
    ("torus-blocked", (9, 10), (9, 10), dict(block_size=4)),
]


@pytest.mark.parametrize("label,fshape,gshape,kw", CIRC_CASES,
                         ids=[c[0] for c in CIRC_CASES])
def test_circ_conv2d_matches_reference_and_direct(label, fshape, gshape,
                                                  kw):
    f = _ints(fshape, 7, 0, 100)
    g = _ints(gshape, 8, -8, 9)
    got = TC.circ_conv2d_dprt(_t(f), _t(g), **kw)
    want = np.asarray(RC.circ_conv2d_dprt(_j(f), _j(g), method="horner",
                                          block_size=kw.get("block_size")))
    np.testing.assert_array_equal(got.numpy(), want)
    if len(fshape) == 2 and len(gshape) == 2 and fshape[0] == fshape[1]:
        np.testing.assert_array_equal(
            got.numpy(), TC.circ_conv2d_direct(_t(f), _t(g)).numpy())


def test_circ_conv2d_direct_matches_reference_oracle():
    f, g = _ints((11, 11), 9, -50, 50), _ints((11, 11), 10, -9, 10)
    np.testing.assert_array_equal(
        TC.circ_conv2d_direct(_t(f), _t(g)).numpy(),
        np.asarray(RC.circ_conv2d_direct(_j(f), _j(g))))


def test_circ_conv2d_rejects_mismatched_geometry():
    with pytest.raises(ValueError):
        TC.circ_conv2d_dprt(torch.zeros(5, 5, dtype=torch.int32),
                            torch.zeros(7, 7, dtype=torch.int32))


def test_circ_conv2d_fft_agrees_after_rounding():
    f, g = _ints((11, 11), 11), _ints((11, 11), 12, 0, 16)
    exact = TC.circ_conv2d_dprt(_t(f), _t(g)).numpy()
    fft = TC.circ_conv2d_fft(_t(f), _t(g)).numpy()
    np.testing.assert_allclose(fft, exact, rtol=0, atol=0.5)
    np.testing.assert_allclose(
        fft, np.asarray(RC.circ_conv2d_fft(_j(f), _j(g))), rtol=0, atol=0.5)


def test_circ_conv2d_float_within_tolerance():
    rng = np.random.default_rng(13)
    f, g = rng.random((13, 13)), rng.random((13, 13))
    got = TC.circ_conv2d_dprt(_t(f).float(), _t(g).float()).numpy()
    want = np.asarray(RC.circ_conv2d_dprt(_j(f.astype(np.float32)),
                                          _j(g.astype(np.float32)),
                                          method="horner"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# linear 2-D convolution
# ---------------------------------------------------------------------------
LINEAR_CASES = [
    ("square", (9, 9), (4, 4), dict()),
    ("rectangular", (5, 9), (3, 2), dict()),
    ("rectangular-staged", (8, 3), (2, 4), dict(fuse=False)),
    ("blocked", (13, 17), (3, 4), dict(block_size=5)),
    ("blocked-staged", (10, 8), (3, 3), dict(block_size=4, fuse=False)),
]


@pytest.mark.parametrize("label,fshape,gshape,kw", LINEAR_CASES,
                         ids=[c[0] for c in LINEAR_CASES])
def test_linear_conv2d_matches_reference_and_direct(label, fshape, gshape,
                                                    kw):
    f, g = _ints(fshape, 14), _ints(gshape, 15, 0, 16)
    got = TC.linear_conv2d_dprt(_t(f), _t(g), **kw).numpy()
    np.testing.assert_array_equal(got, TC.linear_conv2d_direct(f, g))
    np.testing.assert_array_equal(
        got, np.asarray(RC.linear_conv2d_dprt(
            _j(f), _j(g), method="horner",
            block_size=kw.get("block_size"))))


def test_linear_conv2d_blocked_batched_stack():
    fb, g = _ints((3, 10, 8), 16), _ints((3, 3), 17, 0, 16)
    got = TC.linear_conv2d_dprt(_t(fb), _t(g), block_size=4).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i],
                                      RC.linear_conv2d_direct(fb[i], g))


def test_prime_padding_matches_reference():
    for size, k in [(251, 16), (100, 32), (1000, 5)]:
        assert (TC.prime_vs_pow2_padding(size, k)
                == RC.prime_vs_pow2_padding(size, k))


# ---------------------------------------------------------------------------
# tiling helpers
# ---------------------------------------------------------------------------
def test_tiling_helpers_match_reference():
    f = _ints((2, 10, 7), 18)
    tiles, offs = TG.image_to_tiles(_t(f), 4)
    rtiles, roffs = RG.image_to_tiles(_j(f), 4)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(rtiles))
    np.testing.assert_array_equal(offs, roffs)
    canvas = TG.overlap_add(tiles[0], offs, (14, 10))
    np.testing.assert_array_equal(
        canvas.numpy(), np.asarray(RG.overlap_add(rtiles[0], roffs, (14, 10))))
    lin = _ints((2, 17, 15), 19, -50, 50)
    np.testing.assert_array_equal(
        TG.fold_mod(_t(lin), 6, 8).numpy(),
        np.asarray(RG.fold_mod(_j(lin), 6, 8)))
    with pytest.raises(ValueError):
        TG.image_to_tiles(_t(f), 0)


# ---------------------------------------------------------------------------
# the DPRT-based DFT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [7, 13, 31])
def test_dft2_via_dprt_matches_reference_and_numpy(n):
    f = _ints((n, n), n)
    got = TF.dft2_via_dprt(_t(f)).numpy()
    scale = np.abs(np.fft.fft2(f)).max()
    assert np.abs(got - np.fft.fft2(f)).max() / scale < 1e-5
    assert np.abs(got - np.asarray(RF.dft2_via_dprt(
        _j(f), method="horner"))).max() / scale < 1e-5


def test_dft2_batched_matches_reference_and_numpy():
    fb = _ints((4, 13, 13), 20)
    got = TF.dft2_via_dprt_batched(_t(fb)).numpy()
    want = np.asarray(RF.dft2_via_dprt_batched(_j(fb), method="horner"))
    for i in range(4):
        ref = np.fft.fft2(fb[i])
        scale = np.abs(ref).max()
        assert np.abs(got[i] - ref).max() / scale < 1e-5
        assert np.abs(got[i] - want[i]).max() / scale < 1e-5
    np.testing.assert_allclose(TF.dft2_reference(_t(fb[0])).numpy(),
                               np.asarray(RF.dft2_reference(_j(fb[0]))),
                               rtol=1e-5, atol=1e-2)


def test_dft2_knobs_and_errors():
    f = _ints((13, 13), 21)
    base = TF.dft2_via_dprt(_t(f)).numpy()
    for kw in [dict(method="strips", strip_rows=4),
               dict(method="pallas", strip_rows=5, m_block=3)]:
        np.testing.assert_array_equal(TF.dft2_via_dprt(_t(f), **kw).numpy(),
                                      base)
    with pytest.raises(ValueError):
        TF.dft2_via_dprt(torch.zeros(6, 6, dtype=torch.int32))
    with pytest.raises(ValueError):
        TF.dft2_via_dprt_batched(torch.zeros(6, 6, dtype=torch.int32))


def test_circ_conv2d_n251_fused_equals_staged():
    """The one N=251 case: the port's fused route against its own staged
    route, a 3 x 3 kernel on one image."""
    n = 251
    f = _t(_ints((n, n), 22))
    g = torch.zeros((n, n), dtype=torch.int32)
    g[:3, :3] = torch.from_numpy(_ints((3, 3), 23, -4, 5))
    assert torch.equal(TC.circ_conv2d_dprt(f, g),
                       TC.circ_conv2d_dprt(f, g, fuse=False))
