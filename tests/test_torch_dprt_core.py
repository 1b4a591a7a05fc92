"""Parity of the port's transform primitives (``repro_torch.core.dprt``)
with the JAX reference (``repro.core.dprt``).

Inputs are numpy arrays from fixed seeds; the same array goes to both
packages.  Integer results must match bit for bit; float32 within
rtol=1e-5, atol=1e-4*N (inputs in [0, 1); the summation order differs).
int64 inputs are checked against a numpy oracle: without x64 JAX would
truncate them to int32.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro_torch.core.dprt as TD

# repro.core re-exports a function named dprt over its submodule
RD = importlib.import_module("repro.core.dprt")


def _np_skew_sum(g, sign):
    """Independent oracle: out[m, d] = sum_i g(i, <d + sign*m*i>_N)."""
    n = g.shape[-1]
    cols = np.arange(n)
    acc = np.float64 if g.dtype.kind == "f" else np.int64
    out = np.zeros((n, n), acc)
    for m in range(n):
        for i in range(g.shape[0]):
            out[m] += g[i, (cols + sign * m * i) % n].astype(acc)
    return out


def _image(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random((n, n)).astype(dtype)
    lo = 0 if np.dtype(dtype).kind == "u" else -100
    return rng.integers(lo, 200, (n, n)).astype(dtype)


def _assert_match(got, want, n):
    got = np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * n)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# primes and accumulator rules
# ---------------------------------------------------------------------------
def test_primes_match_reference():
    for k in range(0, 300):
        assert TD.is_prime(k) == RD.is_prime(k)
        assert TD.next_prime(k) == RD.next_prime(k)


@pytest.mark.parametrize("dtype,n", [
    ("uint8", 2897), ("uint8", 2903), ("int16", 251), ("int16", 257),
    ("int8", 4099), ("uint16", 127), ("uint16", 251)])
def test_accum_dtype_cliffs_take_the_x64_branch(dtype, n):
    exact = RD.int32_accum_exact(n, jnp.dtype(dtype))
    assert TD.int32_accum_exact(n, dtype) == exact
    want = torch.int32 if exact else torch.int64
    assert TD.accum_dtype_for(getattr(torch, dtype), n) == want


def test_accum_dtype_cliff_positions():
    assert TD.accum_dtype_for(torch.uint8, 2897) == torch.int32
    assert TD.accum_dtype_for(torch.uint8, 2903) == torch.int64
    assert TD.accum_dtype_for(torch.int16, 251) == torch.int32
    assert TD.accum_dtype_for(torch.int16, 257) == torch.int64


@pytest.mark.parametrize("dtype", ["int32", "int64", "float16", "float32",
                                   "float64", "bfloat16"])
def test_accum_and_float_dtypes_for_wide_types(dtype):
    tdt = getattr(torch, dtype)
    want = {"int32": torch.int32, "int64": torch.int64,
            "float64": torch.float64}.get(dtype, torch.float32)
    assert TD.accum_dtype_for(tdt, 4099) == want
    assert TD.accum_dtype_for(tdt) == want
    fwant = torch.float64 if dtype in ("int64", "float64") else torch.float32
    assert TD.float_dtype_for(tdt) == fwant
    if dtype not in ("int64", "bfloat16"):   # no x64 / no numpy bfloat16
        assert TD.dtype_name(TD.accum_dtype_for(tdt, 31)) == \
            jnp.dtype(RD.accum_dtype_for(jnp.dtype(dtype), 31)).name


# ---------------------------------------------------------------------------
# skew-sum strategies
# ---------------------------------------------------------------------------
_STRATEGIES = {
    "gather": (TD._skew_sum_gather, RD._skew_sum_gather),
    "horner": (TD._skew_sum_horner, RD._skew_sum_horner),
    "strips": (lambda g, s: TD._skew_sum_strips(g, s, 3),
               lambda g, s: RD._skew_sum_strips(g, s, 3)),
}


@pytest.mark.parametrize("method", sorted(_STRATEGIES))
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", ["uint8", "int32", "int64", "float32"])
def test_skew_sums_match_oracle(method, sign, dtype):
    n = 7
    g = _image(n, dtype, seed=hash((method, sign, dtype)) % 1000)
    port, _ = _STRATEGIES[method]
    got = port(torch.from_numpy(g), sign)
    assert got.dtype == TD.accum_dtype_for(getattr(torch, dtype), n)
    _assert_match(got.numpy().astype(got.numpy().dtype),
                  _np_skew_sum(g, sign).astype(got.numpy().dtype), n)


@pytest.mark.parametrize("method", sorted(_STRATEGIES))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_skew_sums_match_reference(method, dtype):
    n = 7
    g = _image(n, dtype, seed=11)
    port, ref = _STRATEGIES[method]
    for sign in (1, -1):
        _assert_match(port(torch.from_numpy(g), sign).numpy(),
                      ref(jnp.asarray(g), sign), n)


def test_skew_sums_take_stacks():
    g = np.stack([_image(11, "int32", seed=s) for s in range(3)])
    for method, (port, _) in _STRATEGIES.items():
        got = port(torch.from_numpy(g), -1).numpy()
        for k in range(3):
            np.testing.assert_array_equal(got[k], _np_skew_sum(g[k], -1),
                                          err_msg=method)


def test_strip_partial_and_align_match_reference():
    n, h = 13, 4
    g = _image(n, "int32", seed=5)
    for sign, off in ((1, 4), (-1, 12)):
        strip = g[off:off + h]
        u_t = TD.strip_partial(torch.from_numpy(strip), n, sign)
        u_r = RD.strip_partial(jnp.asarray(strip), n, sign)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_r))
        np.testing.assert_array_equal(
            TD.align_partial(u_t, off, sign).numpy(),
            np.asarray(RD.align_partial(u_r, off, sign)))


def test_numpy_oracles_match_reference():
    for n in (5, 13, 31):
        f = _image(n, "int32", seed=n)
        r = TD.dprt_oracle_np(f)
        np.testing.assert_array_equal(r, RD.dprt_oracle_np(f))
        np.testing.assert_array_equal(TD.idprt_oracle_np(r), f)
        np.testing.assert_array_equal(TD.idprt_oracle_np(r),
                                      RD.idprt_oracle_np(r))
