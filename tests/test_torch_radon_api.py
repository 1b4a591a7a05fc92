"""The port's operator API (``repro_torch.radon``) against the JAX
reference (``repro.radon``), and the slice as a whole through the serve
entry point.

Same numpy inputs to both packages; integers bit-exact, float64 exact
to rounding.  The reference runs ``method="horner"`` (cheap on the CPU);
the port its default ``cuda`` backend, which on these CPU tensors runs
the kernel's plain version.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import radon as R
from repro_torch import radon as T
from repro_torch.core import dprt_oracle_np
from repro_torch.data.synthetic import radon_images as t_radon_images
from repro.data.synthetic import radon_images as r_radon_images


def _ints(shape, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def test_operator_algebra_matches_reference():
    shape = (2, 13, 13)
    f = _ints(shape, seed=1)
    w = _ints((2, 14, 13), seed=2, lo=-300, hi=300)
    top, rop = T.DPRT(shape, torch.int32), R.DPRT(shape, jnp.int32, "horner")
    assert top.plan.method == "cuda"
    r = top(torch.from_numpy(f))
    np.testing.assert_array_equal(r.numpy(), np.asarray(rop(jnp.asarray(f))))
    np.testing.assert_array_equal(top.inverse(r).numpy(), f)
    np.testing.assert_array_equal(top.T(torch.from_numpy(w)).numpy(),
                                  np.asarray(rop.T(jnp.asarray(w))))
    np.testing.assert_array_equal(
        top.inverse.T(torch.from_numpy(f)).numpy(),
        np.asarray(rop.inverse.T(jnp.asarray(f))))
    rt = top.inverse @ top
    assert isinstance(rt, T.CompositeOperator)
    np.testing.assert_array_equal(rt(torch.from_numpy(f)).numpy(), f)
    assert rt.T.ops == (top.T, top.inverse.T)
    assert (top.T.T, top.inverse.inverse) == (top, top)
    with pytest.raises(ValueError, match="cannot compose"):
        top @ top


def test_non_prime_geometry_round_trip():
    shape = (12, 10)
    f = _ints(shape, seed=3)
    top = T.DPRT(shape, torch.int32)
    r = top(torch.from_numpy(f))
    assert tuple(r.shape) == (14, 13)
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(R.DPRT(shape, jnp.int32, "horner")(
            jnp.asarray(f))))
    np.testing.assert_array_equal(top.inverse(r).numpy(), f)


def test_as_matrix_transpose_identities():
    n = 5
    op = T.DPRT((n, n), torch.float64)
    a = op.as_matrix(device="cpu")
    assert a.shape == ((n + 1) * n, n * n)
    assert torch.equal(op.T.as_matrix(device="cpu"), a.T)
    b = op.inverse.as_matrix(device="cpu")
    torch.testing.assert_close(op.inverse.T.as_matrix(device="cpu"), b.T,
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(b @ a, torch.eye(n * n, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    ai = T.DPRT((n, n), torch.int32).as_matrix(device="cpu").numpy()
    for k in range(n * n):
        e = np.zeros(n * n, np.int32)
        e[k] = 1
        np.testing.assert_array_equal(
            ai[:, k], dprt_oracle_np(e.reshape(n, n)).ravel())


@pytest.mark.parametrize("shape", [(7, 7), (2, 12, 10)], ids=str)
def test_autograd_is_the_exact_adjoint(shape):
    op = T.DPRT(shape, torch.float64)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random(shape)).requires_grad_(True)
    w = torch.from_numpy(rng.random(op.shape_out))
    (w * op(x)).sum().backward()
    torch.testing.assert_close(x.grad, op.T(w), rtol=1e-12, atol=1e-12)
    r = torch.from_numpy(rng.random(op.shape_out)).requires_grad_(True)
    v = torch.from_numpy(rng.random(shape))
    (v * op.inverse(r)).sum().backward()
    torch.testing.assert_close(r.grad, op.inverse.T(v), rtol=1e-12,
                               atol=1e-12)
    # second order: the backward is itself differentiable (in w)
    w2 = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((w2 * op(x)).sum(), x, create_graph=True)
    (g * v).sum().backward()
    torch.testing.assert_close(w2.grad, op(v), rtol=1e-12, atol=1e-12)


def test_config_scopes():
    with T.config(method="horner"):
        assert T.DPRT((7, 7), torch.int32).plan.method == "horner"
        with T.config(method="strips", strip_rows=3):
            op = T.DPRT((7, 7), torch.int32)
            assert (op.plan.method, op.plan.strip_rows) == ("strips", 3)
            assert T.current_config() == {"method": "strips",
                                          "strip_rows": 3}
        assert T.DPRT((7, 7), torch.int32, "gather").plan.method == "gather"
    assert T.current_config() == {}
    assert T.DPRT((7, 7), torch.int32).plan.method == "cuda"
    with pytest.raises(TypeError, match="unknown knob"):
        T.config(nope=1)
    with T.config(stream_rows=8):
        op = T.DPRT((7, 7), torch.int32)
        assert (op.plan.method, op.plan.stream_rows) == ("cuda", 8)


def test_retrace_guard_counts_plan_builds():
    op = T.DPRT((3, 11, 11), torch.int32)
    f = torch.from_numpy(_ints((3, 11, 11), seed=5))
    op.compile(device="cpu")
    assert op.trace_count == 1
    with T.retrace_guard(max_traces=0):
        for _ in range(3):
            op.inverse(op(f))
        assert T.DPRT((3, 11, 11), torch.int32) == op    # cache hit
    with pytest.raises(T.RetraceError):
        with T.retrace_guard(max_traces=0):
            T.DPRT((3, 11, 11), torch.int32, m_block=5)   # a new plan


def test_serve_smoke_slice_matches_reference():
    """The slice as a whole: serve --mode radon --smoke on the CPU (N=31,
    batch 8), exact round trip, projections equal to the reference's."""
    from repro_torch.launch import serve
    r = serve.main(["--mode", "radon", "--smoke", "--device", "cpu",
                    "--iters", "2"])
    imgs = r_radon_images(31, 8, kind="phantom")
    np.testing.assert_array_equal(t_radon_images(31, 8, kind="phantom"),
                                  imgs)
    want = R.DPRT(imgs.shape, jnp.int32, "horner")(jnp.asarray(imgs))
    np.testing.assert_array_equal(r.numpy(), np.asarray(want))


def test_serve_refuses_what_is_not_ported():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="needs 4 ranks"):
        serve.main(["--mesh-shape", "2,2", "--device", "cpu", "--smoke"])
    # --stream-rows is ported: the streamed route runs and is exact
    r = serve.main(["--mode", "radon", "--smoke", "--device", "cpu",
                    "--stream-rows", "8", "--iters", "1"])
    imgs = torch.from_numpy(t_radon_images(31, 8, kind="phantom"))
    assert torch.equal(T.DPRT(imgs.shape, torch.int32)(imgs), r)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--smoke"])
        # --mode service, pool and lm are ported: on the card by default
        for mode in ("service", "pool", "lm"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                serve.main(["--mode", mode, "--smoke"])
