"""The port's reconstruction subsystem (``repro_torch.radon.solve`` and
``masking``) against the JAX reference (``repro.radon``) on the CPU.

Mirrors ``tests/test_solve.py`` case by case at N in {5, 7, 13}: the
masked adjoint, the fused normal-equation identity against the dense
``(DA)^T (DA)``, CG / LSQR / Landweber against the dense least-squares
oracle and against the reference's image at ``test_solve.py``'s
tolerances, both preconditioners, the Sherman-Morrison closed form,
validation, gradients (``torch.autograd.grad`` against finite
differences, the dense oracle and ``jax.grad``; ``torch.func.jvp``
against ``jax.jvp``), zero builds on a warm solve, batched and per-image
3-D masks, the ``solve_operator`` surface and the N = 257 int16 solve.

The same numpy inputs go to both packages.  The reference runs
``method="gather"`` / ``"horner"`` (and ``"pallas"`` in interpret mode
only at N = 5); the port runs ``method="cuda"`` on CPU tensors, i.e. the
plain versions of its kernels.  Two differences are by design: the port
places arrays explicitly (``direction_mask(..., device=)``,
``MaskedDPRT(..., device=)``, ``as_matrix(device=)``, and a mask on
another device than the sinogram raises), and ``float_dtype_for`` maps
int64 to float64 because torch always has int64 (the reference does so
only under x64).
"""
import importlib
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import radon as RR
from repro_torch import radon as TR
from repro_torch.core.dprt import float_dtype_for

# repro_torch.radon re-exports a function named solve over its submodule
TS = importlib.import_module("repro_torch.radon.solve")

PRIMES = [5, 7, 13]
# (N, reference backend): gather and horner everywhere, pallas at N = 5
CASES = [(n, m) for n in PRIMES for m in ("gather", "horner")] + [
    (5, "pallas")]
CPU = "cpu"


def rand_img(n, seed=0, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    return np.random.default_rng(seed).integers(0, 9, shape)


def _shape(n, batch):
    return (n, n) if batch is None else (batch, n, n)


def ref_masked(n, missing, method="gather", batch=None):
    op = RR.DPRT(_shape(n, batch), jnp.int32, method=method)
    return RR.MaskedDPRT(op, mask=RR.direction_mask(n, missing))


def port_masked(n, missing, batch=None):
    op = TR.DPRT(_shape(n, batch), torch.int32, method="cuda")
    return TR.MaskedDPRT(op, mask=TR.direction_mask(n, missing,
                                                    device=CPU))


def ls_oracle(A, b):
    """Min-norm dense least-squares solution (what CG/LSQR from x0=0
    converge to on a singular masked system)."""
    x, *_ = np.linalg.lstsq(np.asarray(A, np.float64),
                            np.asarray(b, np.float64).ravel(), rcond=None)
    return x


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, tol):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# MaskedDPRT: exact adjoint + the fused normal-equation identity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,method", CASES)
def test_masked_adjoint_matrix_exact(n, method):
    m = port_masked(n, [1, n - 1])
    a = m.as_matrix().numpy()
    # 0/1 mask on integer-valued float arithmetic: exact equality
    assert np.array_equal(m.T.as_matrix().numpy(), a.T)
    assert np.array_equal(a, np.asarray(ref_masked(n, [1, n - 1],
                                                   method).as_matrix()))
    assert m.T.T.shape_out == m.shape_out and m.T.T == m  # involution
    assert m.T.shape_in == (n + 1, n) and m.T.shape_out == (n, n)


def test_masked_weighting_and_validation():
    n = 7
    op = TR.DPRT((n, n), torch.int32)
    w = np.random.default_rng(3).uniform(0.5, 2.0, (n + 1, n))
    m = TR.MaskedDPRT(op, mask=TR.direction_mask(n, [0], device=CPU),
                      weight=_t(w))
    x = _t(rand_img(n))
    want = TR.MaskedDPRT(op, device=CPU)(x).numpy() * w
    want[0] = 0
    np.testing.assert_allclose(m(x).numpy(), want, rtol=1e-6)
    ref = RR.MaskedDPRT(RR.DPRT((n, n), jnp.int32, method="gather"),
                        mask=RR.direction_mask(n, [0]),
                        weight=jnp.asarray(w, jnp.float32))
    np.testing.assert_allclose(m(x).numpy(),
                               np.asarray(ref(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-5)
    assert m.dtype_in == m.dtype_out == torch.float32
    assert not m.is_identity_diagonal
    with pytest.raises(ValueError, match="broadcast"):
        TR.MaskedDPRT(op, mask=torch.ones((3, 3)))
    with pytest.raises(ValueError, match="forward RadonOperator"):
        TR.MaskedDPRT(op.inverse)
    with pytest.raises(ValueError, match="does not match plan batch"):
        TR.MaskedDPRT(TR.DPRT((2, n, n), torch.int32),
                      mask=torch.ones((3, n + 1, n)))
    # a part on another device raises instead of being copied
    with pytest.raises(ValueError, match="device"):
        TR.MaskedDPRT(op, mask=torch.ones((n + 1, n), device="meta"),
                      weight=torch.ones((n + 1, n)))
    with pytest.raises(ValueError, match="device"):
        TR.solve(m, torch.zeros((n + 1, n), device="meta"))
    with pytest.raises(AttributeError):
        m.d = None
    assert TR.direction_mask(n, [0], device=CPU).device.type == "cpu"
    np.testing.assert_array_equal(
        TR.direction_mask(n, np.array([2, 7]), device=CPU).numpy(),
        np.asarray(RR.direction_mask(n, [2, 7])))


@pytest.mark.parametrize("n", PRIMES)
def test_normal_apply_matches_dense(n):
    m = port_masked(n, [2])
    a = m.as_matrix().numpy().astype(np.float64)
    x = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    fused = m.normal_apply(_t(x)).numpy()
    np.testing.assert_allclose(fused, (a.T @ a @ x.ravel()).reshape(n, n),
                               rtol=1e-4, atol=1e-4)
    rm = ref_masked(n, [2])
    np.testing.assert_allclose(fused, np.asarray(rm.normal_apply(
        jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    b = m(_t(x))
    rhs = m.normal_rhs(b).numpy()
    np.testing.assert_allclose(
        rhs, (a.T @ b.numpy().ravel()).reshape(n, n), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rhs, np.asarray(rm.normal_rhs(
        jnp.asarray(b.numpy()))), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(m._srow().numpy(),
                                  np.asarray(rm._srow()))


# ---------------------------------------------------------------------------
# solvers vs the dense oracle and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,method", CASES)
def test_masked_cg_matches_dense_ls(n, method):
    m = port_masked(n, [2, n - 1])
    x = rand_img(n, seed=n)
    b = m(_t(x))
    want = ls_oracle(m.as_matrix().numpy(), b.numpy())
    res = TR.solve(m, b, "cg", tol=1e-7, maxiter=300)
    _close(res.image.numpy(), want, 1e-5)
    hist = res.residual_norms.numpy()
    assert hist.shape == (301,) and hist[0] == 1.0
    k = int(res.iterations)
    assert res.iterations.dtype == torch.int32 and 0 < k <= 300
    assert np.isfinite(hist[:k + 1]).all() and np.isnan(hist[k + 1:]).all()
    assert res.converged.dtype == torch.bool and bool(res.converged)
    rm = ref_masked(n, [2, n - 1], method)
    ref = RR.solve(rm, jnp.asarray(b.numpy()), "cg", tol=1e-7, maxiter=300)
    _close(res.image.numpy(), np.asarray(ref.image), 1e-5)


@pytest.mark.parametrize("solver", ["lsqr", "landweber"])
def test_other_solvers_match_dense_ls(solver):
    n = 7
    m = port_masked(n, [3])
    b = m(_t(rand_img(n, seed=2)))
    want = ls_oracle(m.as_matrix().numpy(), b.numpy())
    kw = (dict(tol=1e-10, maxiter=200) if solver == "lsqr"
          else dict(tol=1e-7, maxiter=4000))
    got = TR.solve(m, b, solver, **kw).image.numpy()
    tol = 1e-5 if solver == "lsqr" else 1e-3
    _close(got, want, tol)
    ref = RR.solve(ref_masked(n, [3]), jnp.asarray(b.numpy()), solver, **kw)
    _close(got, np.asarray(ref.image), tol)


@pytest.mark.parametrize("precond", ["sherman", "filter", "weights"])
def test_preconditioned_cg(precond):
    n = 13
    m = port_masked(n, [5])
    b = m(_t(rand_img(n, seed=4)))
    want = ls_oracle(m.as_matrix().numpy(), b.numpy())
    w = np.full((n + 1, n), 1.0 / (n + 1), np.float32)
    pc, rpc = {"sherman": ("sherman", "sherman"),
               "filter": (TR.ProjectionFilter(_t(w)),
                          RR.ProjectionFilter(jnp.asarray(w))),
               "weights": (w, w)}[precond]
    res = TR.solve(m, b, "cg", precond=pc, tol=1e-7, maxiter=300)
    _close(res.image.numpy(), want, 1e-4)
    ref = RR.solve(ref_masked(n, [5]), jnp.asarray(b.numpy()), "cg",
                   precond=rpc, tol=1e-7, maxiter=300)
    _close(res.image.numpy(), np.asarray(ref.image), 1e-4)


@pytest.mark.parametrize("n", PRIMES)
def test_sherman_fast_path_noniterative_matches_inverse(n):
    op = TR.DPRT((n, n), torch.int32)
    x = torch.from_numpy(rand_img(n, seed=n)).to(torch.int32)
    res = TR.solve(op, op(x))
    assert int(res.iterations) == 0          # closed form, no loop
    assert bool(res.converged)
    assert res.residual_norms.shape == (2,)
    np.testing.assert_allclose(res.image.numpy(), op.inverse(op(x)).numpy(),
                               rtol=1e-5, atol=1e-4)
    m = TR.MaskedDPRT(op, device=CPU)
    assert m.is_identity_diagonal
    _close(res.image.numpy(), ls_oracle(m.as_matrix().numpy(),
                                        m(x).numpy()), 1e-4)
    rop = RR.DPRT((n, n), jnp.int32, method="gather")
    ref = RR.solve(rop, rop(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(res.image.numpy(), np.asarray(ref.image),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(res.residual_norms.numpy(),
                               np.asarray(ref.residual_norms), atol=1e-5)


def test_method_resolution_and_validation():
    n = 7
    op = TR.DPRT((n, n), torch.int32)
    m = port_masked(n, [1])
    b = torch.zeros((n + 1, n))
    with pytest.raises(ValueError, match="Sherman-Morrison"):
        TR.solve(m, b, "sherman")              # masked: no closed form
    with pytest.raises(ValueError, match="unknown method"):
        TR.solve(op, b, "nope")
    with pytest.raises(ValueError, match="precond applies"):
        TR.solve(m, b, "lsqr", precond="sherman")
    with pytest.raises(ValueError, match="not both"):
        TR.solve(m, b, mask=TR.direction_mask(n, [0], device=CPU))
    with pytest.raises(ValueError, match="sinogram shape"):
        TR.solve(op, torch.zeros((n, n)))      # bad shape
    with pytest.raises(ValueError, match="adjoint"):
        TR.solve(m.T, b)
    with pytest.raises(ValueError, match="unknown precond"):
        TR.solve(m, b, "cg", precond="jacobi")
    with pytest.raises(ValueError, match=r"\(…, P\+1, P\)"):
        TR.solve(m, b, "cg", precond=torch.ones((n, n)))
    with pytest.raises(ValueError, match="maxiter"):
        TR.solve(m, b, "cg", maxiter=0)
    # auto: unmasked -> sherman, masked -> cg
    assert int(TR.solve(op, b).iterations) == 0
    res = TR.solve(m, b)                       # zero rhs converges at 0
    assert bool(res.converged) and int(res.iterations) == 0
    assert TR.METHODS == RR.METHODS


# ---------------------------------------------------------------------------
# differentiation: implicit-function-theorem gradients
# ---------------------------------------------------------------------------
def _dense_grad(a, d, b):
    """x(b) = pinv(DA) D b is linear, so grad ||x||^2 = 2 P^T P b."""
    p = np.linalg.pinv(a.astype(np.float64)) @ np.diag(
        d.ravel().astype(np.float64))
    return 2 * p.T @ (p @ b.ravel().astype(np.float64))


@pytest.mark.parametrize("solver", ["cg", "lsqr"])
def test_grad_through_solve_matches_fd_and_jax(solver):
    n = 7
    m = port_masked(n, [2])
    b = m(_t(rand_img(n, seed=5)))

    def loss(bb):
        return (TR.solve(m, bb, solver, tol=1e-9,
                         maxiter=300).image ** 2).sum()

    bg = b.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(bg), bg)
    g = g.numpy()
    # f32 central differences on an O(1e4) loss carry ~1% cancellation
    # noise; the tight checks follow
    eps = 1e-2
    for (i, j) in [(0, 0), (3, 4), (n, n - 1)]:
        e = torch.zeros_like(b)
        e[i, j] = eps
        fd = float((loss(b + e) - loss(b - e)) / (2 * eps))
        assert abs(g[i, j] - fd) <= 5e-2 * max(1.0, abs(fd))
    want = _dense_grad(m.as_matrix().numpy(), m.d.numpy(), b.numpy())
    _close(g, want, 1e-3)
    rm = ref_masked(n, [2])
    rg = jax.grad(lambda bb: (RR.solve(rm, bb, solver, tol=1e-9,
                                       maxiter=300).image ** 2).sum())(
        jnp.asarray(b.numpy()))
    _close(g, np.asarray(rg), 1e-3)


def test_grad_through_sherman_is_exact():
    n = 5
    op = TR.DPRT((n, n), torch.int32)
    b = op(torch.from_numpy(rand_img(n, seed=6)).to(torch.int32)).float()
    bg = b.clone().requires_grad_(True)
    g, = torch.autograd.grad((TR.solve(op, bg).image ** 2).sum(), bg)
    m = TR.MaskedDPRT(op, device=CPU)
    _close(g.numpy(), _dense_grad(m.as_matrix().numpy(), m.d.numpy(),
                                  b.numpy()), 1e-3)
    rop = RR.DPRT((n, n), jnp.int32, method="gather")
    rg = jax.grad(lambda bb: (RR.solve(rop, bb).image ** 2).sum())(
        jnp.asarray(b.numpy()))
    _close(g.numpy(), np.asarray(rg), 1e-3)


def test_jvp_matches_reference_and_frozen_inputs_raise():
    n = 7
    m = port_masked(n, [1])
    rng = np.random.default_rng(11)
    b = m(_t(rand_img(n, seed=7)))
    t = _t(rng.standard_normal((n + 1, n)))

    def f(bb):
        return TR.solve(m, bb, "cg", tol=1e-9, maxiter=300).image

    out, tan = torch.func.jvp(f, (b,), (t,))
    rm = ref_masked(n, [1])
    rout, rtan = jax.jvp(lambda bb: RR.solve(rm, bb, "cg", tol=1e-9,
                                             maxiter=300).image,
                         (jnp.asarray(b.numpy()),), (jnp.asarray(t.numpy()),))
    _close(out.numpy(), np.asarray(rout), 1e-5)
    _close(tan.numpy(), np.asarray(rtan), 1e-4)
    # history, iterations and converged carry no gradient
    bg = b.clone().requires_grad_(True)
    res = TR.solve(m, bg, "cg")
    assert res.image.requires_grad
    assert not (res.residual_norms.requires_grad
                or res.iterations.requires_grad
                or res.converged.requires_grad)
    dm = TR.MaskedDPRT(TR.DPRT((n, n), torch.int32),
                       weight=torch.ones((n + 1, n), requires_grad=True))
    with pytest.raises(ValueError, match="linear in the sinogram only"):
        TR.solve(dm, b, "cg")
    with pytest.raises(ValueError, match="linear in the sinogram only"):
        TR.solve(m, b, "cg", precond=torch.ones((n + 1, n),
                                                requires_grad=True))
    with torch.no_grad():                      # no gradient asked: fine
        TR.solve(dm, b, "cg")


# ---------------------------------------------------------------------------
# serving properties: zero builds, batching, the operator surface
# ---------------------------------------------------------------------------
def test_solver_loops_build_once_and_drop_with_their_plan():
    n = 7
    op = TR.DPRT((n, n), torch.int32)
    m = port_masked(n, [2])
    rng = np.random.default_rng(8)
    b1 = _t(rng.standard_normal((n + 1, n)))
    b2 = _t(rng.standard_normal((n + 1, n)))
    with TR.retrace_guard(max_traces=1):
        for meth in ("cg", "lsqr", "landweber"):
            TR.solve(m, b1, meth, tol=1e-6, maxiter=40)
            TR.solve(m, b2, meth, tol=1e-6, maxiter=40)
        TR.solve(op, b1)
        TR.solve(op, b2)
    with TR.retrace_guard(max_traces=0):       # warm: nothing is built
        for meth in ("cg", "lsqr", "landweber"):
            TR.solve(m, b1, meth, tol=1e-6, maxiter=40)
    assert TR.trace_count(m.plan, kind="solve:cg") >= 1
    from repro_torch.radon import autodiff
    key = (m.plan, "solve:cg", (40, "none"))
    assert key in autodiff._APPLIERS
    TR.plan_cache_discard([m.plan])
    assert key not in autodiff._APPLIERS
    assert TR.trace_count(m.plan, kind="solve:cg") == 0


def test_iterations_count_one_k2_call_each():
    """Launch accounting on the CPU: every CG / Landweber iteration is one
    plan.pipeline('mul') call, LSQR one forward and one inverse, and the
    host counter agrees with SolveResult.iterations."""
    n = 7
    m = port_masked(n, [2])
    b = m(_t(rand_img(n, seed=12)))
    calls = {"pipeline": 0, "forward": 0, "inverse": 0}
    plan = m.plan
    orig = {k: getattr(type(plan), k) for k in calls}

    def counting(kind):
        def wrapped(self, *a, **kw):
            if self is plan:
                calls[kind] += 1
            return orig[kind](self, *a, **kw)
        return wrapped

    try:
        for kind in calls:
            setattr(type(plan), kind, counting(kind))
        for meth, per, pc in (("cg", {"pipeline": 1}, None),
                              ("cg", {"pipeline": 2}, _t(np.ones((n + 1, n)))),
                              ("landweber", {"pipeline": 1}, None),
                              ("lsqr", {"forward": 1, "inverse": 1}, None)):
            for k in calls:
                calls[k] = 0
            TS.reset_iteration_counts()
            res = TR.solve(m, b, meth, tol=0.0, maxiter=6, precond=pc)
            k = int(res.iterations)
            assert TS.ITERATIONS[meth] == k > 0
            extra = {"pipeline": 1 if pc is not None else 0,
                     "inverse": 1, "forward": 0}
            want = {kind: per.get(kind, 0) * k + extra[kind]
                    for kind in calls}
            assert calls == want, (meth, calls, want)
    finally:
        for kind, fn in orig.items():
            setattr(type(plan), kind, fn)


def test_batched_solve_matches_per_image():
    n, nb = 7, 3
    mb = port_masked(n, [1], batch=nb)
    m1 = port_masked(n, [1])
    xs = rand_img(n, seed=9, batch=nb)
    bb = mb(_t(xs))
    res = TR.solve(mb, bb, "cg", tol=1e-6, maxiter=150)
    assert res.residual_norms.shape == (151, nb)
    for i in range(nb):
        one = TR.solve(m1, bb[i], "cg", tol=1e-6, maxiter=150)
        np.testing.assert_allclose(res.image[i].numpy(), one.image.numpy(),
                                   rtol=1e-4, atol=1e-4)
    ref = RR.solve(ref_masked(n, [1], batch=nb), jnp.asarray(bb.numpy()),
                   "cg", tol=1e-6, maxiter=150)
    np.testing.assert_allclose(res.image.numpy(), np.asarray(ref.image),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("solver", ["cg", "landweber"])
def test_per_image_masks(solver):
    """A (B, P+1, P) diagonal masks each image of the stack differently:
    the batched solve equals per-image solves and the reference."""
    n, nb = 7, 3
    missing = [[1], [2, 5], [0, 7]]
    masks = np.stack([np.asarray(RR.direction_mask(n, mi))
                      for mi in missing])
    op = TR.DPRT((nb, n, n), torch.int32)
    m = TR.MaskedDPRT(op, mask=_t(masks))
    assert m.d.shape == (nb, n + 1, n)
    bb = m(_t(rand_img(n, seed=13, batch=nb)))
    kw = (dict(tol=1e-6, maxiter=150) if solver == "cg"
          else dict(tol=1e-6, maxiter=3000))
    res = TR.solve(m, bb, solver, **kw)
    for i in range(nb):
        one = TR.solve(port_masked(n, missing[i]), bb[i], solver, **kw)
        np.testing.assert_allclose(res.image[i].numpy(), one.image.numpy(),
                                   rtol=1e-3, atol=1e-3)
    rm = RR.MaskedDPRT(RR.DPRT((nb, n, n), jnp.int32, method="gather"),
                       mask=jnp.asarray(masks))
    ref = RR.solve(rm, jnp.asarray(bb.numpy()), solver, **kw)
    np.testing.assert_allclose(res.image.numpy(), np.asarray(ref.image),
                               rtol=1e-3, atol=1e-3)


def test_solve_operator_surface():
    n = 7
    mask = TR.direction_mask(n, [2], device=CPU)
    ro = TR.solve_operator((n, n), torch.int32, mask=mask, tol=1e-7,
                           maxiter=150)
    assert ro.solver == "cg"
    assert ro.shape_in == (n + 1, n)
    assert ro.shape_out == (n, n)
    assert ro.dtype_in == ro.dtype_out == float_dtype_for(torch.int32)
    m = TR.MaskedDPRT(TR.DPRT((n, n), torch.int32), mask=mask)
    b = m(_t(rand_img(n, seed=10)))
    exe = ro.compile(CPU)        # the executable, cached per device
    assert isinstance(exe, TR.Executable) and ro.compile(CPU) is exe
    assert torch.equal(exe(b), ro(b))
    np.testing.assert_allclose(ro(b).numpy(),
                               TR.solve(m, b, tol=1e-7,
                                        maxiter=150).image.numpy(),
                               rtol=1e-6, atol=1e-6)
    rro = RR.solve_operator((n, n), jnp.int32,
                            mask=RR.direction_mask(n, [2]), tol=1e-7,
                            maxiter=150)
    np.testing.assert_allclose(ro(b).numpy(),
                               np.asarray(rro(jnp.asarray(b.numpy()))),
                               rtol=1e-5, atol=1e-5)
    desc = ro.describe()
    assert desc["kind"] == "recon" and desc["solver"] == "cg"
    assert desc["maxiter"] == 150 and desc["precond"] == "none"
    assert "solver='cg'" in repr(ro)
    # composition: reconstruct, then re-project through the forward op
    chain = TR.DPRT((n, n), torch.float32) @ ro
    np.testing.assert_allclose(chain(b).numpy(), m.plan.forward(ro(b))
                               .numpy(), rtol=1e-6, atol=1e-5)
    with pytest.raises(AttributeError):
        ro.tol = 0.0
    with pytest.raises(ValueError):
        TR.ReconstructionOperator(m.T)
    # unmasked defaults to the direct solver
    assert TR.solve_operator((n, n), torch.int32,
                             device=CPU).solver == "sherman"
    pro = TR.solve_operator((n, n), torch.int32, mask=mask,
                            precond="sherman", maxiter=150)
    np.testing.assert_allclose(pro(b).numpy(), ro(b).numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# regression: integer sinograms promote to float without a warning
# ---------------------------------------------------------------------------
def test_int_solve_no_accum_warning_at_cliff():
    n = 257   # the int32 -> int64 accumulator cliff of int16
    op = TR.DPRT((n, n), torch.int16)
    b = torch.zeros((n + 1, n), dtype=torch.int16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = TR.solve(op, b)
    assert res.image.dtype == float_dtype_for(torch.int16) == torch.float32
    assert float(res.image.abs().max()) == 0.0
    # by design: int64 images solve in float64 (torch always has int64)
    assert float_dtype_for(torch.int64) == torch.float64
