"""K2, the port's fused projection-domain pipeline, and the operators on
it, against the JAX reference on the CPU.

On CPU tensors the port's K2 wrapper runs the kernel's plain PyTorch
version (``repro_torch.kernels.pipeline.pipeline_plain``); these tests
hold it, the plan's ``pipeline`` (fused and staged routes), ``Conv2D``,
``ProjectionFilter`` fusion and the pipeline's gradients against
``repro`` -- the raw kernel and its wrapper in Pallas interpret mode at
N <= 13, plans and operators at N <= 31.  The same numpy inputs go to
both packages.  Integer results are bit-exact (including int32
overflow, which both wrap, and the floor division of non-transform
numerators); float results agree within a stated tolerance.  The CUDA
kernel runs only on a card: the one ``cuda``-marked test skips here,
and ``chip_smoke.py`` holds the kernel against its plain version there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import radon as RR
from repro.core import plan as RP
from repro.core.dprt import dprt_oracle_np
from repro.kernels.ops import projection_pipeline_pallas
from repro.kernels.sfdprt import pipeline_pallas_raw
from repro_torch import radon as TR
from repro_torch.core import conv as TC
from repro_torch.core import plan as TP
from repro_torch.kernels import ops, pipeline as P, tuning as TT


def _ints(shape, seed, lo=-300, hi=300):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the raw kernel: (out, aux) against pipeline_pallas_raw in interpret mode
# ---------------------------------------------------------------------------
# (label, N, op, operand form, operand batch (0: none), m_block, group):
# one case per op and form, with awkward blocks -- m_block 1, blocks that
# do not divide N+1, and a block larger than N+1
RAW_CASES = [
    ("none", 5, "none", "proj", 0, 4, 1),
    ("mul-shared", 7, "mul", "proj", 1, 3, 2),
    ("mul-batched", 13, "mul", "proj", 3, 16, 4),
    ("conv-image-shared", 7, "conv", "image", 1, 1, 3),
    ("conv-image-batched", 13, "conv", "image", 3, 5, 8),
    ("conv-proj-shared", 5, "conv", "proj", 1, 2, 1),
    ("conv-proj-batched", 13, "conv", "proj", 3, 4, 4),
]


def _raw_inputs(n, op, form, wb, seed, big=False):
    lo, hi = (-2 ** 28, 2 ** 28) if big else (-300, 300)
    f = _ints((3, n, n), seed, lo, hi)
    if op == "none":
        return f, None
    rows = n if form == "image" else n + 1
    w = _ints((wb, rows, n), seed + 1, *((lo, hi) if big else (-9, 10)))
    return f, w


@pytest.mark.parametrize("label,n,op,form,wb,mb,grp", RAW_CASES,
                         ids=[c[0] for c in RAW_CASES])
def test_pipeline_raw_matches_pallas_interpret(label, n, op, form, wb, mb,
                                               grp):
    f, w = _raw_inputs(n, op, form, wb, seed=n * 7 + mb)
    want, want_aux = pipeline_pallas_raw(
        jnp.asarray(f), None if w is None else jnp.asarray(w), op=op,
        operand_form=form, m_block=mb, group=grp)
    got, got_aux = P.pipeline_raw(_t(f), None if w is None else _t(w),
                                  op=op, operand_form=form, m_block=mb,
                                  group=grp)
    assert got.dtype == torch.int32 and got_aux.shape == (3, 2, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :n, :n])
    np.testing.assert_array_equal(got_aux.numpy(),
                                  np.asarray(want_aux)[:, :, :n])


def test_pipeline_raw_int32_overflow_wraps_like_reference():
    """Forward sums, conv products and inverse sums all overflow int32;
    both packages wrap, bit for bit."""
    n = 7
    f, w = _raw_inputs(n, "conv", "proj", 1, seed=5, big=True)
    want, want_aux = pipeline_pallas_raw(jnp.asarray(f), jnp.asarray(w),
                                         op="conv", operand_form="proj",
                                         m_block=3)
    got, got_aux = P.pipeline_raw(_t(f), _t(w), op="conv",
                                  operand_form="proj", m_block=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :n, :n])
    np.testing.assert_array_equal(got_aux.numpy(),
                                  np.asarray(want_aux)[:, :, :n])


def test_pipeline_raw_float32_within_tolerance():
    """float32 conv against the reference: within 1e-5 of the largest
    per-direction output (the terms the inverse sums)."""
    rng = np.random.default_rng(6)
    n = 7
    f = rng.random((2, n, n)).astype(np.float32)
    g = rng.random((1, n, n)).astype(np.float32)
    want, want_aux = pipeline_pallas_raw(jnp.asarray(f), jnp.asarray(g),
                                         op="conv", operand_form="image",
                                         m_block=3)
    got, got_aux = P.pipeline_raw(_t(f), _t(g), op="conv",
                                  operand_form="image", m_block=3)
    tol = 1e-5 * float(np.abs(np.asarray(want_aux)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :n, :n],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got_aux.numpy(),
                               np.asarray(want_aux)[:, :, :n], rtol=0,
                               atol=tol)


def test_pipeline_plain_int64_exact_vs_direct():
    """int64 (the reference runs it only under x64): the plain version
    against the direct O(N^4) oracle in int64."""
    n = 7
    f = _ints((2, n, n), 8).astype(np.int64)
    g = _ints((1, n, n), 9, -9, 10).astype(np.int64)
    got, _ = P.pipeline_raw(_t(f), _t(g), op="conv", operand_form="image")
    assert got.dtype == torch.int64
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), TC.circ_conv2d_direct(_t(f[i]), _t(g[0])).numpy())


# ---------------------------------------------------------------------------
# the wrapper: projection_pipeline_cuda vs projection_pipeline_pallas
# ---------------------------------------------------------------------------
def test_projection_pipeline_matches_reference_wrapper():
    n = 13
    f = _ints((n, n), 10, 0, 30)
    g = _ints((n, n), 11, 0, 9)
    rg = dprt_oracle_np(g).astype(np.int32)
    fb = _ints((2, n, n), 12, 0, 30)
    for args, kw in [((f, "conv", g), {}),                    # image form
                     ((fb, "conv", rg), {"m_block": 5}),      # proj form
                     ((fb, "mul", rg), {"group": 2})]:
        want = projection_pipeline_pallas(
            *(None if a is None else (jnp.asarray(a) if isinstance(
                a, np.ndarray) else a) for a in args), **kw)
        got = ops.projection_pipeline_cuda(
            *(_t(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BAD_CALLS = [
    ("missing-operand", (5, 5), "conv", None),
    ("unknown-op", (5, 5), "warp", (5, 5)),
    ("bad-weights", (5, 5), "mul", (4, 5)),
    ("batch-mismatch", (3, 5, 5), "conv", (2, 5, 5)),
    ("non-prime", (6, 6), "none", None),
]


@pytest.mark.parametrize("label,fshape,op,wshape", BAD_CALLS,
                         ids=[c[0] for c in BAD_CALLS])
def test_projection_pipeline_rejects_what_the_reference_rejects(
        label, fshape, op, wshape):
    f = np.zeros(fshape, np.int32)
    w = None if wshape is None else np.zeros(wshape, np.int32)
    with pytest.raises(ValueError):
        projection_pipeline_pallas(jnp.asarray(f), op,
                                   None if w is None else jnp.asarray(w))
    with pytest.raises(ValueError):
        ops.projection_pipeline_cuda(_t(f), op, None if w is None else _t(w))


def test_group_and_lane_batch_change_nothing_and_are_validated():
    n = 13
    f, g = _t(_ints((3, n, n), 13)), _t(_ints((3, n, n), 14, -9, 10))
    base = ops.projection_pipeline_cuda(f, "conv", g)
    for kw in [dict(group=1), dict(group=9, lane_batch=3),
               dict(m_block=1, lane_batch=2)]:
        assert torch.equal(ops.projection_pipeline_cuda(f, "conv", g, **kw),
                           base)
    for kw in [dict(group=0), dict(m_block=0), dict(lane_batch=0)]:
        with pytest.raises(ValueError):
            ops.projection_pipeline_cuda(f, "conv", g, **kw)


def test_pipeline_tuning_matches_reference():
    from repro.kernels import tuning as RT
    assert TT.PIPELINE_TUNE == RT.PIPELINE_TUNE
    for n in (5, 13, 31, 61, 251, 2053):
        assert (TT.resolve_pipeline_blocks(n)
                == RT.resolve_pipeline_blocks(n))
    with pytest.raises(ValueError):
        TT.resolve_pipeline_blocks(13, m_block=0)


def test_smem_blocks_cap_m_block_and_reject_rows_that_do_not_fit():
    """K2's tile (``tuning.pipeline_tile``; the name dates from the
    shared-memory-only ``smem_blocks``): at the main path conv holds the
    rf rows and each direction's operand window, then its padded rc row;
    mul/none the padded rc rows.  Directions per block, spread evenly
    over the blocks of an image, and the shared bytes of one block per
    SM.  K3's tile (``tuning.tail_tile``) has the same layout without
    the ring: at world size 1 (all 252 directions) and for a 63-row
    shard of a 4-rank mesh, the same D and shared bytes as K2's."""
    def tile(n, itemsize, m_block, op):
        t = TT.pipeline_tile(n, itemsize, m_block, op)
        return t.m_block, t.blocks, t.smem
    assert tile(251, 4, 64, "conv") == (63, 4, 200032)
    assert tile(251, 4, 64, "mul") == (63, 4, 127712)
    assert tile(251, 8, 64, "conv") == (36, 7, 229440)
    assert tile(251, 4, 20, "none") == (20, 13, 40672)  # m_block caps D
    assert tile(5, 4, 100, "none") == (6, 1, 1056)       # capped at N+1
    with pytest.raises(ValueError, match="does not fit"):
        TT.pipeline_tile(40009, 8, 64, "conv")
    def tail(op, rows):
        t = TT.tail_tile(251, 4, 64, op, rows)
        return t.m_block, t.blocks, t.smem
    assert tail("conv", 252) == (63, 4, 200032)
    assert tail("mul", 252) == (63, 4, 127712)
    assert tail("none", 252) == (63, 4, 127712)
    assert tail("conv", 63) == (63, 1, 200032)
    assert tail("mul", 63) == (63, 1, 127712)
    assert tail("none", 63) == (63, 1, 127712)
    assert TT.tail_tile(251, 4, 128, "mul", 252).m_block == 84  # past 64
    with pytest.raises(ValueError, match="does not fit"):
        TT.tail_tile(40009, 8, 64, "conv", 4)


def test_pipeline_tail_shard_partials_rebuild_the_pipeline():
    """On CPU tensors ``pipeline_tail_cuda`` (K3) runs its plain
    version, whose shard partials, summed and corrected, give the fused
    pipeline."""
    rng = np.random.default_rng(11)
    n, b = 13, 3
    f = torch.from_numpy(rng.integers(-50, 50, (b, n, n)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-5, 6, (b, n + 1, n)).astype(np.int32))
    rf = P.pipeline_plain(f, w, op="mul")[0]
    rows = torch.zeros((b, 16, n), dtype=torch.int32)
    rows[:, :n + 1] = ops.dprt_cuda(f)
    z = aux = 0
    for r in range(4):
        zr, ar = ops.pipeline_tail_cuda(rows[:, 4 * r:4 * r + 4], "mul", w,
                                        row_offset=4 * r)
        z, aux = z + zr, aux + ar
    s = aux[:, 0].sum(-1, dtype=torch.int32)[:, None, None]
    got = torch.div(z - s + aux[:, 1, :, None], n, rounding_mode="floor")
    assert torch.equal(got, rf)
    with pytest.raises(ValueError, match="needs an operand"):
        ops.pipeline_tail_cuda(torch.zeros(4, 13, dtype=torch.int32))


# ---------------------------------------------------------------------------
# plans: RadonPlan.pipeline, fused and staged, against the reference plan
# ---------------------------------------------------------------------------
def _ref_pipeline(shape, op, f, w, method="horner"):
    plan = RP.get_plan(shape, jnp.int32, method)
    return np.asarray(plan.pipeline(jnp.asarray(f), op,
                                    None if w is None else jnp.asarray(w)))


PLAN_ROUTES = [
    ("fused", dict(method="cuda")),
    ("staged-block-rows", dict(method="cuda", block_rows=4)),
    ("staged-no-capability", dict(method="horner")),
    ("fused-block-batch", dict(method="cuda", block_batch=2)),
]


@pytest.mark.parametrize("route,knobs", PLAN_ROUTES,
                         ids=[r[0] for r in PLAN_ROUTES])
def test_plan_pipeline_routes_match_reference(route, knobs):
    n = 13
    shape = (3, n, n)
    f = _ints(shape, 20, 0, 40)
    gb = _ints(shape, 21, -9, 10)
    w = _ints((n + 1, n), 22, -9, 10)
    plan = TP.get_plan(shape, torch.int32, **knobs)
    assert (plan.backend.pipeline is not None) == (knobs["method"] == "cuda")
    for op, operand in [("conv", gb), ("conv", gb[0]), ("mul", w),
                        ("none", None)]:
        got = plan.pipeline(_t(f), op, None if operand is None
                            else _t(operand))
        want = _ref_pipeline(shape, op, f, operand)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plan_pipeline_block_batch_with_batch_one_operand():
    """A (1, P+1, P) operand under block_batch is shared across chunks
    (the reference's pairing of chunks fails on it, so the port's
    unchunked plan is the oracle here)."""
    n = 7
    f = _t(_ints((5, n, n), 40, 0, 30))
    w = _t(_ints((1, n + 1, n), 41, -5, 6))
    whole = TP.get_plan((5, n, n), torch.int32)
    chunked = TP.get_plan((5, n, n), torch.int32, block_batch=2)
    for op, operand in [("mul", w), ("conv", w)]:
        assert torch.equal(chunked.pipeline(f, op, operand),
                           whole.pipeline(f, op, operand))


def test_plan_pipeline_fused_equals_reference_pallas_plan():
    n = 7
    f, g = _ints((n, n), 23, 0, 40), _ints((n, n), 24, -9, 10)
    rg = dprt_oracle_np(g).astype(np.int32)
    want = _ref_pipeline((n, n), "conv", f, rg, method="pallas")
    got = TP.get_plan((n, n), torch.int32).pipeline(_t(f), "conv", _t(rg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_pipeline_embedded_geometry_mul_none():
    """mul/none on an embedded geometry are the literal embed -> transform
    -> weight -> inverse -> crop composition; conv needs native."""
    shape = (6, 8)
    plan = TP.get_plan(shape, torch.int32)
    p = plan.geometry.prime
    f = _ints(shape, 25, 0, 50)
    w = _ints((p + 1, p), 26, -5, 6)
    for op, operand in [("mul", w), ("none", None)]:
        got = plan.pipeline(_t(f), op, None if operand is None
                            else _t(operand))
        np.testing.assert_array_equal(got.numpy(),
                                      _ref_pipeline(shape, op, f, operand))
    with pytest.raises(ValueError, match="native"):
        plan.pipeline(_t(f), "conv", _t(f))


PLAN_ERRORS = [
    ("unknown-op", (13, 13), "warp", (13, 13)),
    ("wrong-image-shape", (13, 13), "none", None),
    ("missing-operand", (13, 13), "mul", None),
    ("bad-operand-shape", (13, 13), "mul", (13, 13)),
    ("batch-mismatch", (3, 13, 13), "conv", (2, 13, 13)),
]


@pytest.mark.parametrize("label,shape,op,wshape", PLAN_ERRORS,
                         ids=[c[0] for c in PLAN_ERRORS])
def test_plan_pipeline_operand_validation(label, shape, op, wshape):
    plan = TP.get_plan(shape, torch.int32)
    f = torch.zeros(shape if label != "wrong-image-shape" else (11, 13),
                    dtype=torch.int32)
    w = None if wshape is None else torch.zeros(wshape, dtype=torch.int32)
    with pytest.raises(ValueError):
        plan.pipeline(f, op, w)


def test_capability_table_has_pipeline_column():
    rows = {r["name"]: r for r in TP.backend_capabilities()}
    assert rows["cuda"]["pipeline"] is True
    for name in ("horner", "gather", "strips"):
        assert rows[name]["pipeline"] is False


def test_plan_pipeline_n251_fused_equals_staged():
    """The one N=251 case: the fused route (K2's plain version here)
    against the port's own staged route, a 3 x 3 ones kernel."""
    n = 251
    f = torch.from_numpy(_ints((1, n, n), 27, 0, 256))
    kern = torch.zeros((n, n), dtype=torch.int32)
    kern[:3, :3] = 1
    fused = TP.get_plan((1, n, n), torch.int32)
    staged = TP.get_plan((1, n, n), torch.int32, block_rows=n)
    rg = fused.forward(kern[None])[0]
    assert torch.equal(fused.pipeline(f, "conv", rg),
                       staged.pipeline(f, "conv", rg))


# ---------------------------------------------------------------------------
# operators: Conv2D, ProjectionFilter fusion, gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7, 7), (3, 7, 7), (6, 8)], ids=str)
def test_conv2d_from_reference_description(shape):
    rng = np.random.default_rng(30)
    kern = rng.integers(-4, 5, (3, 3)).astype(np.int32)
    ref = RR.Conv2D(shape, jnp.asarray(kern))
    port = TR.conv2d_from_description(ref.describe(), np.asarray(ref.kernel))
    assert port.describe() == {**ref.describe(), "method": "cuda"}
    f = _ints(shape, 31, 0, 60)
    np.testing.assert_array_equal(port(_t(f)).numpy(),
                                  np.asarray(ref(jnp.asarray(f))))
    np.testing.assert_array_equal(port.T(_t(f)).numpy(),
                                  np.asarray(ref.T(jnp.asarray(f))))
    if shape == (7, 7):
        np.testing.assert_array_equal(port.as_matrix("cpu").numpy(),
                                      np.asarray(ref.as_matrix()))
    with pytest.raises(TypeError, match="no exact inverse"):
        port.inverse


def test_filter_composite_fuses_like_reference():
    n = 13
    rng = np.random.default_rng(32)
    w = rng.integers(-5, 6, (n + 1, n)).astype(np.int32)
    f = _ints((n, n), 33, 0, 60)
    rdp = RR.DPRT((n, n), jnp.int32, "horner")
    want = np.asarray((rdp.inverse @ RR.ProjectionFilter(jnp.asarray(w))
                       @ rdp)(jnp.asarray(f)))
    dp = TR.DPRT((n, n), torch.int32)
    comp = dp.inverse @ TR.projection_filter_from_numpy(w) @ dp
    assert len(comp.ops) == 1
    assert isinstance(comp.ops[0], TR.FusedProjectionPipeline)
    assert comp.dtype_in == torch.int32
    np.testing.assert_array_equal(comp(_t(f)).numpy(), want)
    # different plans: not fused, still right
    other = TR.DPRT((n, n), torch.int32, "horner")
    unfused = dp.inverse @ TR.ProjectionFilter(_t(w)) @ other
    assert len(unfused.ops) == 3
    np.testing.assert_array_equal(unfused(_t(f)).numpy(), want)
    with pytest.raises(TypeError, match="no exact inverse"):
        comp.inverse


def test_gradients_match_reference_jax_grad():
    """float64 gradients of the pipeline in the image and the operand,
    against jax.grad of the reference, within 1e-9."""
    n = 7
    rng = np.random.default_rng(34)
    f = rng.random((2, n, n))
    u = rng.random((2, n, n))
    g = rng.random((n, n))
    w = rng.random((n + 1, n))
    with jax.enable_x64(True):
        rplan = RP.get_plan((2, n, n), jnp.float64, "horner")
        plan = TP.get_plan((2, n, n), torch.float64)
        for op, operand in [("conv", g), ("mul", w)]:
            def loss_ref(x, y):
                return (RR.pipeline_apply(rplan, x, op, y) * u).sum()
            want_f, want_w = jax.grad(loss_ref, argnums=(0, 1))(
                jnp.asarray(f), jnp.asarray(operand))
            x, y = _t(f).requires_grad_(), _t(operand).requires_grad_()
            (TR.pipeline_apply(plan, x, op, y) * _t(u)).sum().backward()
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_f),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(y.grad.numpy(), np.asarray(want_w),
                                       rtol=1e-9, atol=1e-9)


GRADCHECK_CASES = [
    ("conv-image", (7, 7), "conv", (7, 7)),
    ("conv-proj-batched", (2, 5, 5), "conv", (2, 6, 5)),
    ("mul-shared", (2, 5, 5), "mul", (6, 5)),
    ("none", (5, 5), "none", None),
]


@pytest.mark.parametrize("label,shape,op,wshape", GRADCHECK_CASES,
                         ids=[c[0] for c in GRADCHECK_CASES])
def test_pipeline_gradcheck(label, shape, op, wshape):
    rng = np.random.default_rng(35)
    plan = TP.get_plan(shape, torch.float64)
    x = torch.from_numpy(rng.random(shape)).requires_grad_()
    inputs = (x,)
    if wshape is not None:
        inputs += (torch.from_numpy(rng.random(wshape)).requires_grad_(),)
    assert torch.autograd.gradcheck(
        lambda *a: TR.pipeline_apply(plan, a[0], op, *a[1:]), inputs)


def test_conv2d_gradients_in_image_and_kernel():
    """Conv2D (batched: the kernel rides in projection form) -- the image
    gradient is op.T, the kernel gradient the summed correlation."""
    n = 7
    rng = np.random.default_rng(36)
    x = torch.from_numpy(rng.random((3, n, n))).requires_grad_()
    k = torch.from_numpy(rng.random((3, 3))).requires_grad_()
    u = torch.from_numpy(rng.random((3, n, n)))
    op = TR.Conv2D((3, n, n), k, torch.float64)
    (op(x) * u).sum().backward()
    torch.testing.assert_close(x.grad, op.T(u).detach(), rtol=1e-9,
                               atol=1e-9)
    corr = sum(TC.circ_conv2d_direct(TR.flip_image(x[i].detach()), u[i])
               for i in range(3))
    torch.testing.assert_close(k.grad, corr[:3, :3], rtol=1e-9, atol=1e-9)
    assert torch.autograd.gradcheck(
        lambda kk: TR.Conv2D((3, n, n), kk, torch.float64)(x.detach()),
        (k.detach().clone().requires_grad_(),))


def test_pipeline_builds_are_counted_and_guarded():
    n = 11
    plan = TP.get_plan((n, n), torch.int32, block_batch=None)
    f, g = _t(_ints((n, n), 37, 0, 30)), _t(_ints((n, n), 38, 0, 9))
    before = TR.trace_count(plan, "pipeline:conv")
    TR.pipeline_apply(plan, f, "conv", g)
    assert TR.trace_count(plan, "pipeline:conv") == before + (before == 0)
    with TR.retrace_guard(max_traces=0):
        for _ in range(3):
            TR.pipeline_apply(plan, f + 1, "conv", g)
            TC.circ_conv2d_dprt(f, g)


@pytest.mark.cuda
def test_k2_on_the_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K2 runs only on the GPU "
                    "(chip_smoke.py covers it there)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(39)
    for n in (5, 13, 61):
        f = torch.from_numpy(_ints((3, n, n), n)).to(dev)
        g = torch.from_numpy(_ints((1, n, n), n + 1, -9, 10)).to(dev)
        for mb in (1, 4, n + 3):
            got = P.pipeline_raw(f, g, op="conv", operand_form="image",
                                 m_block=mb)
            want = P.pipeline_plain(f, g, op="conv", operand_form="image")
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
