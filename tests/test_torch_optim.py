"""The port's optimizer, ZeRO-1 placement and gradient compression against
the reference (``repro_torch.optim`` vs ``repro.optim``, the mesh half
of ``parallel.sharding``).

Same numpy inputs from a seed on both sides.  Tolerances: float32
values within 1e-5 of each leaf's peak (the two packages' float32
``pow``, ``sqrt`` and summation orders differ in the last bits); a
bfloat16 parameter within one bfloat16 step (2^-7 of its peak), since a
last-bit float32 difference may round it the other way; learning rates
and norms within 1e-6 relative.  Specs and ZeRO-1 choices are equal.

The compression draws its noise from ``torch.Generator`` where the
reference draws JAX's threefry, so its values are held to the
reference's properties instead: each element within one quantization
step, the mean error near zero, the tree's structure kept, and the
2-rank compressed mean within one step of the exact mean (a ``slow``
test spawning 2 gloo ranks).
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RAbstractMesh

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import Model as RModel
from repro.optim import adamw as r_adamw
from repro.parallel import sharding as r_sharding
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.optim import (AdamWConfig, accumulate_grads, adamw_init,
                               adamw_update, compress_tree,
                               cosine_schedule, dequantize_int8,
                               global_norm, quantize_int8, value_and_grad,
                               zero1_shardings)
from repro_torch.parallel.sharding import (AbstractMesh, abstract_params,
                                           logical_to_pspec, map_specs,
                                           param_pspecs, param_shardings,
                                           prune_pspec)
from repro_torch.tree import tree_leaves, tree_map

F32_REL = 1e-5
SCALAR_REL = 1e-6
BF16_REL = 2.0 ** -7


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


#: a tree of float32 and bfloat16 leaves: (shape, bfloat16?)
_LEAVES = {"a": ((5, 7), False), "b/c": ((4,), True),
           "b/d": ((3, 2, 2), False)}


def _random_tree(rng, scale):
    """{"a", "b": {"c", "d"}} of float32 numpy values (the bfloat16 leaf
    is rounded to bfloat16 once, so both packages start equal)."""
    flat = {}
    for k, (shape, bf16) in _LEAVES.items():
        v = (rng.normal(size=shape) * scale).astype(np.float32)
        flat[k] = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32) \
            if bf16 else v
    return {"a": flat["a"], "b": {"c": flat["b/c"], "d": flat["b/d"]}}


def _to_jax(tree):
    return {"a": jnp.asarray(tree["a"]),
            "b": {"c": jnp.asarray(tree["b"]["c"], jnp.bfloat16),
                  "d": jnp.asarray(tree["b"]["d"])}}


def _to_torch(tree):
    return {"a": torch.tensor(tree["a"]),
            "b": {"c": torch.tensor(tree["b"]["c"]).to(torch.bfloat16),
                  "d": torch.tensor(tree["b"]["d"])}}


def test_adamw_three_steps_match_reference():
    rng = np.random.default_rng(0)
    params0 = _random_tree(rng, 1.0)
    # step 1 clips (norm > 1), steps 2 and 3 do not
    grads = [_random_tree(rng, s) for s in (3.0, 0.05, 0.1)]
    r_cfg = r_adamw.AdamWConfig(lr=1e-2)
    r_sched = r_adamw.cosine_schedule(1e-2, 2, 10)
    rp = _to_jax(params0)
    ropt = r_adamw.adamw_init(rp)
    t_cfg = AdamWConfig(lr=1e-2)
    t_sched = cosine_schedule(1e-2, 2, 10)
    tp = _to_torch(params0)
    topt = adamw_init(tp)
    for g in grads:
        rp, ropt, rm = jax.jit(
            lambda p, g, o: r_adamw.adamw_update(p, g, o, r_cfg, r_sched))(
                rp, _to_jax(g), ropt)
        tp, topt, tm = adamw_update(tp, _to_torch(g), topt, t_cfg, t_sched)
        assert _rel(_np(tm["grad_norm"]), rm["grad_norm"]) <= SCALAR_REL
        assert _rel(_np(tm["lr"]), rm["lr"]) <= SCALAR_REL
        assert int(topt["step"]) == int(ropt["step"])
        assert topt["step"].dtype == torch.int32
        for name, want, got in (("mu", ropt["mu"], topt["mu"]),
                                ("nu", ropt["nu"], topt["nu"])):
            for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
                assert t.dtype == torch.float32
                assert _rel(_np(t), w) <= F32_REL, name
        for w, t in zip(jax.tree.leaves(rp), tree_leaves(tp)):
            bf16 = w.dtype == jnp.bfloat16
            assert t.dtype == (torch.bfloat16 if bf16 else torch.float32)
            got = _rel(_np(t), np.asarray(w, np.float32))
            assert got <= (BF16_REL if bf16 else F32_REL), got


def test_global_norm_matches_reference():
    tree = _random_tree(np.random.default_rng(1), 2.0)
    want = float(r_adamw.global_norm(_to_jax(tree)))
    got = global_norm(_to_torch(tree))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= SCALAR_REL * want


def test_cosine_schedule_matches_reference():
    warmup, total = 3, 10
    want = r_adamw.cosine_schedule(5e-3, warmup, total)
    got = cosine_schedule(5e-3, warmup, total)
    for step in range(total + 3):
        g = got(step)
        assert g.dtype == torch.float32
        w = float(want(step))
        assert abs(float(g) - w) <= SCALAR_REL * 5e-3, (step, float(g), w)
        assert float(got(torch.tensor(step, dtype=torch.int32))) == float(g)


def _lsq_problem():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    return {"w": w, "b": b}, {"x": x, "y": y}


def _r_lsq(p, batch):
    r = batch["x"] @ p["w"] + p["b"] - batch["y"]
    return jnp.mean(r * r), {}


def _t_lsq(p, batch):
    r = batch["x"] @ p["w"] + p["b"] - batch["y"]
    return torch.mean(r * r), {}


def test_accumulate_grads_matches_reference_and_full_batch():
    params, batch = _lsq_problem()
    r_loss, r_grads = r_adamw.accumulate_grads(
        _r_lsq, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch), 4)
    tp = tree_map(torch.tensor, params)
    tb = tree_map(torch.tensor, batch)
    loss, grads = accumulate_grads(_t_lsq, tp, tb, 4)
    assert _rel(_np(loss), r_loss) <= F32_REL
    for k in params:
        assert grads[k].dtype == torch.float32
        assert _rel(_np(grads[k]), r_grads[k]) <= F32_REL, k
    (full, _), g_full = value_and_grad(_t_lsq, tp, tb, has_aux=True)
    assert _rel(_np(loss), _np(full)) <= F32_REL
    for k in params:
        assert _rel(_np(grads[k]), _np(g_full[k])) <= F32_REL, k


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "deepseek_v2_236b"])
def test_specs_and_zero1_match_reference(arch, mesh_shape):
    names = ("data", "model")
    rmesh = RAbstractMesh(mesh_shape, names)
    tmesh = AbstractMesh(mesh_shape, names)
    r_specs = RModel(r_get_smoke_config(arch)).specs()
    specs = Model(get_smoke_config(arch)).specs()

    r_pspecs = r_sharding.param_pspecs(r_specs, mesh=rmesh)
    r_shard = r_sharding.param_shardings(r_specs, rmesh)
    r_zero = r_adamw.zero1_shardings(
        r_shard, r_sharding.abstract_params(r_specs), rmesh)
    t_pspecs = param_pspecs(specs, mesh=tmesh)
    t_shard = param_shardings(specs, tmesh)
    t_zero = zero1_shardings(t_shard, abstract_params(specs), tmesh)

    def walk(r, t, want_of, path=""):
        if isinstance(t, dict):
            assert set(t) == set(r), path
            for k in t:
                walk(r[k], t[k], want_of, f"{path}/{k}")
            return
        assert t == want_of(r), (path, t, want_of(r))

    walk(r_pspecs, t_pspecs, tuple)
    walk(r_shard, t_shard, lambda ns: tuple(ns.spec))
    walk(r_zero, t_zero, lambda ns: tuple(ns.spec))
    # every moment's chosen dim, leaf by leaf, and the pruning itself
    t_leaves = {}
    map_specs(lambda p, s: t_leaves.setdefault(p, s), specs)
    for path, s in t_leaves.items():
        spec = logical_to_pspec(s.logical, mesh=tmesh)
        want = tuple(r_sharding.prune_pspec(
            r_sharding.logical_to_pspec(s.logical, mesh=rmesh), s.shape,
            rmesh))
        assert prune_pspec(spec, s.shape, tmesh) == want, path
    assert "'data'" in str(t_zero)          # some moment took the axis


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_int8_quantization_error_bound_and_unbiased():
    x = torch.tensor(np.random.default_rng(0).normal(size=(1000,))
                     .astype(np.float32))
    q, s = quantize_int8(x, _gen(0))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) <= 127
    back = dequantize_int8(q, s)
    # each element within one quantization step; the draws reproducible
    assert float((back - x).abs().max()) <= float(s) * 1.01
    assert torch.equal(quantize_int8(x, _gen(0))[0], q)
    # unbiased: the mean error of 400 draws per element is near zero
    # (its std is at most 0.5 s / 20 = 0.025 s; 0.15 s is six of them)
    gen = _gen(1)
    err = torch.zeros_like(x)
    for _ in range(400):
        qi, si = quantize_int8(x, gen)
        err += dequantize_int8(qi, si) - x
    assert float((err / 400).abs().max()) < 0.15 * float(s)
    assert abs(float(err.mean() / 400)) < 0.2 * float(s) / 20
    zq, zs = quantize_int8(torch.zeros(5), _gen(2))
    assert float(zs) == pytest.approx(1e-12 / 127.0)
    assert not zq.any()


def test_compress_tree_keeps_structure():
    g = {"a": torch.ones(4, 4), "b": {"c": torch.full((3,), -2.0),
                                      "d": torch.ones(2, dtype=torch.bfloat16)}}
    out = compress_tree(g, _gen(1))
    assert set(out) == {"a", "b"} and set(out["b"]) == {"c", "d"}
    for k, v in (("a", out["a"]), ("c", out["b"]["c"]),
                 ("d", out["b"]["d"])):
        want = g[k] if k == "a" else g["b"][k]
        assert v.shape == want.shape and v.dtype == want.dtype, k
    np.testing.assert_allclose(out["b"]["c"].numpy(), -2.0, rtol=0.02)
    again = compress_tree(g, _gen(1))
    assert torch.equal(again["a"], out["a"])


def _psum_worker(rank, world, port, xs):
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_mean
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        x = torch.tensor(xs[rank])
        got = compressed_psum_mean(x, dist.group.WORLD, _gen(10 + rank))
        exact = torch.tensor(np.mean(xs, axis=0))
        step = max(float(np.abs(xs).max()), 1e-12) / 127.0
        assert got.shape == x.shape and got.dtype == x.dtype
        # each rank's rounding moves its term by at most one step;
        # the mean of two moves by at most one step
        assert float((got - exact).abs().max()) <= step * 1.01
        others = [torch.empty_like(got) for _ in range(world)]
        dist.all_gather(others, got)
        assert all(torch.equal(o, got) for o in others)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_compressed_psum_mean_two_gloo_ranks():
    import torch.multiprocessing as mp
    xs = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)
    xs[1] *= 3.0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_psum_worker, args=(2, port, xs), nprocs=2, join=True)


def test_value_and_grad_frees_its_gradients():
    """Dropped gradients are freed at once, not at the next garbage
    collection (a reference cycle would hold a step's gradients, GBs at
    full width, into the next step)."""
    import weakref
    params, batch = _lsq_problem()
    tp = tree_map(torch.tensor, params)
    tb = tree_map(torch.tensor, batch)
    _, grads = value_and_grad(lambda p: _t_lsq(p, tb)[0], tp)
    refs = [weakref.ref(g) for g in tree_leaves(grads)]
    del grads
    assert all(r() is None for r in refs)
