"""The port's LM substrate under gradients, against the reference
(``Model.loss`` differentiated with respect to the parameter tree).

Every architecture of ``ARCH_IDS`` at its smoke size, on the reference's
float32 weights carried across (``models.convert.params_from_reference``)
and the same numpy batch: the loss within 1e-5 relative and every
gradient leaf within 1e-4 of that leaf's peak (the reference's
``jax.value_and_grad`` against the port's autograd; their float32
summation orders differ).  Also ``cfg.remat`` none / full / dots: the
same loss as the reference's in each mode, the port's gradients equal
across modes, and the matrix products each mode recomputes in the
backward pass (``full`` recomputes the forward's, ``dots`` saves them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import Model as RModel
from repro.parallel.sharding import abstract_params as r_abstract_params
from repro.parallel.sharding import init_params as r_init_params
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import value_and_grad
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten

B, S = 2, 24
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _inputs(cfg, seed=11):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["patch_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["audio_embed"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _reference(arch, remat=None, grads=True):
    rcfg = r_get_smoke_config(arch)
    if remat is not None:
        rcfg = rcfg.replace(remat=remat)
    rm = RModel(rcfg)
    rp = r_init_params(rm.specs(), jax.random.key(3), jnp.float32)
    batch = _inputs(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = lambda p, b: rm.loss(p, b)[0]                     # noqa: E731
    fn = jax.value_and_grad(loss) if grads else loss
    out = jax.tree.map(np.asarray, jax.jit(fn)(rp, jb))
    return jax.tree.map(np.asarray, rp), batch, out


def _port(arch, rp, batch, remat=None):
    cfg = get_smoke_config(arch)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    model = params_from_reference(Model(cfg), rp, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return value_and_grad(lambda p: model.loss(tb, params=p)[0],
                          model.param_tree())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_gradients_match_reference(arch):
    rp, batch, (r_loss, r_grads) = _reference(arch)
    loss, grads = _port(arch, rp, batch)
    assert abs(float(loss) - float(r_loss)) <= LOSS_REL * abs(float(r_loss))
    want = dict(tree_items(r_grads))
    got = dict(tree_items(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path], np.float64)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        err = float(np.abs(g.numpy().astype(np.float64) - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-30, (
            path, err, float(np.abs(w).max()))


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls (the unbatched matrix products)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "whisper_large_v3"])
def test_remat_modes_keep_the_loss_and_gradients(arch):
    """whisper also remats its encoder's layers.  The reference's loss
    (its default ``full``) is the same in every mode; one jit of it."""
    rp, batch, r_loss = _reference(arch, grads=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, grads, backward_mm = {}, {}, {}
    for mode in ("none", "full", "dots"):
        cfg = get_smoke_config(arch).replace(remat=mode)
        model = params_from_reference(Model(cfg), rp, device="cpu")
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(model.param_tree())]
        tree = tree_unflatten(model.param_tree(), leaves)
        loss = model.loss(tb, params=tree)[0]
        with _CountMM() as count:
            gs = torch.autograd.grad(loss, leaves)
        losses[mode] = float(loss.detach())
        grads[mode] = gs
        backward_mm[mode] = count.mm
        assert abs(losses[mode] - float(r_loss)) <= LOSS_REL * abs(
            float(r_loss)), mode
    assert losses["none"] == losses["full"] == losses["dots"]
    for mode in ("full", "dots"):
        for a, b in zip(grads["none"], grads[mode]):
            assert torch.equal(a, b), mode
    # full recomputes the forward's products; dots keeps them
    assert backward_mm["dots"] == backward_mm["none"]
    assert backward_mm["full"] > backward_mm["none"]


def test_train_step_matches_reference():
    """``launch.steps.make_train_step`` (float32 parameters), one step on
    the reference's weights and moments: the metrics within 1e-5
    relative, every parameter and moment within 1e-5 of its leaf's
    peak."""
    from repro.launch import steps as r_steps
    from repro.optim import adamw_init as r_adamw_init
    from repro_torch.launch import steps
    from repro_torch.models.convert import opt_state_from_reference

    arch = "tinyllama_1_1b"
    rm = RModel(r_get_smoke_config(arch))
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    r_fn, _ = r_steps.make_train_step(rm, rmesh, "train_4k", lr=1e-2,
                                      param_dtype=jnp.float32)
    rp = r_init_params(rm.specs(), jax.random.key(5), jnp.float32)
    ropt = r_adamw_init(rp)
    batch = _inputs(rm.cfg)
    np_p = jax.tree.map(np.asarray, rp)
    np_opt = jax.tree.map(np.asarray, ropt)
    rp, ropt, rmet = jax.tree.map(np.asarray, r_fn(
        rp, ropt, {k: jnp.asarray(v) for k, v in batch.items()}))

    model = Model(get_smoke_config(arch))
    fn, (p_struct, o_struct, b_struct) = steps.make_train_step(
        model, None, "train_4k", lr=1e-2, param_dtype=torch.float32)
    assert tuple(b_struct["tokens"].shape) == (256, 4096)
    assert b_struct["tokens"].device.type == "meta"
    tp = params_from_reference(Model(model.cfg), np_p,
                               device="cpu").param_tree()
    topt = opt_state_from_reference(model, np_opt, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp, topt, met = fn(tp, topt, tb)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert abs(float(met[k]) - float(rmet[k])) <= LOSS_REL * max(
            abs(float(rmet[k])), 1e-3), k
    for name, got, want in (("params", tp, rp), ("mu", topt["mu"],
                                                 ropt["mu"]),
                            ("nu", topt["nu"], ropt["nu"])):
        w = dict(tree_items(want))
        for path, g in tree_items(got):
            ww = np.asarray(w[path], np.float64)
            err = float(np.abs(g.detach().numpy() - ww).max())
            assert err <= LOSS_REL * float(np.abs(ww).max()) + 1e-30, (
                name, path, err)
    assert int(topt["step"]) == 1


def _spec_items(tree, path=()):
    """{path: spec} of a nested dict whose leaves are spec tuples."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_spec_items(v, path + (k,)))
    return out


def _struct_tree(tree):
    """{path: (shape, dtype name)} of meta tensors or ShapeDtypeStructs."""
    return {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in tree_items(tree)}


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "whisper_large_v3",
                                  "mamba2_2_7b", "deepseek_v2_236b",
                                  "recurrentgemma_2b", "internvl2_26b"])
def test_shapes_and_step_structs_match_reference(arch):
    """``launch.shapes`` / ``launch.steps`` at the published config: the
    meta stand-ins' shapes and dtypes and the placements on a (2, 2)
    ``data x model`` mesh equal the reference's (its ShapeDtypeStructs
    and NamedShardings on an AbstractMesh).  Nothing is allocated."""
    from jax.sharding import AbstractMesh as RAbstractMesh
    from repro.configs import get_config as r_get_config
    from repro.launch import shapes as r_shapes
    from repro.launch import steps as r_steps
    from repro_torch.configs import get_config
    from repro_torch.launch import shapes, steps
    from repro_torch.parallel.sharding import AbstractMesh

    rcfg, cfg = r_get_config(arch), get_config(arch)
    rmodel, model = RModel(rcfg), Model(cfg)
    rmesh = RAbstractMesh((2, 2), ("data", "model"))
    mesh = AbstractMesh((2, 2), ("data", "model"))
    assert shapes.SHAPES == r_shapes.SHAPES
    for shape in shapes.SHAPES:
        assert shapes.shape_applicable(cfg, shape) == \
            r_shapes.shape_applicable(rcfg, shape)
        for labels in (True, False):
            rb = r_shapes.batch_structs(rcfg, shape, labels)
            tb = shapes.batch_structs(cfg, shape, labels)
            assert _struct_tree(tb) == _struct_tree(rb)
            assert shapes.batch_shardings(tb, mesh) == {
                k: tuple(v.spec) for k, v in
                r_shapes.batch_shardings(rb, rmesh).items()}
        assert tuple(x.shape for x in shapes.decode_token_structs(
            cfg, shape)) == tuple(x.shape for x in
                                  r_shapes.decode_token_structs(rcfg, shape))
    rc = r_shapes.cache_structs(rmodel, 128, 4096)
    tc = shapes.cache_structs(model, 128, 4096)
    assert _struct_tree(tc) == _struct_tree(rc)
    assert all(x.device.type == "meta" for _, x in tree_items(tc))
    r_specs = jax.tree_util.tree_flatten_with_path(
        r_shapes.cache_shardings(rc, rmesh),
        is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert _spec_items(shapes.cache_shardings(tc, mesh)) == {
        tuple(str(k.key) for k in p): tuple(ns.spec) for p, ns in r_specs}
    # the step builders' abstract arguments
    _, (p_struct, o_struct, b_struct) = steps.make_train_step(
        model, None, "train_4k")
    r_p = r_abstract_params(rmodel.specs(), jnp.bfloat16)
    assert _struct_tree(p_struct) == _struct_tree(r_p)
    assert _struct_tree(o_struct["mu"]) == {
        p: (s, "float32") for p, (s, _) in _struct_tree(r_p).items()}
    assert tuple(o_struct["step"].shape) == () and \
        o_struct["step"].dtype == torch.int32
    _, (_, c_struct, tok, pos) = steps.make_decode_step(model, None,
                                                        "decode_32k")
    assert _struct_tree(c_struct) == _struct_tree(
        r_shapes.cache_structs(rmodel, 128, 32768))
    assert tuple(tok.shape) == (128, 1) and tuple(pos.shape) == ()
