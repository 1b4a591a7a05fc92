"""Tensor parallelism over the mesh's ``model`` axis
(``repro_torch.parallel.tensor`` and the layers' splits) against the
reference.

* Counts (a ``fake`` world of 8, nothing computed): a (2, 4) tinyllama
  smoke train step dispatches no collective but ``all_reduce``, 43 of
  them (derived in ``test_train_step_dispatches_only_all_reduce``).
* Placement: ``shard_params`` cuts each leaf as ``param_shardings`` says
  and the pieces make the whole again; ``init_params`` on a mesh and a
  ``Trainer``'s restore cut each leaf as it is drawn or read, to what
  cutting the whole tree gives; a rank's cache structs from
  ``launch.shapes.tp_cache_shardings`` are ``Model.init_cache``'s on
  every architecture.
* ``slow``, spawned gloo ranks (each spawn under a wall-clock limit):
  (1, 4) over all ten smoke architectures against the reference's
  single-device ``make_train_step``: the loss and every whole gradient
  leaf (gathered) at the first step, the losses of 2 AdamW steps and
  every parameter after them, then prefill and 2 decode steps' logits;
  (2, 2) for tinyllama and the MoE against the reference on its own
  forced-host (2, 2) mesh (the reference's ``grouped`` MoE forms one
  capacity group per data rank there, as the port's data ranks do);
  and ``launch.train --mesh local`` on 4 ranks, whose checkpoint
  restores on a (1, 1) mesh, on no mesh and into the reference, and the
  reference's checkpoint resumed on a (1, 2) mesh.

Tolerances: the losses within ``LOSS_REL`` (1e-5) relative, gradients
and parameters within ``GRAD_REL`` (1e-4) of each leaf's peak (float32
summation orders differ: the reduction over ranks is one more), logits
within 1e-4 (prefill) and 2e-3 (decode) of their peak, the bounds of
``tests/test_torch_lm_model.py``.
"""
import os
import shutil
import socket
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import shapes
from repro_torch.launch.hlo_cost import analyze_step
from repro_torch.launch.steps import make_train_step, model_axis
from repro_torch.models import Model
from repro_torch.parallel.sharding import (AbstractMesh, abstract_params,
                                           init_params, param_shardings,
                                           shard_params)
from repro_torch.tree import tree_items

from _torch_spawn import spawn_with_deadline

LOSS_REL = 1e-5
GRAD_REL = 1e-4
PREFILL_REL = 1e-4
DECODE_REL = 2e-3
B, S, GEN = 2, 16, 2
SPAWN_TIMEOUT_S = 240


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized(), "a process group was left open"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_train_step_dispatches_only_all_reduce(fake_world):
    """tinyllama smoke (2 layers, 4 q heads, 2 kv heads of 16, d_ff 128,
    vocabulary 256) on a (2, 4) mesh, ``remat="full"``.  Per layer: the
    forward's 4 (``wk`` and ``wv`` gathered -- 2 kv heads do not split
    over 4 ranks -- and the attention's and the MLP's row-parallel
    sums), the backward's 4 (the sums of the gradients entering the
    attention and the MLP, and of the gathered ``wk`` / ``wv``), and the
    full remat's recompute of 3 (the forward up to the last tensor the
    backward needs: the MLP's sum is not recomputed).  Per step: the
    vocabulary-parallel embedding's sum, the unembedding's gradient sum,
    the cross entropy's max, sum of exponentials and target logit, the
    clipping norm's sum of squares, and over ``data`` the 12 gradient
    leaves, the loss, ce and aux: 2 x 11 + 6 + 15 = 43."""
    cfg = get_smoke_config("tinyllama_1_1b")
    assert cfg.remat == "full" and cfg.num_layers == 2
    model = Model(cfg)
    step, structs = make_train_step(model, fake_world, "train_4k",
                                    param_dtype=torch.float32)
    assert tuple(structs[2]["tokens"].shape) == (128, 4096)
    assert tuple(structs[0]["embed"]["embedding"].shape) == (64, 64)
    # the count does not depend on the rows or the sequence: a short one
    batch = {k: torch.empty((4, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    got = analyze_step(step, *structs[:2], batch)["collectives"]
    assert got["count"] == 2 * (4 + 4 + 3) + 6 + 15
    assert got["all-reduce"] == got["total"] > 0


def test_model_axis_needs_a_process_group():
    """A model axis on a mesh with no process group raises, naming it."""
    with pytest.raises(ValueError, match="model axis 4"):
        model_axis(AbstractMesh((2, 4), ("data", "model")))
    assert model_axis(AbstractMesh((1, 1), ("data", "model"))) is None
    assert model_axis(None) is None


def test_shard_params_cut_each_leaf_by_its_spec():
    """Each rank's shards along the spec's dimension make the whole leaf
    again, in rank order (an AbstractMesh placed by hand)."""
    model = Model(get_smoke_config("qwen3_moe_235b_a22b"))
    mesh = AbstractMesh((1, 4), ("data", "model"))
    specs = param_shardings(model.specs(), mesh)
    whole = {p: torch.randn(t.shape) for p, t in tree_items(
        abstract_params(model.specs(), torch.float32))}

    def tree(flat):
        out = {}
        for path, t in flat.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return out

    parts = [dict(tree_items(shard_params(tree(whole), specs, mesh,
                                          coords={"model": m})))
             for m in range(4)]
    flat_specs = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat_specs[path] = t
    walk(specs)
    split = 0
    for path, w in whole.items():
        spec = flat_specs[path]
        if "model" in spec:
            dim = spec.index("model")
            split += 1
            assert torch.equal(torch.cat([p[path] for p in parts], dim), w)
        else:
            assert all(p[path] is w for p in parts), path
    assert split > 0


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_moe_235b_a22b"])
def test_init_params_cuts_each_leaf_as_it_is_drawn(arch):
    """With a mesh, ``init_params`` gives this rank's shards of the whole
    initialisation, each its own storage (no whole leaf kept alive)."""
    model = Model(get_smoke_config(arch))
    mesh = AbstractMesh((1, 4), ("data", "model"))
    whole = init_params(model.specs(), 5, torch.float32, "cpu")
    want = shard_params(whole, param_shardings(model.specs(), mesh), mesh)
    got = init_params(model.specs(), 5, torch.float32, "cpu", mesh=mesh)
    split = 0
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(g, w), path
        assert g.is_contiguous(), path
        assert g.untyped_storage().nbytes() == g.numel() * g.element_size()
        split += g.numel() < dict(tree_items(whole))[path].numel()
    assert split > 0


def test_trainer_restore_cuts_each_leaf_as_it_is_read(fake_world, tmp_path):
    """A ``Trainer`` on a (2, 4) mesh restores a checkpoint of whole
    leaves as this rank's shards, the moments also sliced for ZeRO-1 over
    ``data``: what cutting the whole restored tree gives."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_smoke_config("tinyllama_1_1b")
    tr = Trainer(cfg, TrainerConfig(device="cpu", ckpt_dir=str(tmp_path)),
                 mesh=fake_world)
    assert tr.zero is not None
    whole = init_params(tr.model.specs(), 2, torch.float32, "cpu")
    opt = adamw_init(whole)
    gen = torch.Generator().manual_seed(0)
    for _, t in tree_items({"mu": opt["mu"], "nu": opt["nu"]}):
        t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"].fill_(3)
    save_checkpoint(str(tmp_path), 3, {"params": whole, "opt": opt})
    params, got, step = tr.restore()
    assert step == 3 and int(got["step"]) == 3
    specs = param_shardings(tr.model.specs(), fake_world)
    want = {"params": shard_params(whole, specs, fake_world),
            "mu": tr._local_moments(shard_params(opt["mu"], specs,
                                                 fake_world)),
            "nu": tr._local_moments(shard_params(opt["nu"], specs,
                                                 fake_world))}
    for name, tree in (("params", params), ("mu", got["mu"]),
                       ("nu", got["nu"])):
        for (path, g), (_, w) in zip(tree_items(tree),
                                     tree_items(want[name])):
            assert torch.equal(g, w), (name, path)
            assert g.is_contiguous(), (name, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_cache_structs_are_init_cache(fake_world, arch):
    """The rank's cache from ``tp_cache_shardings`` (batch 8 over 2 data
    ranks, kv heads / channels over 4 model ranks) is the cache
    ``Model.init_cache`` makes on the same model axis."""
    model = Model(get_smoke_config(arch))
    tp = model_axis(fake_world)
    want = shapes.rank_cache_structs(model, 8, 64, fake_world)
    got = model.init_cache(4, 64, dtype=torch.bfloat16, device="meta",
                           tp=tp)
    assert {p: (tuple(t.shape), t.dtype) for p, t in tree_items(got)} == \
        {p: (tuple(t.shape), t.dtype) for p, t in tree_items(want)}


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------
def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, nprocs: int, *args):
    """``fn(rank, nprocs, port, *args)`` on ``nprocs`` ranks under
    SPAWN_TIMEOUT_S; a rank's exception fails the test."""
    spawn_with_deadline(fn, nprocs, (nprocs, _port()) + args,
                        SPAWN_TIMEOUT_S)


def _open(rank, world, port, shape):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _inputs(cfg, b, seed=11):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, S + GEN))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, S + GEN))
             .astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["patch_embed"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["audio_embed"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _train_batch(batch):
    return {k: (v[:, :S] if k in ("tokens", "labels") else v)
            for k, v in batch.items()}


def _prompt(batch):
    return {k: (v[:, :S] if k == "tokens" else v)
            for k, v in batch.items() if k != "labels"}


def _leaf_rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def _check_tree(label, got, want, rel):
    want = dict(want)
    for path, g in tree_items(got):
        assert _leaf_rel(g.numpy(), want[path]) <= rel, (label, path)


def _reference_mesh(shape):
    """A ``(data, model)`` mesh of the reference whose axes GSPMD places
    (``Auto``: its ``shard_act`` constraints need them)."""
    import jax
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _reference(arch, rmesh, b):
    """The reference on its float32 weights: the loss and gradients at
    the first step, two ``make_train_step`` steps (losses, parameters),
    then prefill of S tokens and GEN decode steps (logits)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as r_get_smoke_config
    from repro.launch import steps as r_steps
    from repro.models import Model as RModel
    from repro.optim import adamw_init as r_adamw_init
    from repro.parallel.sharding import activate_mesh as r_activate_mesh
    from repro.parallel.sharding import init_params as r_init_params

    with r_activate_mesh(rmesh):     # MoE groups: one per data rank
        return _reference_on(arch, rmesh, b, RModel, r_get_smoke_config,
                             r_steps, r_adamw_init, r_init_params)


def _reference_on(arch, rmesh, b, RModel, r_get_smoke_config, r_steps,
                  r_adamw_init, r_init_params):
    import jax
    import jax.numpy as jnp
    rm = RModel(r_get_smoke_config(arch))
    fn, _ = r_steps.make_train_step(rm, rmesh, "train_4k", lr=1e-2,
                                    param_dtype=jnp.float32)
    rp = jax.jit(lambda k: r_init_params(rm.specs(), k, jnp.float32))(
        jax.random.key(3))
    np_p = jax.tree.map(np.asarray, rp)
    batch = _inputs(rm.cfg, b)
    jb = {k: jnp.asarray(v) for k, v in _train_batch(batch).items()}

    def serve(p):
        pb = {k: jnp.asarray(v) for k, v in _prompt(batch).items()}
        last, cache = rm.prefill(p, pb, max_len=S + GEN)
        logits = [last]
        for i in range(GEN):
            tok = jnp.asarray(batch["tokens"][:, S + i:S + i + 1])
            out, cache = rm.decode_step(p, cache, tok, jnp.int32(S + i))
            logits.append(out)
        return logits

    served = jax.tree.map(np.asarray, jax.jit(serve)(rp))
    opt = r_adamw_init(rp)
    losses, mets = [], []
    flat = lambda t: dict(tree_items(jax.tree.map(np.asarray, t)))  # noqa
    for i in range(2):
        # host copies in, as at the first call (no second compile)
        rp, opt = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                               (rp, opt))
        rp, opt, met = fn(rp, opt, jb)
        losses.append(float(met["loss"]))
        if i == 0:
            # the first step's gradients from its first moment: mu is
            # (1 - b1) times the gradient clipped to a global norm of 1
            scale = (1 - 0.9) * min(1.0, 1.0 / max(float(met["grad_norm"]),
                                                   1e-9))
            grads = {p: m / scale for p, m in flat(opt["mu"]).items()}
    return {"params": np_p, "batch": batch, "loss0": losses[0],
            "grads": grads, "losses": losses, "after": flat(rp),
            "served": served}


def _port_run(mesh, arch, want):
    """The port's rank on ``mesh``: the same checks as ``_reference``."""
    from repro_torch.data import shard_batch
    from repro_torch.launch import steps
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim import adamw_init, value_and_grad
    from repro_torch.parallel.sharding import gather_params

    cfg = get_smoke_config(arch)
    model = Model(cfg)
    specs = param_shardings(model.specs(), mesh)
    tp = model_axis(mesh)
    params = params_from_reference(model, want["params"], device="cpu",
                                   mesh=mesh)
    serve_params = {p: t.clone() for p, t in tree_items(params)}
    batch = shard_batch(want["batch"], mesh, "cpu")
    tb = _train_batch(batch)
    loss0, grads = value_and_grad(
        lambda p: model.loss(tb, params=p, tp=tp)[0], params)
    data = mesh["data"]
    if data.size() > 1:                     # the mean over the data group
        for g in [loss0] + [t for _, t in tree_items(grads)]:
            dist.all_reduce(g, group=data.get_group())
            g.div_(data.size())
    assert abs(float(loss0) - want["loss0"]) <= LOSS_REL * abs(
        want["loss0"]), (arch, float(loss0), want["loss0"])
    _check_tree(f"{arch} grads", gather_params(grads, specs, mesh),
                want["grads"], GRAD_REL)

    fn, _ = steps.make_train_step(model, mesh, "train_4k", lr=1e-2,
                                  param_dtype=torch.float32)
    opt = adamw_init(params)
    for i in range(2):
        params, opt, met = fn(params, opt, tb)
        assert abs(float(met["loss"]) - want["losses"][i]) <= \
            LOSS_REL * abs(want["losses"][i]), (arch, i)
    _check_tree(f"{arch} params", gather_params(params, specs, mesh),
                want["after"], GRAD_REL)

    from repro_torch.tree import tree_unflatten
    sp = tree_unflatten(params, [serve_params[p] for p, _ in
                                 tree_items(params)])
    last, cache = model.prefill(_prompt(batch), max_len=S + GEN, params=sp,
                                tp=tp)
    rows = slice(0, last.shape[0])
    if data.size() > 1:
        n = last.shape[0]
        rows = slice(data.get_local_rank() * n,
                     (data.get_local_rank() + 1) * n)
    assert _leaf_rel(last.numpy(), want["served"][0][rows]) <= PREFILL_REL
    for i in range(GEN):
        tok = batch["tokens"][:, S + i:S + i + 1]
        out, cache = model.decode_step(cache, tok, S + i, params=sp, tp=tp)
        assert _leaf_rel(out.numpy(), want["served"][i + 1][rows]) <= \
            DECODE_REL, (arch, i)


def _tp_worker(rank, world, port, shape, wants):
    mesh = _open(rank, world, port, shape)
    try:
        for arch, want in wants.items():
            _port_run(mesh, arch, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_ten_archs_on_four_model_ranks_match_the_reference():
    rmesh = _reference_mesh((1, 1))
    wants = {arch: _reference(arch, rmesh, B) for arch in ARCH_IDS}
    _spawn(_tp_worker, 4, (1, 4), wants)


_REF_2X2 = textwrap.dedent("""
    import pickle, sys
    sys.path.insert(0, {tests!r})
    from test_torch_tensor_parallel import _reference, _reference_mesh
    rmesh = _reference_mesh((2, 2))
    out = {{a: _reference(a, rmesh, 4) for a in {archs!r}}}
    with open({path!r}, "wb") as f:
        pickle.dump(out, f)
""")


@pytest.mark.slow
def test_two_by_two_matches_the_reference_mesh(tmp_path, subproc):
    """(2, 2): the data ranks' rows and the reference's per-data-rank MoE
    capacity groups, against the reference on its own (2, 2) mesh."""
    import pickle
    archs = ["tinyllama_1_1b", "qwen3_moe_235b_a22b"]
    path = str(tmp_path / "ref.pkl")
    subproc(_REF_2X2.format(tests=os.path.dirname(__file__), archs=archs,
                            path=path), devices=4, timeout=SPAWN_TIMEOUT_S)
    with open(path, "rb") as f:
        wants = pickle.load(f)
    _spawn(_tp_worker, 4, (2, 2), wants)


def _cli_worker(rank, world, port, argv):
    from repro_torch.launch import train
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    train.main(argv)


def _resume_worker(rank, world, port, ckpt_dir, steps):
    from repro_torch.runtime import Trainer, TrainerConfig
    mesh = _open(rank, world, port, (1, world))
    try:
        Trainer(get_smoke_config("tinyllama_1_1b"),
                TrainerConfig(batch_size=2, seq_len=24, steps=steps,
                              ckpt_every=2, log_every=1, device="cpu",
                              ckpt_dir=ckpt_dir), mesh=mesh).run()
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_cli_checkpoint_restores_on_any_mesh(tmp_path):
    import jax
    from repro.checkpoint import restore_checkpoint as r_restore
    from repro.configs import get_smoke_config as r_get_smoke_config
    from repro.runtime import Trainer as RTrainer
    from repro.runtime import TrainerConfig as RTrainerConfig
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch import train
    from repro_torch.runtime import Trainer, TrainerConfig

    d4 = str(tmp_path / "four")
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "4",
            "--batch", "4", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "2", "--ckpt-dir", d4, "--mesh", "local"]
    _spawn(_cli_worker, 4, argv)
    assert latest_step(d4) == 4
    # whole leaves: the same as one process training the same steps
    d1 = str(tmp_path / "one")
    one = train.main(argv[:-4] + ["--ckpt-dir", d1])
    like = {"params": one["params"], "opt": one["opt"]}
    got, step, _ = restore_checkpoint(d4, like)
    assert step == 4
    for (path, g), (_, w) in zip(tree_items(got), tree_items(like)):
        assert g.shape == w.shape, path
        assert _leaf_rel(g.numpy(), w.numpy()) <= GRAD_REL, path
    # it resumes on a (1, 1) mesh and on no mesh alike, ...
    runs = {}
    for name, mesh_arg in (("mesh", "1x1"), ("none", "none")):
        d = str(tmp_path / name)
        shutil.copytree(d4, d)
        runs[name] = train.main(argv[:-4] + ["--ckpt-dir", d, "--steps",
                                             "6", "--mesh", mesh_arg])
        assert [m["step"] for m in runs[name]["log"]] == [5]   # resumed
        assert latest_step(d) == 6
    for (path, a), (_, b) in zip(tree_items(runs["mesh"]["params"]),
                                 tree_items(runs["none"]["params"])):
        assert torch.equal(a, b), path
    # ... and the reference reads it
    r_like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), like)
    r_got, r_step, _ = r_restore(d4, r_like)
    assert int(r_step) == 4
    for (path, g), (_, w) in zip(tree_items(jax.tree.map(np.asarray,
                                                         r_got)),
                                 tree_items(got)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=str(path))
    # the reference's checkpoint resumed on a (1, 2) mesh
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    rkw = dict(batch_size=2, seq_len=24, ckpt_every=2, log_every=1)
    RTrainer(r_get_smoke_config("tinyllama_1_1b"),
             RTrainerConfig(steps=2, ckpt_dir=rd, **rkw)).run()
    shutil.copytree(rd, pd)
    want = RTrainer(r_get_smoke_config("tinyllama_1_1b"),
                    RTrainerConfig(steps=4, ckpt_dir=rd, **rkw)).run()
    _spawn(_resume_worker, 2, pd, 4)
    tr = Trainer(get_smoke_config("tinyllama_1_1b"),
                 TrainerConfig(device="cpu", ckpt_dir=pd))
    params, _, step = tr.restore()
    assert int(step) == 4
    w = {p: np.asarray(v) for p, v in tree_items(want["params"])}
    _check_tree("resumed on (1, 2)", params, w.items(), GRAD_REL)
