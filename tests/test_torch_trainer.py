"""The port's checkpoints and trainer against the reference
(``repro_torch.checkpoint`` / ``runtime`` / ``launch.train`` vs
``repro.checkpoint`` / ``repro.runtime``).

* Checkpoints: one on-disk format.  A checkpoint the reference writes
  (float32, int32 and a bfloat16 leaf) restores in the port bit for
  bit; the port writes the same file names, the same ``.npy`` bytes and
  the same manifest (apart from ``time``) as the reference for one
  tree; atomic publish, ``gc_checkpoints`` and ``AsyncCheckpointer`` as
  the reference's own tests hold them.  A bfloat16 leaf the reference
  cannot read back restores in the port.
* Trainer: the reference trains tinyllama smoke 4 steps; the port
  resumes from its checkpoint to step 8 and the reference from a copy of
  it: the logged losses within 1e-5 relative and every final parameter
  within 1e-5 of its leaf's peak (float32 summation orders differ).
  Failure injection and restart, the loss falling, ``grad_compress``
  training and the CLI on the CPU, as the reference's tests; a 2-rank
  gloo data-parallel run with ZeRO-1 (``slow``, spawned) against the
  one-process run, within 1e-5 of each leaf's peak.
"""
import json
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.runtime import Trainer as RTrainer
from repro.runtime import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint import (AsyncCheckpointer, gc_checkpoints,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.data import Prefetcher, shard_batch
from repro_torch.launch import train
from repro_torch.parallel.sharding import AbstractMesh
from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig
from repro_torch.tree import tree_items

from _torch_spawn import spawn_with_deadline

REL = 1e-5
#: the wall-clock limit of a spawned run: a deadlocked rank fails the test
SPAWN_TIMEOUT_S = 240


def _tree_np():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 3)).astype(np.float32)
    h = np.asarray(jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
                   np.float32)
    return {"w": w, "h": h, "opt": {"step": np.int32(7), "m/x": w * 2}}


def _tree_jax(t):
    return {"w": jnp.asarray(t["w"]), "h": jnp.asarray(t["h"], jnp.bfloat16),
            "opt": {"step": jnp.int32(t["opt"]["step"]),
                    "m/x": jnp.asarray(t["opt"]["m/x"])}}


def _tree_torch(t):
    return {"w": torch.tensor(t["w"]),
            "h": torch.tensor(t["h"]).to(torch.bfloat16),
            "opt": {"step": torch.tensor(t["opt"]["step"]),
                    "m/x": torch.tensor(t["opt"]["m/x"])}}


def test_restores_a_reference_checkpoint(tmp_path):
    t = _tree_np()
    r_save(str(tmp_path), 3, _tree_jax(t), extra={"loss": 1.5})
    got, step, extra = restore_checkpoint(str(tmp_path), _tree_torch(t))
    assert step == 3 and extra == {"loss": 1.5}
    want = _tree_torch(t)
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_restores_a_bf16_leaf_the_reference_cannot(tmp_path):
    """The reference writes ``{"w": bf16 (2, 3)}`` and raises reading it
    back; the port reads it."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    r_save(str(tmp_path), 1, {"w": jnp.asarray(w, jnp.bfloat16)})
    with pytest.raises(TypeError, match="V2"):
        r_restore(str(tmp_path), {"w": 0})
    got, step, _ = restore_checkpoint(str(tmp_path), {"w": 0})
    assert step == 1 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.tensor(w).to(torch.bfloat16))


def test_port_checkpoint_matches_reference_bytes(tmp_path):
    t = _tree_np()
    r_dir = r_save(str(tmp_path / "r"), 12, _tree_jax(t), extra={"a": 1})
    t_dir = save_checkpoint(str(tmp_path / "t"), 12, _tree_torch(t),
                            extra={"a": 1})
    assert os.path.basename(r_dir) == os.path.basename(t_dir)
    assert sorted(os.listdir(r_dir)) == sorted(os.listdir(t_dir))
    for f in os.listdir(r_dir):
        a = open(os.path.join(r_dir, f), "rb").read()
        b = open(os.path.join(t_dir, f), "rb").read()
        if f == "manifest.json":
            a, b = json.loads(a), json.loads(b)
            assert list(a) == list(b)
            a.pop("time"), b.pop("time")
        assert a == b, f
    # the port's writes read back in the reference, bfloat16 aside
    got, _, _ = r_restore(str(tmp_path / "t"),
                          {"w": 0, "opt": {"step": 0, "m/x": 0}})
    np.testing.assert_array_equal(np.asarray(got["w"]), t["w"])
    assert int(got["opt"]["step"]) == 7


def test_checkpoint_atomic_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(d, 7, tree, extra={"loss": 1.5})
    assert latest_step(d) == 7
    got, step, extra = restore_checkpoint(d, tree)
    assert step == 7 and extra["loss"] == 1.5
    assert torch.equal(got["w"], tree["w"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="missing keys"):
        restore_checkpoint(d, {"v": tree["w"]})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, {"w": torch.zeros(3, 2), "opt": tree["opt"]})


def test_checkpoint_gc_and_async(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d, keep=2)
    x = torch.zeros(2)
    for s in [1, 2, 3, 4]:
        x.fill_(s)                 # in place: the save copied it already
        ck.save(s, {"x": x})
        x.fill_(-1)
    ck.wait()
    assert latest_step(d) == 4
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d))
    assert len(steps) == 2 and steps[-1] == 4
    got, _, _ = restore_checkpoint(d, {"x": x})
    assert torch.equal(got["x"], torch.full((2,), 4.0))
    gc_checkpoints(d, keep=1)
    assert os.listdir(d) == ["step_00000004"]


def test_prefetcher_and_shard_batch_without_a_mesh():
    pf = Prefetcher(iter([{"x": np.full((2,), i)} for i in range(5)]),
                    depth=2, transform=lambda b: shard_batch(b, None, "cpu"))
    got = [next(pf)["x"] for _ in range(5)]
    pf.close()
    assert [int(x[0]) for x in got] == list(range(5))
    assert all(isinstance(x, torch.Tensor) for x in got)


def test_restore_missing_returns_none(tmp_path):
    got, step, extra = restore_checkpoint(str(tmp_path / "none"), {"x": 1})
    assert got is None and step is None and extra is None


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
ARCH = "tinyllama_1_1b"


def _cfg(**kw):
    base = dict(batch_size=2, seq_len=24, ckpt_every=2, log_every=1,
                device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / (
        float(np.abs(want).max()) + 1e-30)


def test_port_resumes_the_reference_run(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    rkw = dict(batch_size=2, seq_len=24, ckpt_every=2, log_every=1)
    RTrainer(r_get_smoke_config(ARCH),
             RTrainerConfig(steps=4, ckpt_dir=a, **rkw)).run()
    shutil.copytree(a, b)
    want = RTrainer(r_get_smoke_config(ARCH),
                    RTrainerConfig(steps=8, ckpt_dir=b, **rkw)).run()
    got = Trainer(get_smoke_config(ARCH), _cfg(steps=8, ckpt_dir=a)).run()
    assert [m["step"] for m in got["log"]] == [4, 5, 6, 7]
    assert [m["step"] for m in want["log"]] == [4, 5, 6, 7]
    for g, w in zip(got["log"], want["log"]):
        assert abs(g["loss"] - w["loss"]) <= REL * abs(w["loss"]), (g, w)
    w_leaves = dict(jax.tree_util.tree_flatten_with_path(want["params"])[0])
    w_leaves = {tuple(str(k.key) for k in p): v for p, v in w_leaves.items()}
    for path, g in tree_items(got["params"]):
        assert _rel(g.numpy(), w_leaves[path]) <= REL, path
    assert latest_step(a) == 8 and int(got["opt"]["step"]) == 8


def test_failure_injection_and_restart(tmp_path):
    d = str(tmp_path / "ck")
    mcfg = get_smoke_config(ARCH)
    tr0 = Trainer(mcfg, _cfg(steps=10, ckpt_every=3, ckpt_dir=d,
                             fail_at_step=7, log_every=2))
    with pytest.raises(SimulatedFailure):
        tr0.run()
    tr0.checkpointer.wait()
    survived = latest_step(d)
    assert survived in (3, 6)
    tr = Trainer(mcfg, _cfg(steps=10, ckpt_every=3, ckpt_dir=d,
                            log_every=2))
    out = tr.run()
    assert out["log"][0]["step"] == survived
    assert latest_step(d) == 10
    # the same as a run that never failed
    clean = Trainer(mcfg, _cfg(steps=10, ckpt_every=3, log_every=2,
                               ckpt_dir=str(tmp_path / "clean"))).run()
    for (path, g), (_, w) in zip(tree_items(out["params"]),
                                 tree_items(clean["params"])):
        assert torch.equal(g, w), path


def test_training_reduces_loss(tmp_path):
    cfg = _cfg(steps=30, ckpt_every=100, batch_size=4, seq_len=32, lr=3e-3,
               ckpt_dir=str(tmp_path / "ck"))
    out = Trainer(get_smoke_config("qwen3_0_6b"), cfg).run()
    losses = [m["loss"] for m in out["log"]]
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_compression_trains(tmp_path):
    cfg = _cfg(steps=15, ckpt_every=100, batch_size=4, seq_len=32, lr=3e-3,
               grad_compress=True, ckpt_dir=str(tmp_path / "ck"))
    out = Trainer(get_smoke_config(ARCH), cfg).run()
    losses = [m["loss"] for m in out["log"]]
    assert losses[-1] < losses[0]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "8",
                      "--batch", "2", "--seq", "32", "--device", "cpu",
                      "--ckpt-dir", d])
    assert np.isfinite(out["last_loss"]) and latest_step(d) == 8
    assert "finished 8 steps" in capsys.readouterr().out
    # --mesh local: a (1, 1) mesh over this one rank; the group closed
    d2 = str(tmp_path / "mesh")
    meshed = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                         "8", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--ckpt-dir", d2, "--mesh", "local"])
    assert not torch.distributed.is_initialized()
    for (path, g), (_, w) in zip(tree_items(meshed["params"]),
                                 tree_items(out["params"])):
        assert torch.equal(g, w), path


def test_no_fallback_off_the_training_path(tmp_path):
    """The card asked for and absent raises; a model axis with no process
    group behind it (an ``AbstractMesh``) raises an error that names it."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                        "1", "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(ValueError, match="model axis 2.*no process group"):
        Trainer(get_smoke_config(ARCH), _cfg(ckpt_dir=str(tmp_path)),
                mesh=AbstractMesh((1, 2), ("data", "model")))


def _dp_worker(rank, world, port, ckpt_dir, want):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world, 1),
                                mesh_dim_names=("data", "model"))
        tr = Trainer(get_smoke_config(ARCH),
                     _cfg(steps=4, batch_size=4, seq_len=16,
                          ckpt_dir=ckpt_dir), mesh=mesh)
        assert tr.zero is not None and any(
            d is not None for d in tr.zero.dims)
        # this rank's rows where the data axis divides the batch, else
        # the whole batch (the reference replicates it there)
        rows = np.arange(12).reshape(4, 3)
        got = shard_batch({"x": rows, "odd": rows[:3], "s": np.int32(5)},
                          mesh, "cpu")
        assert np.array_equal(got["x"].numpy(), rows[2 * rank:2 * rank + 2])
        assert np.array_equal(got["odd"].numpy(), rows[:3])
        assert int(got["s"]) == 5
        out = tr.run()
        for g, w in zip(out["log"], want["log"]):
            assert abs(g["loss"] - w) <= REL * abs(w), (g, w)
        for path, g in tree_items(out["params"]):
            assert _rel(g.numpy(), want["params"][path]) <= REL, path
        # the moments: this rank's slices of the one-process moments
        for (path, m), d in zip(tree_items(out["opt"]["mu"]),
                                tr.zero.dims):
            whole = torch.tensor(want["mu"][path])
            if d is not None:
                assert m.shape[d] * world == whole.shape[d]
            part = tr.zero.local(whole, d)
            assert _rel(m.numpy(), part.numpy()) <= REL, path
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_two_gloo_ranks_zero1_match_one_process(tmp_path):
    one = Trainer(get_smoke_config(ARCH),
                  _cfg(steps=4, batch_size=4, seq_len=16,
                       ckpt_dir=str(tmp_path / "one"))).run()
    want = {"log": [m["loss"] for m in one["log"]],
            "params": {p: t.numpy() for p, t in tree_items(one["params"])},
            "mu": {p: t.numpy() for p, t in tree_items(one["opt"]["mu"])}}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dp_dir = str(tmp_path / "dp")
    spawn_with_deadline(_dp_worker, 2, (2, port, dp_dir, want),
                        SPAWN_TIMEOUT_S)
    # rank 0 wrote whole moments: the checkpoint restores in one process
    got, step, _ = restore_checkpoint(
        dp_dir, {"params": one["params"], "opt": one["opt"]})
    assert step == 4
    for (path, g), (_, w) in zip(tree_items(got["opt"]),
                                 tree_items(one["opt"])):
        assert _rel(g.numpy(), w.numpy()) <= REL, path
