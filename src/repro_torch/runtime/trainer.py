"""Training runtime: a restartable loop with failure injection, a
straggler watchdog, asynchronous checkpoints and restore onto any mesh.

The port of :mod:`repro.runtime.trainer`.  The loop is the unit of fault
tolerance: any crash (the injected :class:`SimulatedFailure` included)
loses at most ``ckpt_every`` steps, and :meth:`Trainer.run` resumes from
the newest published checkpoint, which holds every leaf whole on the
host (the reference's on-disk format), so it restores onto another
device or data-parallel width.

A step is the reference's: the loss and its gradients with respect to
the parameter tree (:func:`repro_torch.optim.value_and_grad` on
``Model.loss(batch, params=...)``), optionally the int8 wire error of
``compress_tree`` (a CPU generator seeded by the step where the
reference takes ``jax.random.key(step)``), then AdamW with the cosine
schedule, the parameters and moments updated in place.

**Mesh.** ``None``, or a mesh with axes ``("data", "model")``.  On a
data axis of size D > 1 the trainer is data-parallel, one process per
rank: each rank takes its rows of the global batch (``shard_batch``),
the gradients and the loss are averaged over the data group, and with
``zero1`` the AdamW moments are sharded as ``zero1_shardings`` says --
each rank updates its slice of a leaf and the new parameter is
all-gathered (a leaf with no dimension the axis divides is updated whole
on every rank).  Checkpoints gather the moments and rank 0 writes them.
The reference's MoE ``grouped`` dispatch forms one capacity group per
data rank; a rank's local batch, routed as one group, is that same
computation (as long as a group holds at least 8 tokens, below which the
reference falls back to one global group).  A ``model`` axis larger
than 1 (tensor parallelism) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.store import AsyncCheckpointer, restore_checkpoint
from ..data.pipeline import shard_batch
from ..data.synthetic import TokenStream
from ..models import Model
from ..optim.adamw import (AdamWConfig, Zero1, adamw_abstract, adamw_init,
                           adamw_update, cosine_schedule, value_and_grad,
                           zero1_shardings)
from ..optim.compress import compress_tree
from ..parallel.sharding import (abstract_params, activate_mesh,
                                 data_parallel, init_params,
                                 param_shardings)
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainerConfig", "Trainer", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests the checkpoint/restart path)."""


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 8
    seq_len: int = 64
    steps: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 5
    keep: int = 3
    lr: float = 1e-3
    warmup: int = 10
    seed: int = 0
    grad_compress: bool = False
    zero1: bool = True
    straggler_factor: float = 5.0   # step slower than factor x median => flag
    fail_at_step: Optional[int] = None   # failure injection
    log_every: int = 5
    param_dtype: Any = torch.float32
    device: str = "cuda"


class Trainer:
    def __init__(self, model_cfg, cfg: TrainerConfig, mesh=None):
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {cfg.device}: no CUDA device is "
                               f"available (device='cpu' trains on the "
                               f"CPU)")
        self.model = Model(model_cfg)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.checkpointer = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
        self.straggler_events = []
        self.metrics_log = []

        specs = self.model.specs()
        self._specs = specs
        self._abstract = abstract_params(specs, cfg.param_dtype)
        self.group, self.rank, self.world = data_parallel(mesh)
        self.zero: Optional[Zero1] = None
        if mesh is not None:
            self.p_shard = param_shardings(specs, mesh)
            self.opt_shard = {
                "mu": zero1_shardings(self.p_shard, self._abstract, mesh),
                "nu": zero1_shardings(self.p_shard, self._abstract, mesh),
                "step": None}
            if self.group is not None and cfg.zero1:
                dims = tree_leaves(tree_map(
                    lambda _a, spec: (spec.index("data") if "data" in spec
                                      else -1),
                    self._abstract, self.opt_shard["mu"]))
                self.zero = Zero1([d if d >= 0 else None for d in dims],
                                  self.group, self.rank, self.world)
        else:
            self.p_shard = None
            self.opt_shard = None

        self._opt_cfg = AdamWConfig(lr=cfg.lr)
        self._schedule = cosine_schedule(cfg.lr, cfg.warmup, cfg.steps)

    # ------------------------------------------------------------------
    def _train_step(self, params, opt, batch, step: int):
        (loss, grads) = value_and_grad(
            lambda p: self.model.loss(batch, params=p)[0], params)
        if self.group is not None:           # the mean over the data axis
            for x in tree_leaves(grads) + [loss]:
                dist.all_reduce(x, group=self.group)
                x.div_(self.world)
        if self.cfg.grad_compress:
            grads = compress_tree(grads, torch.Generator().manual_seed(step))
        params, opt, metrics = adamw_update(params, grads, opt,
                                            self._opt_cfg, self._schedule,
                                            zero1=self.zero)
        metrics["loss"] = loss
        return params, opt, metrics

    def _local_moments(self, moments):
        """This rank's ZeRO-1 slices of whole moment leaves."""
        if self.zero is None:
            return moments
        return tree_unflatten(moments, [
            self.zero.local(m, d).clone()
            for m, d in zip(tree_leaves(moments), self.zero.dims)])

    def _whole_moments(self, moments):
        """The whole moment leaves from every rank's slices."""
        if self.zero is None:
            return moments
        return tree_unflatten(moments, [
            self.zero.gather(m, d)
            for m, d in zip(tree_leaves(moments), self.zero.dims)])

    def init_state(self):
        """Parameters from ``seed`` on the trainer's device, zero moments
        (this rank's slices under ZeRO-1) and step 0."""
        params = init_params(self._specs, self.cfg.seed,
                             self.cfg.param_dtype, self.device)
        opt = adamw_init(params)
        opt["mu"] = self._local_moments(opt["mu"])
        opt["nu"] = self._local_moments(opt["nu"])
        return params, opt

    def restore(self):
        tree, step, extra = restore_checkpoint(
            self.cfg.ckpt_dir,
            {"params": self._abstract, "opt": adamw_abstract(self._abstract)},
            device=self.device)
        if tree is None:
            return None
        opt = tree["opt"]
        opt["mu"] = self._local_moments(opt["mu"])
        opt["nu"] = self._local_moments(opt["nu"])
        return tree["params"], opt, step

    def _save(self, step: int, params, opt, extra=None) -> None:
        opt = dict(opt, mu=self._whole_moments(opt["mu"]),
                   nu=self._whole_moments(opt["nu"]))
        if self.rank == 0:
            self.checkpointer.save(step, {"params": params, "opt": opt},
                                   extra=extra)

    # ------------------------------------------------------------------
    def run(self, resume: bool = True) -> Dict[str, Any]:
        cfg = self.cfg
        restored = self.restore() if resume else None
        if restored is not None:
            params, opt, start_step = restored
            start_step = int(start_step)
        else:
            params, opt = self.init_state()
            start_step = 0

        stream = TokenStream(self.model_cfg.vocab_size, cfg.seq_len,
                             cfg.batch_size, seed=cfg.seed)
        durations = []
        loss = None
        with activate_mesh(self.mesh):
            for step in range(start_step, cfg.steps):
                if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure at {step}")
                t0 = time.perf_counter()
                batch = shard_batch(stream.batch(step), self.mesh,
                                    self.device)
                params, opt, metrics = self._train_step(params, opt, batch,
                                                        step)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                durations.append(dt)
                med = float(np.median(durations))
                if len(durations) > 3 and dt > cfg.straggler_factor * med:
                    self.straggler_events.append(
                        {"step": step, "sec": dt, "median": med})
                if step % cfg.log_every == 0:
                    self.metrics_log.append(
                        {"step": step, "loss": loss, "sec": dt,
                         "grad_norm": float(metrics["grad_norm"])})
                if (step + 1) % cfg.ckpt_every == 0:
                    self._save(step + 1, params, opt, extra={"loss": loss})
            self._save(cfg.steps, params, opt)
            self.checkpointer.wait()
            if self.group is not None:   # rank 0's write is published
                dist.barrier(group=self.group)
        return {"params": params, "opt": opt, "last_loss": loss,
                "log": self.metrics_log,
                "stragglers": self.straggler_events,
                "checkpoint": dict(self.checkpointer.last_save)}
