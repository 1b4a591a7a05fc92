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

**Mesh.**  ``None``, or a mesh with axes ``("data", "model")`` (a
``pod`` axis is folded into ``data``), one process per rank.  Each rank
holds its shard of every parameter (``param_shardings``: heads, FFN,
vocabulary, experts and recurrent width split over ``model``;
:func:`~repro_torch.parallel.sharding.shard_leaf`) and its rows of the
global batch (``shard_batch``); the layers split their work over the
model group (:mod:`repro_torch.parallel.tensor`), the gradients and the
loss are averaged over the data group, and AdamW runs on the local
shards with the clipping norm taken over the model group.  With
``zero1`` the AdamW moments are sharded over ``data`` as
``zero1_shardings`` says -- each rank updates its slice of its shard
and the new parameter is all-gathered over ``data`` (a leaf with no
dimension the axis divides is updated whole on every data rank).
Checkpoints put every leaf back together whole on the host (the
reference's on-disk format) and the mesh's first rank writes them; the
initialisation and a restore cut each leaf for this rank as it is drawn
or read (at most one whole leaf at a time), so a checkpoint restores onto
any mesh, onto no mesh, and into the reference.  The reference's MoE
``grouped`` dispatch forms one capacity group per data rank; a rank's
local batch, routed as one group, is that same computation (as long as
a group holds at least 8 tokens, below which the reference falls back
to one global group).  With ``grad_compress`` each rank compresses its
own shards, so under tensor parallelism the draws differ from one
process's.
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
                           adamw_update, cosine_schedule, model_shards,
                           value_and_grad, zero1_shardings)
from ..optim.compress import compress_tree
from ..parallel.sharding import (abstract_params, activate_mesh,
                                 gather_params, init_params, mesh_groups,
                                 param_shardings, shard_leaf)
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten

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
        groups = mesh_groups(mesh)
        data = groups.data
        self.group, self.rank, self.world = data.group, data.rank, data.size
        self.tp = groups.model if groups.model.size > 1 else None
        self.zero: Optional[Zero1] = None
        self._shards = None
        if mesh is not None:
            self.p_shard = param_shardings(specs, mesh)
            self._shards = model_shards(self.p_shard, self.tp)
            self.opt_shard = {
                "mu": zero1_shardings(self.p_shard, self._abstract, mesh),
                "nu": zero1_shardings(self.p_shard, self._abstract, mesh),
                "step": None}
            if groups.zero.size > 1 and cfg.zero1:
                dims = tree_leaves(tree_map(
                    lambda _a, spec: (spec.index("data") if "data" in spec
                                      else -1),
                    self._abstract, self.opt_shard["mu"]))
                self.zero = Zero1([d if d >= 0 else None for d in dims],
                                  groups.zero.group, groups.zero.rank,
                                  groups.zero.size)
                self._zero_dim = {path: d for (path, _), d in zip(
                    tree_items(self._abstract), self.zero.dims)}
        else:
            self.p_shard = None
            self.opt_shard = None
        self._writer = self.rank == 0 and groups.model.rank == 0

        self._opt_cfg = AdamWConfig(lr=cfg.lr)
        self._schedule = cosine_schedule(cfg.lr, cfg.warmup, cfg.steps)

    # ------------------------------------------------------------------
    def _train_step(self, params, opt, batch, step: int):
        (loss, grads) = value_and_grad(
            lambda p: self.model.loss(batch, params=p, tp=self.tp)[0],
            params)
        if self.group is not None:           # the mean over the data axis
            for x in tree_leaves(grads) + [loss]:
                dist.all_reduce(x, group=self.group)
                x.div_(self.world)
        if self.cfg.grad_compress:
            grads = compress_tree(grads, torch.Generator().manual_seed(step))
        params, opt, metrics = adamw_update(params, grads, opt,
                                            self._opt_cfg, self._schedule,
                                            zero1=self.zero,
                                            shards=self._shards)
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

    def _place(self, path, leaf):
        """A whole leaf as this rank holds it, its own tensor on the
        trainer's device: a parameter's shard, or a moment's shard and
        ZeRO-1 slice (``path`` as the checkpoint's tree gives it)."""
        if self.mesh is None or path == ("opt", "step"):
            return leaf.to(self.device)
        moment = path[0] == "opt"
        rest = path[2:] if moment else path[1:]
        spec = self.p_shard
        for k in rest:
            spec = spec[k]
        part = shard_leaf(leaf, spec, self.mesh)
        if moment and self.zero is not None:
            part = self.zero.local(part, self._zero_dim[rest])
        return part.to(self.device, copy=True).contiguous()

    def _whole_tree(self, tree):
        """The whole leaves of a tree of this rank's shards, on the host."""
        if self.mesh is None:
            return tree
        return gather_params(tree, self.p_shard, self.mesh)

    def init_state(self):
        """Parameters from ``seed`` (this rank's shards of the whole
        initialisation, each cut as it is drawn) on the trainer's device,
        zero moments (this rank's slices under ZeRO-1) and step 0."""
        params = init_params(self._specs, self.cfg.seed,
                             self.cfg.param_dtype, self.device,
                             mesh=self.mesh)
        opt = adamw_init(params)
        opt["mu"] = self._local_moments(opt["mu"])
        opt["nu"] = self._local_moments(opt["nu"])
        return params, opt

    def restore(self):
        """The newest checkpoint's state, each leaf cut to this rank's
        part as it is read (:meth:`_place`), or None."""
        tree, step, extra = restore_checkpoint(
            self.cfg.ckpt_dir,
            {"params": self._abstract, "opt": adamw_abstract(self._abstract)},
            place=self._place)
        if tree is None:
            return None
        return tree["params"], tree["opt"], step

    def _save(self, step: int, params, opt, extra=None) -> None:
        opt = dict(opt, mu=self._whole_tree(self._whole_moments(opt["mu"])),
                   nu=self._whole_tree(self._whole_moments(opt["nu"])))
        params = self._whole_tree(params)
        if self._writer:
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
            if self.mesh is not None and dist.is_initialized():
                dist.barrier()           # the first rank's write is published
        return {"params": params, "opt": opt, "last_loss": loss,
                "log": self.metrics_log,
                "stragglers": self.straggler_events,
                "checkpoint": dict(self.checkpointer.last_save)}
