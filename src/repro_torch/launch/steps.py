"""Step builders: train / prefill / decode steps and their abstract inputs.

The port of :mod:`repro.launch.steps`.  Each builder returns ``(fn,
arg_structs)``: ``fn`` runs on real tensors of any batch (the shape name
sizes only the structs), and the structs are ``device="meta"`` tensors
of the shape's sizes and the reference's dtypes.

The reference jits each step with its shardings and donates the train
step's parameters and moments; the port's train step updates them in
place instead.  On a mesh whose data axis has size D > 1 each rank calls
the train step on its rows and the gradients, loss and loss parts are
averaged over the data group; the moments stay whole on every rank
(ZeRO-1 slicing is :class:`repro_torch.runtime.Trainer`'s).  A mesh axis
other than ``data`` with size > 1 raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import Model
from ..optim.adamw import (AdamWConfig, adamw_abstract, adamw_update,
                           cosine_schedule, value_and_grad)
from ..parallel.sharding import abstract_params, data_parallel
from ..tree import tree_leaves
from . import shapes as shp

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model: Model, mesh, shape: str, lr: float = 3e-4,
                    total_steps: int = 10000, param_dtype=torch.bfloat16):
    """``train_step(params, opt, batch) -> (params, opt, metrics)`` with
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``; AdamW at ``lr``
    with 100 warmup steps of a cosine over ``total_steps``."""
    cfg = model.cfg
    group, _, world = data_parallel(mesh)
    p_struct = abstract_params(model.specs(), param_dtype)
    o_struct = adamw_abstract(p_struct)
    b_struct = shp.batch_structs(cfg, shape, with_labels=True)

    opt_cfg = AdamWConfig(lr=lr)
    sched = cosine_schedule(lr, 100, total_steps)

    def train_step(params, opt, batch):
        (loss, parts), grads = value_and_grad(
            lambda p: model.loss(batch, params=p), params, has_aux=True)
        parts = {k: v.detach() for k, v in parts.items()}
        if group is not None:
            for x in tree_leaves(grads) + [loss, *parts.values()]:
                dist.all_reduce(x, group=group)
                x.div_(world)
        params, opt, metrics = adamw_update(params, grads, opt, opt_cfg,
                                            sched)
        metrics.update(loss=loss, **parts)
        return params, opt, metrics

    return train_step, (p_struct, o_struct, b_struct)


def make_prefill_step(model: Model, mesh, shape: str,
                      param_dtype=torch.bfloat16):
    """``prefill(params, batch) -> (last logits, cache)``."""
    data_parallel(mesh)                  # raises on a model axis > 1
    p_struct = abstract_params(model.specs(), param_dtype)
    b_struct = shp.batch_structs(model.cfg, shape, with_labels=False)

    def prefill(params, b):
        return model.prefill(b, params=params)

    return prefill, (p_struct, b_struct)


def make_decode_step(model: Model, mesh, shape: str,
                     param_dtype=torch.bfloat16):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``, the
    cache updated in place (the reference donates it)."""
    data_parallel(mesh)                  # raises on a model axis > 1
    p_struct = abstract_params(model.specs(), param_dtype)
    seq = shp.SHAPES[shape]["seq"]
    batch = shp.SHAPES[shape]["batch"]
    c_struct = shp.cache_structs(model, batch, seq)
    tok_struct, pos_struct = shp.decode_token_structs(model.cfg, shape)

    def decode(params, cache, tokens, pos):
        return model.decode_step(cache, tokens, pos, params=params)

    return decode, (p_struct, c_struct, tok_struct, pos_struct)
