"""Step builders: train / prefill / decode steps and their abstract inputs.

The port of :mod:`repro.launch.steps`.  Each builder returns ``(fn,
arg_structs)``: ``fn`` runs on real tensors of any batch (the shape name
sizes only the structs), and the structs are ``device="meta"`` tensors
of the shape's sizes and the reference's dtypes.

The reference jits each step with its shardings over the whole mesh and
donates the train step's parameters and moments.  The port runs one
process per rank: the structs are this rank's (its rows of the batch,
its parameter and cache shards: :mod:`repro_torch.launch.shapes`), and
the step runs on them.  Over the mesh's ``model`` axis the layers split
their work (:mod:`repro_torch.parallel.tensor`); over its data axes
(``pod`` and ``data``) the gradients, loss and loss parts are averaged;
the train step updates the parameters and moments in place, AdamW on the
local shards with the norm taken over the model group.  The moments stay
whole on every data rank (ZeRO-1 slicing is
:class:`repro_torch.runtime.Trainer`'s).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import Model
from ..optim.adamw import (AdamWConfig, adamw_abstract, adamw_update,
                           cosine_schedule, model_shards, value_and_grad)
from ..parallel.sharding import mesh_groups, param_shardings
from ..tree import tree_leaves
from . import shapes as shp

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "model_axis"]


def model_axis(mesh):
    """This rank's ``model`` axis group on ``mesh`` (``None`` without one
    of more than one rank); raises as ``mesh_groups`` does."""
    tp = mesh_groups(mesh).model
    return tp if tp.size > 1 else None


def make_train_step(model: Model, mesh, shape: str, lr: float = 3e-4,
                    total_steps: int = 10000, param_dtype=torch.bfloat16):
    """``train_step(params, opt, batch) -> (params, opt, metrics)`` with
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``; AdamW at ``lr``
    with 100 warmup steps of a cosine over ``total_steps``."""
    cfg = model.cfg
    groups = mesh_groups(mesh)
    group, world = groups.data.group, groups.data.size
    tp = model_axis(mesh)
    shards = model_shards(param_shardings(model.specs(), mesh), tp) \
        if tp is not None else None
    p_struct = shp.param_structs(model, mesh, param_dtype)
    o_struct = adamw_abstract(p_struct)
    b_struct = shp.rank_batch_structs(cfg, shape, True, mesh)

    opt_cfg = AdamWConfig(lr=lr)
    sched = cosine_schedule(lr, 100, total_steps)

    def train_step(params, opt, batch):
        (loss, parts), grads = value_and_grad(
            lambda p: model.loss(batch, params=p, tp=tp), params,
            has_aux=True)
        parts = {k: v.detach() for k, v in parts.items()}
        if group is not None:
            for x in tree_leaves(grads) + [loss, *parts.values()]:
                dist.all_reduce(x, group=group)
                x.div_(world)
        params, opt, metrics = adamw_update(params, grads, opt, opt_cfg,
                                            sched, shards=shards)
        metrics.update(loss=loss, **parts)
        return params, opt, metrics

    return train_step, (p_struct, o_struct, b_struct)


def make_prefill_step(model: Model, mesh, shape: str,
                      param_dtype=torch.bfloat16):
    """``prefill(params, batch) -> (last logits, cache)``: the whole
    logits on every rank, the rank's cache."""
    tp = model_axis(mesh)
    p_struct = shp.param_structs(model, mesh, param_dtype)
    b_struct = shp.rank_batch_structs(model.cfg, shape, False, mesh)

    def prefill(params, b):
        return model.prefill(b, params=params, tp=tp)

    return prefill, (p_struct, b_struct)


def make_decode_step(model: Model, mesh, shape: str,
                     param_dtype=torch.bfloat16):
    """``decode(params, cache, tokens, pos) -> (logits, cache)``, the
    cache updated in place (the reference donates it)."""
    tp = model_axis(mesh)
    p_struct = shp.param_structs(model, mesh, param_dtype)
    seq = shp.SHAPES[shape]["seq"]
    batch = shp.SHAPES[shape]["batch"]
    c_struct = shp.rank_cache_structs(model, batch, seq, mesh)
    tok_struct, pos_struct = shp.decode_token_structs(model.cfg, shape)
    if mesh is not None:
        tok_struct = shp.rank_structs(
            tok_struct, shp.batch_shardings({"t": tok_struct}, mesh)["t"],
            mesh)

    def decode(params, cache, tokens, pos):
        return model.decode_step(cache, tokens, pos, params=params, tp=tp)

    return decode, (p_struct, c_struct, tok_struct, pos_struct)
