"""Assigned input shapes and abstract inputs for every (arch x shape).

The port of :mod:`repro.launch.shapes`.  The stand-ins are
``device="meta"`` tensors (shapes and dtypes, no storage; the
reference's ``ShapeDtypeStruct``s), and a placement is a spec tuple on
a mesh (:mod:`repro_torch.parallel.sharding`).  The reference hands
global structs and their shardings to ``jit``; the port runs one
process per rank, so :func:`rank_structs` (and :func:`param_structs`,
:func:`rank_batch_structs`, :func:`rank_cache_structs`) give one rank's
structs from the same placements.

The cache has two placements.  :func:`cache_shardings` is the
reference's: its ``_CACHE_SPEC`` splits the K/V caches' and MLA's latent
cache's *sequence* dimension over ``model`` (GSPMD then gathers what a
step needs).  The port's tensor parallelism computes each rank's kv
heads, so the cache a rank holds is :func:`tp_cache_shardings`'s:
``k`` / ``v`` split their kv-head dimension, MLA's latent cache, which
every head reads, stays whole, and the recurrent leaves are placed as
the reference places them (the layout ``models/blocks.py:
CACHE_MODEL_DIMS`` gives ``Model.init_cache``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import Model, ModelConfig
from ..models.blocks import CACHE_MODEL_DIMS
from ..parallel.sharding import (abstract_params, local_shape,
                                 param_shardings, prune_pspec)

__all__ = ["SHAPES", "shape_applicable", "batch_structs", "batch_shardings",
           "cache_structs", "cache_shardings", "decode_token_structs",
           "tp_cache_shardings", "rank_structs", "param_structs",
           "rank_batch_structs", "rank_cache_structs"]

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"seq": 4096,   "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768,  "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32768,  "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524288, "batch": 1,   "kind": "decode"},
}

# long_500k needs sub-quadratic sequence mixing: SSM / hybrid only.
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and cfg.family not in _LONG_OK_FAMILIES:
        return False, (f"{cfg.name} is full-attention ({cfg.family}); "
                       "524k-token decode requires sub-quadratic mixing "
                       "(skip noted in DESIGN.md)")
    return True, ""


def _bt(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_structs(cfg: ModelConfig, shape: str, with_labels: bool):
    s = SHAPES[shape]
    b, q = s["batch"], s["seq"]
    out = {"tokens": _meta((b, q), torch.int32)}
    if with_labels:
        out["labels"] = _meta((b, q), torch.int32)
    if cfg.frontend == "patch_stub":
        out["patch_embed"] = _meta((b, cfg.prefix_len, cfg.d_model),
                                   torch.bfloat16)
    if cfg.frontend == "audio_stub":
        out["audio_embed"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
    return out


def _batch_spec(shape, mesh) -> Tuple:
    spec = (_bt(mesh),) + (None,) * (len(shape) - 1)
    return prune_pspec(spec, shape, mesh)


def batch_shardings(structs, mesh):
    """Each input's spec: the batch dimension over the data axes where
    they divide it."""
    return {k: _batch_spec(tuple(v.shape), mesh) for k, v in structs.items()}


def cache_structs(model: Model, batch: int, max_len: int):
    """The decode cache as meta tensors: ``h`` / ``ssm`` float32, the
    others bfloat16, as the reference's ``init_cache`` default."""
    return model.init_cache(batch, max_len, dtype=torch.bfloat16,
                            device="meta")


_CACHE_SPEC = {
    # leaf name -> per-dim mesh-axis candidates (after the batch dim)
    "k": (None, "model", None, None),
    "v": (None, "model", None, None),
    "c_kv": (None, "model", None),
    "k_rope": (None, "model", None),
    "conv": (None, None, "model"),
    "h": (None, "model"),
    "ssm": (None, "model", None, None),
}


#: the port's placement, from the layout the model computes on
#: (``CACHE_MODEL_DIMS``: kv heads, channels, SSM heads over model; a
#: leaf it does not name, MLA's latent cache, whole)
_TP_CACHE_SPEC = {name: tuple("model" if i == CACHE_MODEL_DIMS.get(name)
                              else None for i in range(len(spec)))
                  for name, spec in _CACHE_SPEC.items()}


def cache_shardings(cache_struct, mesh, table=None):
    """Each cache leaf's spec by its name (a stacked leaf gets a leading
    unsharded layer dimension), pruned to the dims it divides: the
    reference's placement (``table``: another name -> spec table)."""
    bt = _bt(mesh)
    table = _CACHE_SPEC if table is None else table

    def one(tree, name: str = ""):
        if isinstance(tree, dict):
            return {k: one(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        base = list(table.get(name, (None,) * len(shape)))
        base[0] = bt                        # batch dim
        stacked = len(shape) == len(base) + 1
        spec = tuple([None] + base) if stacked else tuple(base)
        return prune_pspec(spec, shape, mesh)

    return one(cache_struct)


def tp_cache_shardings(cache_struct, mesh):
    """The cache as the port's ranks hold it: :func:`cache_shardings`
    with the kv heads split in place of the sequence (module
    docstring)."""
    return cache_shardings(cache_struct, mesh, _TP_CACHE_SPEC)


def decode_token_structs(cfg: ModelConfig, shape: str):
    b = SHAPES[shape]["batch"]
    return _meta((b, 1), torch.int32), _meta((), torch.int32)


def rank_structs(structs, shardings, mesh):
    """One rank's meta tensors of a tree of global ``structs`` placed by
    ``shardings`` (each split dimension divided by its axes' size)."""
    if isinstance(structs, dict):
        return {k: rank_structs(v, shardings[k], mesh)
                for k, v in structs.items()}
    return _meta(local_shape(tuple(structs.shape), shardings, mesh),
                 structs.dtype)


def param_structs(model: Model, mesh, dtype=torch.bfloat16):
    """The rank's parameter shards as meta tensors (the whole tree
    without a mesh)."""
    structs = abstract_params(model.specs(), dtype)
    if mesh is None:
        return structs
    return rank_structs(structs, param_shardings(model.specs(), mesh), mesh)


def rank_batch_structs(cfg: ModelConfig, shape: str, with_labels: bool,
                       mesh):
    """The rank's rows of :func:`batch_structs`."""
    structs = batch_structs(cfg, shape, with_labels)
    if mesh is None:
        return structs
    return rank_structs(structs, batch_shardings(structs, mesh), mesh)


def rank_cache_structs(model: Model, batch: int, max_len: int, mesh):
    """The rank's decode cache: its rows and its kv heads / channels."""
    structs = cache_structs(model, batch, max_len)
    if mesh is None:
        return structs
    return rank_structs(structs, tp_cache_shardings(structs, mesh), mesh)
