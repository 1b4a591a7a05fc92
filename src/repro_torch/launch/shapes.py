"""Assigned input shapes and abstract inputs for every (arch x shape).

The port of :mod:`repro.launch.shapes`.  The stand-ins are
``device="meta"`` tensors (shapes and dtypes, no storage; the
reference's ``ShapeDtypeStruct``s), and a placement is a spec tuple on
a mesh (:mod:`repro_torch.parallel.sharding`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import Model, ModelConfig
from ..parallel.sharding import prune_pspec

__all__ = ["SHAPES", "shape_applicable", "batch_structs", "batch_shardings",
           "cache_structs", "cache_shardings", "decode_token_structs"]

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


def cache_shardings(cache_struct, mesh):
    """Each cache leaf's spec by its name (a stacked leaf gets a leading
    unsharded layer dimension), pruned to the dims it divides."""
    bt = _bt(mesh)

    def one(tree, name: str = ""):
        if isinstance(tree, dict):
            return {k: one(v, k) for k, v in tree.items()}
        shape = tuple(tree.shape)
        base = list(_CACHE_SPEC.get(name, (None,) * len(shape)))
        base[0] = bt                        # batch dim
        stacked = len(shape) == len(base) + 1
        spec = tuple([None] + base) if stacked else tuple(base)
        return prune_pspec(spec, shape, mesh)

    return one(cache_struct)


def decode_token_structs(cfg: ModelConfig, shape: str):
    b = SHAPES[shape]["batch"]
    return _meta((b, 1), torch.int32), _meta((), torch.int32)
