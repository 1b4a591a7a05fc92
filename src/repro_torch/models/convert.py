"""Weights carried across: the reference's parameter tree <-> the port's.

The reference keeps its parameters as a pytree of nested dicts; the
port's :class:`~repro_torch.models.Model` keeps the same leaves under the
same keys and in the same layouts (``(d_in, d_out)`` projections, the
stacked body's leading layer axis), so the conversion is name for name
with no transposes.  Pass the reference's tree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..parallel.sharding import param_shardings, shard_params
from ..tree import tree_map
from .lm import Model, check_tree

__all__ = ["params_from_reference", "params_to_numpy",
           "opt_state_from_reference"]


def _floating(path: str, arr: np.ndarray) -> np.ndarray:
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: via float32
        return arr.astype(np.float32)
    if arr.dtype.kind != "f":
        raise TypeError(f"{path}: dtype {arr.dtype}, parameters are floating")
    return arr


def params_from_reference(model: Model, tree, device="cuda",
                          dtype=None, mesh=None):
    """Load the reference's parameter tree (numpy leaves) into ``model``.

    Raises when a leaf is missing or extra, has another shape than the
    model's spec, or is not floating, or when the leaves' dtypes differ.
    ``dtype`` (a torch dtype) casts every leaf; by default each keeps its
    own (a bfloat16 tree stays bfloat16).  With ``mesh``, returns this
    rank's shards of the leaves as a tree (``param_shardings``; each
    shard its own contiguous tensor) for the entry points' ``params=``,
    and installs nothing.
    """
    check_tree(tree, model.specs())
    dtypes = set()

    def one(path, leaf):
        if isinstance(leaf, dict):
            return {k: one(f"{path}.{k}" if path else k, v)
                    for k, v in leaf.items()}
        arr = np.asarray(leaf)
        dtypes.add(arr.dtype.name)
        t = torch.from_numpy(np.array(_floating(path, arr)))
        if arr.dtype.name == "bfloat16":
            t = t.to(torch.bfloat16)
        return t if mesh is not None else t.to(device=device, dtype=dtype)

    params = one("", tree)
    if len(dtypes) > 1:
        raise TypeError(f"the tree mixes dtypes {sorted(dtypes)}")
    if mesh is None:
        return model.load_params(params)
    shards = shard_params(params, param_shardings(model.specs(), mesh), mesh)
    return tree_map(lambda t: t.to(device=device, dtype=dtype,
                                   copy=True).contiguous(), shards)


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """The model's parameters as a tree of numpy arrays under the
    reference's keys (bfloat16 leaves as float32)."""

    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return one(model.param_tree())


def opt_state_from_reference(model: Model, state, device="cuda"):
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy
    leaves: float32 moments of the model's parameter tree, an int32
    step) as the port's :func:`repro_torch.optim.adamw_init` state on
    ``device``.  Raises when a moment tree does not match the model's
    specs or a leaf is not float32, or the step is not an int32 scalar."""
    specs = model.specs()

    def moments(tree, path: str):
        if isinstance(tree, dict):
            return {k: moments(v, f"{path}.{k}") for k, v in tree.items()}
        arr = np.asarray(tree)
        if arr.dtype != np.float32:
            raise TypeError(f"{path}: dtype {arr.dtype}, moments are "
                            f"float32")
        return torch.from_numpy(np.array(arr)).to(device)

    out = {}
    for name in ("mu", "nu"):
        check_tree(state[name], specs)
        out[name] = moments(state[name], name)
    step = np.asarray(state["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise TypeError(f"step: {step.dtype} {step.shape}, the step is an "
                        f"int32 scalar")
    out["step"] = torch.from_numpy(np.array(step)).to(device)
    return out
