"""Logical-axis parameter specs of the LM substrate, serving half.

The port of :mod:`repro.parallel.sharding`.  Every parameter is declared
as a :class:`ParamSpec` carrying its *logical* axis names; a tree of
specs (nested dicts, the reference's pytree paths as keys) yields the
initialised parameters and the parameter count.  The rule table maps
logical names onto mesh axes as the reference's does; nothing reads it
until the training slice brings a mesh (``param_shardings``,
``activate_mesh``, ``prune_pspec``), so :func:`shard_act` is the
identity, as the reference's is with no active mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ParamSpec", "LOGICAL_RULES", "init_params", "stack_specs",
    "shard_act", "count_params", "map_specs",
]

# logical axis -> mesh axis (None = replicated).  DP batch over pod+data,
# TP over model for heads / ffn / vocab, EP: experts over model.
LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_group": ("pod", "data"),
    "inner": "model",       # mamba d_inner / rg-lru width
    "state": None,
    "conv": None,
    "lora": None,           # MLA compressed dims stay replicated
    "layers": None,         # stacked-layers leading axis
    "zero": "data",         # ZeRO-1 optimizer-state sharding axis
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def map_specs(fn: Callable, specs, path: Tuple[str, ...] = ()):
    """``fn(path, spec)`` over every leaf of a spec tree (nested dicts);
    ``path`` is the tuple of keys from the root, as the reference's
    pytree paths."""
    if isinstance(specs, ParamSpec):
        return fn(path, specs)
    return {k: map_specs(fn, v, path + (k,)) for k, v in specs.items()}


def _path_seed(path) -> int:
    s = "/".join(str(k) for k in path)
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:4], "little")


def init_params(specs, seed: int = 0, dtype=torch.bfloat16,
                device="cuda"):
    """Materialise a spec tree as a tree of tensors on ``device``.

    Each leaf draws from its own ``torch.Generator`` on ``device``, seeded
    from the leaf's path (:func:`_path_seed`, the reference's per-leaf
    fold) offset by ``seed``, so a leaf's values do not depend on the rest
    of the tree.  The values are the port's own (torch's generators, not JAX's
    threefry), and a CUDA generator draws other values than the CPU's:
    to run two devices on the same weights, initialise on one and copy.
    """
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    device = torch.device(device)

    def one(path, spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        # 32 bits: the CPU generator keeps only the low word of a seed
        gen.manual_seed((_path_seed(path) + seed * 0x9E3779B1) % 2 ** 32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)

    return map_specs(one, specs)


def stack_specs(specs, n_layers: int):
    """Prepend a stacked-layers axis to every leaf (the body's layers)."""
    return map_specs(
        lambda _p, s: ParamSpec((n_layers,) + s.shape,
                                ("layers",) + s.logical,
                                init=s.init, scale=s.scale), specs)


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return int(np.prod(specs.shape))
    return sum(count_params(v) for v in specs.values())


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """An activation's sharding constraint by logical axis names: the
    identity (the reference's is a no-op with no active mesh, and no mesh
    is active in serving)."""
    return x
