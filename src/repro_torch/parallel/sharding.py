"""Logical-axis sharding: one source of truth for parameter placement.

The port of :mod:`repro.parallel.sharding`.  Every parameter is declared
as a :class:`ParamSpec` carrying its *logical* axis names; a tree of
specs (nested dicts, the reference's pytree paths as keys) yields the
initialised parameters, the parameter count, meta-tensor stand-ins
(:func:`abstract_params`) and, through the rule table, each parameter's
placement on a mesh.

A placement ("spec") is what the reference's ``PartitionSpec`` holds: a
tuple with one entry per dimension, each ``None`` (replicated), a mesh
axis name, or a tuple of names.  A mesh is anything with
``mesh_dim_names`` and ``shape`` -- a ``torch.distributed.DeviceMesh``,
or an :class:`AbstractMesh` where only the axis sizes matter (specs,
dry runs) -- and the spec functions read only those.

:func:`shard_act` is the identity on values, mesh or not: the reference
uses it to constrain GSPMD's layout of activations, and the port has no
compiler to constrain -- its data-parallel trainer
(:mod:`repro_torch.runtime.trainer`) places each rank's rows itself.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ParamSpec", "LOGICAL_RULES", "AbstractMesh", "mesh_axis_sizes",
    "logical_to_pspec", "param_pspecs", "prune_pspec", "param_shardings",
    "init_params", "abstract_params", "stack_specs", "shard_act",
    "activate_mesh", "active_mesh", "data_parallel", "count_params",
    "map_specs",
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


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices behind them (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} vs axes "
                             f"{self.mesh_dim_names}")


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def data_parallel(mesh):
    """``(group, rank, size)`` of this process on the mesh's ``data``
    axis -- ``group`` is ``None`` where the axis has one rank, or there
    is no mesh.  The port's training is data-parallel only: any other
    axis of size > 1 raises ``NotImplementedError`` (tensor parallelism,
    a ``model`` axis > 1, is not ported)."""
    if mesh is None:
        return None, 0, 1
    sizes = mesh_axis_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a != "data" and n > 1}
    if other:
        raise NotImplementedError(
            f"training on mesh axes {other}: tensor-parallel training (a "
            f"model axis > 1) is not ported")
    size = sizes.get("data", 1)
    if size == 1:
        return None, 0, 1
    return mesh.get_group("data"), mesh.get_local_rank("data"), size


def logical_to_pspec(logical, rules=None, mesh=None) -> Tuple:
    """The spec of one parameter from its logical axis names: each name's
    mesh axis by the rules, dropped where the mesh lacks it or where an
    earlier dimension took it (a mesh axis appears at most once)."""
    rules = rules or LOGICAL_RULES
    mesh_axes = set(mesh.mesh_dim_names) if mesh is not None else None
    axes = []
    used = set()
    for name in logical:
        ax = rules.get(name) if name is not None else None
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax
                       if a not in used
                       and (mesh_axes is None or a in mesh_axes))
            ax = ax if ax else None
        elif ax is not None and mesh_axes is not None and ax not in mesh_axes:
            ax = None
        if ax is None:
            axes.append(None)
        else:
            flat = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in flat):
                axes.append(None)      # a mesh axis may appear only once
                continue
            used.update(flat)
            axes.append(ax)
    return tuple(axes)


def param_pspecs(specs, rules=None, mesh=None):
    return map_specs(lambda _p, s: logical_to_pspec(s.logical, rules, mesh),
                     specs)


def prune_pspec(spec: Tuple, shape, mesh) -> Tuple:
    """Drop mesh axes from dims they don't divide (the reference prefers
    replication to GSPMD's padded uneven shards)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None or i >= len(shape):
            out.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(s if (n > 0 and shape[i] % n == 0) else None)
    return tuple(out)


def param_shardings(specs, mesh, rules=None):
    """Each parameter's spec on ``mesh``, pruned to the dims it divides."""
    return map_specs(
        lambda _p, s: prune_pspec(logical_to_pspec(s.logical, rules, mesh),
                                  s.shape, mesh), specs)


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


def abstract_params(specs, dtype=torch.bfloat16):
    """The spec tree as ``device="meta"`` tensors (shapes and dtypes, no
    storage; the reference's ``ShapeDtypeStruct``s)."""
    return map_specs(
        lambda _p, s: torch.empty(s.shape, dtype=dtype, device="meta"),
        specs)


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


# ---------------------------------------------------------------------------
# active mesh context (per thread, as the reference's)
# ---------------------------------------------------------------------------
_STATE = threading.local()


class activate_mesh:
    """``with activate_mesh(mesh):`` makes ``mesh`` this thread's active
    mesh (:func:`active_mesh`) for the block."""

    def __init__(self, mesh, rules=None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self.prev = (getattr(_STATE, "mesh", None),
                     getattr(_STATE, "rules", None))
        _STATE.mesh, _STATE.rules = self.mesh, self.rules
        return self

    def __exit__(self, *exc):
        _STATE.mesh, _STATE.rules = self.prev
        return False


def active_mesh():
    return getattr(_STATE, "mesh", None)


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """An activation's sharding constraint by logical axis names: the
    identity on values, with or without an active mesh.  The reference's
    constraint guides GSPMD's layout and never changes a value; the port
    has no such compiler, and its data-parallel ranks each hold their
    own rows already."""
    return x
