"""AdamW with float32 moments, global-norm clipping, a cosine schedule,
gradient accumulation, and ZeRO-1 optimizer-state placement.

The port of :mod:`repro.optim.adamw`, in plain PyTorch (the reference
computes it in plain ``jnp``; there is no kernel to port).  Trees are
nested dicts of tensors under the reference's keys (:mod:`repro_torch.
tree`).  The reference's jitted step donates its parameters and
moments; :func:`adamw_update` instead updates them in place and returns
the same tensors, so a caller that keeps an old tree must clone it.

:class:`ModelShards` runs AdamW on a rank's shards under tensor
parallelism: the global norm sums the squares of the split leaves over
the ``model`` group and counts each whole (replicated) leaf once; every
other step of the update is elementwise on the local shard.

:func:`value_and_grad` stands in for ``jax.value_and_grad``: it runs a
loss on detached copies of the parameter leaves that require grad (the
leaves share storage; nothing is copied) and returns the gradients as a
tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..parallel import tensor as T
from ..parallel.sharding import mesh_axis_sizes
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_abstract", "adamw_update",
           "cosine_schedule", "global_norm", "zero1_shardings",
           "accumulate_grads", "value_and_grad", "Zero1", "ModelShards",
           "model_shards"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """``lr(step)``: linear warmup to ``base_lr``, then a half cosine to 0
    at ``total``; ``step`` is taken as float32 and the rate is a float32
    0-d tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass
class ModelShards:
    """Which leaves (in the order of ``tree_leaves``) the ``model`` axis
    splits, and its group: a split leaf holds this rank's shard, a whole
    one is the same on every rank."""
    split: list
    tp: object


def model_shards(shardings, tp) -> Optional[ModelShards]:
    """:class:`ModelShards` from a tree of specs (``param_shardings``;
    a spec is a tuple, so the tree is walked here), ``None`` without a
    model axis of more than one rank."""
    if tp is None or tp.size == 1:
        return None
    split = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):           # the order of tree_leaves
                walk(t[k])
        else:
            split.append(any(a == "model" or (isinstance(a, tuple)
                                              and "model" in a) for a in t))

    walk(shardings)
    return ModelShards(split, tp)


def global_norm(tree, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The 2-norm over every leaf, accumulated in float32; with
    ``shards``, over the whole leaves the ranks' shards make up."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if shards is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    zero = leaves[0].new_zeros(())
    split = sum((x for x, s in zip(leaves, shards.split) if s), zero)
    whole = sum((x for x, s in zip(leaves, shards.split) if not s), zero)
    return torch.sqrt(T.leave(split, shards.tp) + whole)


def adamw_init(params):
    """Zero float32 moments of the parameters' shapes and an int32 step."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_abstract(params):
    """:func:`adamw_init`'s state for a tree of (meta) tensors, as
    ``device="meta"`` tensors: the reference's ``ShapeDtypeStruct``s."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


@dataclasses.dataclass
class Zero1:
    """ZeRO-1 on a data group: leaf ``i``'s moments hold this rank's
    slice of dimension ``dims[i]`` (``None``: the whole leaf), in the
    order of ``tree_leaves``.  :func:`adamw_update` updates the slice and
    all-gathers the new parameter over ``group``."""
    dims: list
    group: object
    rank: int
    size: int

    def local(self, x: torch.Tensor, dim) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim`` (``x`` itself when
        ``dim`` is ``None``)."""
        if dim is None:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def gather(self, part: torch.Tensor, dim) -> torch.Tensor:
        """The whole leaf from every rank's slice along ``dim``."""
        if dim is None:
            return part
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_schedule: Optional[Callable] = None,
                 zero1: Optional[Zero1] = None,
                 shards: Optional[ModelShards] = None):
    """Returns ``(params, state, {"grad_norm", "lr"})``.

    The gradient is clipped to a global norm of ``cfg.clip_norm``; the
    moments, the bias correction and the decoupled decay are float32,
    and the new parameter is cast back to its dtype.  The parameters and
    moments are updated in place.  With ``zero1``, each rank's moments
    are its slices (:class:`Zero1`) and ``grads`` the whole (averaged)
    gradients.  With ``shards`` the leaves are this rank's shards over
    the ``model`` axis (:class:`ModelShards`; ZeRO-1 then slices each
    shard).
    """
    step = state["step"] + 1
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(step) if lr_schedule else cfg.lr
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_mu = tree_leaves(state["mu"])
    flat_nu = tree_leaves(state["nu"])
    dims = zero1.dims if zero1 is not None else [None] * len(flat_p)
    for p, g, mu, nu, dim in zip(flat_p, flat_g, flat_mu, flat_nu, dims):
        if zero1 is not None:
            p_loc, g_loc = zero1.local(p, dim), zero1.local(g, dim)
        else:
            p_loc, g_loc = p, g
        g_loc = g_loc.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g_loc)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g_loc * g_loc)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p_loc.float()
        delta = delta + cfg.weight_decay * pf
        new = (pf - lr * delta).to(p.dtype)
        if zero1 is not None:
            new = zero1.gather(new, dim)
        p.copy_(new)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def zero1_shardings(param_shardings, abstract_params, mesh,
                    zero_axis: str = "data"):
    """ZeRO-1: shard optimizer moments over the data axis.

    For each parameter, the first dimension that is unsharded in the
    parameter's spec and divisible by the axis size gets ``zero_axis``.
    Falls back to the parameter's own spec when nothing fits (or when
    the spec already uses the axis), as the reference does.
    """
    size = mesh_axis_sizes(mesh)[zero_axis]

    def for_param(spec, aval):
        shape = tuple(aval.shape)
        spec = tuple(spec)
        full = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for s in full:
            for a in (s if isinstance(s, tuple) else (s,)):
                if a:
                    used.add(a)
        if zero_axis in used:
            return spec
        for i, (s, dim) in enumerate(zip(full, shape)):
            if s is None and dim % size == 0 and dim >= size:
                full[i] = zero_axis
                return tuple(full)
        return spec

    # walked by the parameters' tree: a spec is a tuple, not a subtree
    return tree_map(lambda aval, spec: for_param(spec, aval),
                    abstract_params, param_shardings)


def value_and_grad(fn: Callable, params, *args, has_aux: bool = False):
    """``jax.value_and_grad(fn, has_aux)(params, *args)``: returns
    ``(value, grads)`` or, with ``has_aux``, ``((value, aux), grads)``;
    the value is detached and ``grads`` has the tree's structure."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    out = fn(tree_unflatten(params, leaves), *args)
    value = out[0] if has_aux else out
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    value = value.detach()
    out = (value, out[1]) if has_aux else value
    return out, tree_unflatten(params, grads)


def accumulate_grads(loss_fn: Callable, params, batches, microbatches: int):
    """Mean loss and float32 grads over ``microbatches`` splits of the
    leading axis; ``loss_fn(params, batch) -> (loss, aux)``.  The
    reference scans the splits; the port loops over them."""
    def split(x, i):
        n = x.shape[0] // microbatches
        return x.reshape((microbatches, n) + tuple(x.shape[1:]))[i]

    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]
    lsum = None
    for i in range(microbatches):
        b = tree_map(lambda x: split(x, i), batches)
        (loss, _), g = value_and_grad(loss_fn, params, b, has_aux=True)
        for acc, gi in zip(gsum, tree_leaves(g)):
            acc.add_(gi)
        lsum = loss.float() if lsum is None else lsum + loss
    inv = 1.0 / microbatches
    return lsum * inv, tree_unflatten(params, [g * inv for g in gsum])
