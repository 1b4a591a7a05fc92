"""Mixture-of-Experts with sort-based capacity dispatch.

The port of :mod:`repro.models.moe`.  Routing takes the top k of the
router's softmax; each (token, choice) gets its position within its
expert from one *stable* sort of the expert indices (``jnp.argsort`` is
stable; ``torch.argsort`` is not unless asked, and an unstable sort
changes which tokens a full expert drops); choices past the capacity go
to one extra drop row of the (E*C + 1, D) buffer (``index_add_``) and
are dropped; the experts run as batched SwiGLU products; the kept
outputs are combined with their gates.  Emits the load-balance loss.

On a mesh's ``model`` axis (``tp``) that divides the experts, each rank
holds E/M of them: the router is whole and the dispatch (routing,
capacity, slots) is computed identically on every rank, each rank fills
and runs the slots of its own experts, and the combine is summed by one
``all_reduce``.  Shared experts are a column- / row-parallel MLP.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import tensor as T
from ..parallel.sharding import ParamSpec, shard_act
from .layers import dense, mlp_specs, apply_mlp

__all__ = ["moe_specs", "apply_moe", "top_k"]


def moe_specs(cfg):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    s = {"router": ParamSpec((d, e), ("embed", None), scale=0.02),
         "w_gate": ParamSpec((e, d, f), ("experts", "embed", None)),
         "w_up": ParamSpec((e, d, f), ("experts", "embed", None)),
         "w_down": ParamSpec((e, f, d), ("experts", None, "embed"))}
    if cfg.shared_experts:
        s["shared"] = mlp_specs(d, cfg.shared_experts * f, "silu")
    return s


def apply_moe(params, cfg, x, tp=None):
    """x: (B, S, D) -> (out, aux_loss).

    ``cfg.moe_dispatch`` 'grouped' pools capacity per data-parallel shard;
    with no mesh (serving on one device) that is one group, the same as
    'global', as in the reference.
    """
    b, s, d = x.shape
    out, aux = _moe_tokens(params, cfg, x.reshape(b * s, d), tp)
    out = out.reshape(b, s, d)
    if cfg.shared_experts:
        out = out + apply_mlp(params["shared"], x, "silu", tp,
                              cfg.shared_experts * cfg.moe_d_ff)
    return out.to(x.dtype), aux


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_tokens(params, cfg, xf, tp=None):
    """Route/dispatch/compute/combine for a flat (T, D) token block."""
    t, d = xf.shape
    k = cfg.experts_per_token
    e = cfg.num_experts
    dev = xf.device
    # floor the capacity so tiny decode batches never drop tokens
    cap = max(int(math.ceil(t * k / e * cfg.capacity_factor)), min(t, 32))
    logits = dense(xf, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate, eidx = top_k(probs, k)                              # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert, via one sort
    fe = eidx.reshape(-1)                                     # (T*k,)
    perm = torch.argsort(fe, stable=True)
    se = fe[perm]
    starts = torch.searchsorted(se, torch.arange(e, dtype=se.dtype,
                                                 device=dev))
    ar = torch.arange(t * k, device=dev)
    pos = torch.empty_like(fe)
    pos[perm] = ar - starts[se]
    keep = pos < cap
    slot = torch.where(keep, fe * cap + pos, e * cap)

    tok = ar // k
    weights = gate.reshape(-1) * keep.to(gate.dtype)
    split = T.splits(tp, e)
    if split:            # this rank's experts' slots; the rest to the drop row
        span = T.span(tp, e)
        e_loc = span.stop - span.start
        mine = keep & (fe >= span.start) & (fe < span.stop)
        slot = torch.where(mine, slot - span.start * cap, e_loc * cap)
        weights = T.enter(weights, tp) * mine.to(gate.dtype)
        xf = T.enter(xf, tp)
    else:
        e_loc = e
    dispatched = torch.zeros((e_loc * cap + 1, d), dtype=xf.dtype,
                             device=dev)
    dispatched.index_add_(0, slot, xf[tok])
    hidden = dispatched[:e_loc * cap].reshape(e_loc, cap, d)
    hidden = shard_act(hidden, "experts", "expert_cap", "embed")

    h = (F.silu(torch.bmm(hidden, params["w_gate"]))
         * torch.bmm(hidden, params["w_up"]))
    ho = torch.bmm(h, params["w_down"])
    ho = shard_act(ho, "experts", "expert_cap", "embed")

    flat = torch.cat([ho.reshape(e_loc * cap, d), ho.new_zeros((1, d))],
                     dim=0)
    out_k = flat[slot] * weights[:, None].to(flat.dtype)
    out = out_k.reshape(t, k, d).sum(dim=1)
    if split:
        out = T.leave(out, tp)

    # Switch-style load-balance loss
    counts = torch.zeros((e,), dtype=torch.float32, device=dev)
    counts.index_add_(0, fe, torch.ones_like(fe, dtype=torch.float32))
    counts = counts / (t * k)
    aux = e * torch.sum(counts * probs.mean(dim=0))
    return out, aux
