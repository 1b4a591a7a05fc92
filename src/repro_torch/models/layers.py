"""Shared neural layers: norms, RoPE, embeddings, MLPs, 1-D convs.

The port of :mod:`repro.models.layers`, in plain PyTorch.  Parameters
are plain tensors in nested dicts under the reference's names; weights
keep the reference's ``(d_in, d_out)`` layout.  Two conventions to keep:
``jax.nn.gelu`` is the tanh approximation by default, so the gelu MLP
uses ``approximate="tanh"``; RoPE rotates the two halves of a head
(half-split), not interleaved pairs.

On a mesh's ``model`` axis (``tp``, a :class:`~repro_torch.parallel.
tensor.AxisGroup`; ``None`` runs the whole layer) each function takes
this rank's shard of its leaves: the MLP is column-parallel in and
row-parallel out, the embedding and the unembedding are split over the
vocabulary, and the cross entropy reduces over it
(:mod:`repro_torch.parallel.tensor`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import tensor as T
from ..parallel.sharding import ParamSpec, shard_act

__all__ = [
    "rmsnorm", "rmsnorm_spec", "rope", "dense", "dense_spec",
    "mlp_specs", "apply_mlp", "embed_specs", "embed_tokens", "unembed",
    "causal_conv1d_specs", "apply_causal_conv1d", "cross_entropy_loss",
    "gelu", "rmsnorm_split",
]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_spec(dim: int, logical: str = "embed") -> ParamSpec:
    return ParamSpec((dim,), (logical,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, n: int, tp,
                  eps: float = 1e-6):
    """:func:`rmsnorm` of a last dimension of ``n`` split over ``tp``:
    ``x`` and ``scale`` hold this rank's channels, and the sum of
    squares is all-reduced (inside a partial region, so its gradient is
    summed too)."""
    xf = x.float()
    ss = T.enter(T.leave((xf * xf).sum(-1, keepdim=True), tp), tp)
    out = xf * torch.rsqrt(ss / n + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (half-split convention)
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense projections
# ---------------------------------------------------------------------------
def dense_spec(d_in: int, d_out: int, lin: str = "embed",
               lout: str = "ffn", scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec((d_in, d_out), (lin, lout), scale=scale)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` in the reference's ``(d_in, d_out)`` layout,
    in the promoted dtype of the two, as ``jnp.einsum`` computes it (a
    float32 input against bfloat16 weights gives a float32 product)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int, act: str = "silu"):
    if act == "silu":
        return {"w_gate": dense_spec(d_model, d_ff),
                "w_up": dense_spec(d_model, d_ff),
                "w_down": dense_spec(d_ff, d_model, "ffn", "embed")}
    return {"w_in": dense_spec(d_model, d_ff),
            "w_out": dense_spec(d_ff, d_model, "ffn", "embed")}


def apply_mlp(params, x: torch.Tensor, act: str = "silu", tp=None,
              d_ff: int = 0) -> torch.Tensor:
    """The MLP; where ``tp`` splits ``d_ff``, column-parallel gate / up
    (or in) projections and a row-parallel down (or out) projection,
    one ``all_reduce`` forward and one backward."""
    split = T.splits(tp, d_ff)
    if split:
        x = T.enter(x, tp)
    if act == "silu":
        h = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
        h = shard_act(h, "batch", "seq", "ffn")
        out = dense(h, params["w_down"])
    else:
        h = gelu(dense(x, params["w_in"]))
        h = shard_act(h, "batch", "seq", "ffn")
        out = dense(h, params["w_out"])
    return T.leave(out, tp) if split else out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def embed_specs(vocab: int, d_model: int, tie: bool, max_pos: int = 0):
    s = {"embedding": ParamSpec((vocab, d_model), ("vocab", "embed"),
                                scale=0.02)}
    if not tie:
        s["unembed"] = dense_spec(d_model, vocab, "embed", "vocab")
    if max_pos:
        s["pos_embedding"] = ParamSpec((max_pos, d_model), ("seq", "embed"),
                                       scale=0.02)
    return s


def embed_tokens(params, tokens: torch.Tensor, positions=None, tp=None,
                 vocab: int = 0):
    """Token (and learned position) embeddings.  Where ``tp`` splits the
    table's ``vocab`` rows, each rank looks up the tokens among its rows
    (zero elsewhere) and the rows are summed by an ``all_reduce``."""
    table = params["embedding"]
    if T.splits(tp, vocab):
        local = tokens - T.span(tp, vocab).start
        inside = (local >= 0) & (local < table.shape[0])
        x = F.embedding(torch.where(inside, local, 0), table)
        x = T.leave(x * inside[..., None].to(x.dtype), tp)
    else:
        x = F.embedding(tokens, table)
    if positions is not None and "pos_embedding" in params:
        x = x + F.embedding(positions, params["pos_embedding"])
    return shard_act(x, "batch", "seq", "embed")


def unembed(params, x: torch.Tensor, tp=None, vocab: int = 0):
    """Logits over the (padded) vocabulary; where ``tp`` splits its
    ``vocab`` columns, this rank's slice (a column-parallel product)."""
    if T.splits(tp, vocab):
        x = T.enter(x, tp)
    if "unembed" in params:
        logits = dense(x, params["unembed"])
    else:                                   # tied: x @ E.T
        logits = torch.matmul(x, params["embedding"].T)
    return shard_act(logits, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# causal depthwise conv1d (Mamba / RecurrentGemma frontends)
# ---------------------------------------------------------------------------
def causal_conv1d_specs(channels: int, width: int):
    return {"conv_w": ParamSpec((width, channels), ("conv", "inner"),
                                scale=0.5),
            "conv_b": ParamSpec((channels,), ("inner",), init="zeros")}


def apply_causal_conv1d(params, x: torch.Tensor, state=None):
    """x: (B, S, C) depthwise causal conv; ``state``: (B, W-1, C) for decode.

    Returns (y, new_state).
    """
    w = params["conv_w"].to(x.dtype)                 # (W, C)
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s, :] * w[i]
    y = y + params["conv_b"].to(x.dtype)
    new_state = xp[:, -(width - 1):, :]
    return y, new_state


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, tp=None,
                       vocab: int = 0, padded: int = 0):
    """Mean next-token cross entropy in f32; labels (B, S) int.

    With ``tp`` splitting the ``padded`` vocabulary, ``logits`` is this
    rank's slice of the columns: the columns at or past ``vocab`` (the
    padding the reference crops) are masked, and the max, the sum of
    exponentials and the target's logit are all-reduced over ``tp``."""
    lf = logits.float()
    if T.splits(tp, padded):
        lo = T.span(tp, padded).start
        cols = lo + torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(cols < vocab, lf, -torch.inf)
        top = T.all_max(lf.amax(-1, keepdim=True), tp)
        sumexp = T.leave(torch.exp(lf - top).sum(-1), tp)
        logz = top[..., 0] + torch.log(sumexp)
        local = labels.long() - lo
        inside = (local >= 0) & (local < lf.shape[-1])
        gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
        gold = T.leave(torch.where(inside, gold[..., 0], 0.0), tp)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
