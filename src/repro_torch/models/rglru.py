"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of :mod:`repro.models.rglru`.  The reference runs the linear
recurrence ``h_t = a_t * h_{t-1} + x_t`` as ``jax.lax.associative_scan``;
here it is a log-depth (Hillis-Steele) scan of the same combine, in
ceil(log2 S) steps of whole-tensor ops.  The carried state is injected
into the first step, as the reference does.  The closed form
``cumprod(a) * cumsum(x / cumprod(a))`` is not used: the products of
``a`` underflow and the division blows up.

On a mesh's ``model`` axis (``tp``) that divides the gate blocks, each
rank computes its blocks' channels: ``w_x`` / ``w_y`` column-parallel,
the block-diagonal gates by block, the convolution, ``a_param`` and the
biases by channel, the recurrence on its channels and a row-parallel
``w_out``.  Where the axis does not divide the blocks (a shard would
not be whole blocks) the layer runs whole on every rank, on its
gathered weights, and keeps its block of the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import tensor as T
from ..parallel.sharding import ParamSpec, shard_act
from .layers import (apply_causal_conv1d, causal_conv1d_specs, dense,
                     dense_spec, gelu)

__all__ = ["rglru_specs", "apply_rglru", "rglru_cache_shapes",
           "linear_scan"]

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_specs(cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    h = max(cfg.num_heads, 1)
    bw = w // h                       # Griffin: block-diagonal gate matrices
    s = {"w_x": dense_spec(d, w, "embed", "inner"),
         "w_y": dense_spec(d, w, "embed", "inner"),
         "w_rg": ParamSpec((h, bw, bw), ("inner", None, None)),
         "b_rg": ParamSpec((w,), ("inner",), init="zeros"),
         "w_ig": ParamSpec((h, bw, bw), ("inner", None, None)),
         "b_ig": ParamSpec((w,), ("inner",), init="zeros"),
         "a_param": ParamSpec((w,), ("inner",), init="ones"),
         "w_out": dense_spec(w, d, "inner", "embed")}
    s.update(causal_conv1d_specs(w, cfg.conv_width))
    return s


def _block_gate(x, w_block, b):
    """x: (B,S,W) through a block-diagonal (h, W/h, W/h) matrix + bias."""
    bsz, s, wdim = x.shape
    h, bw, _ = w_block.shape
    xh = x.reshape(bsz, s, h, bw)
    y = torch.einsum("bshi,hij->bshj", xh, w_block).reshape(bsz, s, wdim)
    return y + b


def rglru_cache_shapes(cfg, batch: int):
    w = cfg.lru_width or cfg.d_model
    return {"conv": (batch, cfg.conv_width - 1, w), "h": (batch, w)}


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """All h_t of ``h_t = a_t * h_{t-1} + x_t`` (h_{-1} = 0) along axis 1.

    Hillis-Steele over the associative combine ``(a1, x1) . (a2, x2) =
    (a1 a2, a2 x1 + x2)``: after the step of offset k, position t holds
    the combine of the 2k inputs ending at t.
    """
    s = a.shape[1]
    k = 1
    while k < s:
        x = torch.cat([x[:, :k], a[:, k:] * x[:, :-k] + x[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return x


# leaves split over the recurrent width: (name, dimension of the width)
_WIDTH_DIMS = (("w_x", 1), ("w_y", 1), ("b_rg", 0), ("b_ig", 0),
               ("a_param", 0), ("w_out", 0), ("conv_w", 1), ("conv_b", 0))


def apply_rglru(params, cfg, x, cache=None, decode: bool = False, tp=None):
    """x: (B,S,D) -> (out, new_cache={conv, h})."""
    if tp is None or tp.size == 1:
        return _rglru(params, cfg, x, cache, decode)
    w = cfg.lru_width or cfg.d_model
    if T.splits(tp, max(cfg.num_heads, 1)):
        out, new = _rglru(params, cfg, T.enter(x, tp), cache, decode)
        return T.leave(out, tp), new
    params = dict(params, **{k: T.gather(params[k], tp, dim, w, f"rec.{k}")
                             for k, dim in _WIDTH_DIMS})
    if cache is not None:
        cache = {"conv": T.gather(cache["conv"], tp, 2, w, "cache.conv"),
                 "h": T.gather(cache["h"], tp, 1, w, "cache.h")}
    out, new = _rglru(params, cfg, x, cache, decode)
    return out, {"conv": T.shard(new["conv"], tp, 2),
                 "h": T.shard(new["h"], tp, 1)}


def _rglru(params, cfg, x, cache, decode):
    b, s, d = x.shape
    xb = dense(x, params["w_x"])
    yb = gelu(dense(x, params["w_y"]))

    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = apply_causal_conv1d(
        {"conv_w": params["conv_w"], "conv_b": params["conv_b"]}, xb,
        conv_state)

    r = torch.sigmoid(_block_gate(xc, params["w_rg"], params["b_rg"]))
    i = torch.sigmoid(_block_gate(xc, params["w_ig"], params["b_ig"]))
    log_a = (-_C * F.softplus(params["a_param"].float())
             * r.float())                                  # (B,S,W) <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * (i.float() * xc.float())

    if decode:
        h_prev = cache["h"].float()                       # (B,W)
        h = a[:, 0] * h_prev + gated[:, 0]
        hs = h[:, None]
    else:
        if cache is not None:  # inject carried state into the first step
            h0 = cache["h"].float()
            gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                               gated[:, 1:]], dim=1)
        hs = linear_scan(a, gated)
        h = hs[:, -1]

    hs = hs.to(x.dtype)
    hs = shard_act(hs, "batch", "seq", "inner")
    out = dense(hs * yb, params["w_out"])
    return out, {"conv": new_conv, "h": h.float()}
