"""Mamba-2 SSD (state-space duality) blocks: chunked scan + O(1) decode.

The port of :mod:`repro.models.ssm`: the chunked SSD scan (the
reference's ``lax.scan`` over chunks is a loop here), padding the last
chunk with ``dt = 0`` steps, which decay by exp(0) and add nothing, and
the one-step decode.

On a mesh's ``model`` axis (``tp``) that divides the SSM heads, each rank
computes its heads: its columns of ``z``, ``x`` and ``dt`` and the
shared ``B`` / ``C`` columns of ``in_proj``, the causal convolution on
those channels, the gated norm over the split ``inner`` dimension (the
sum of squares all-reduced) and a row-parallel ``out_proj``.  The stored
shard of ``in_proj`` (and of the convolution) is a contiguous block of
the concatenated z | x | B | C | dt columns, which is not whole heads,
so those leaves are gathered before use.  The conv state is stored as
``launch/shapes.py:cache_shardings`` splits it (a contiguous block of
the x | B | C channels): a decode step gathers it whole, and the new
state is put together from every rank's channels before the rank keeps
its block.  Where the axis does not divide the heads the layer runs
whole on every rank, on its gathered weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import tensor as T
from ..parallel.sharding import ParamSpec, shard_act
from .layers import (apply_causal_conv1d, causal_conv1d_specs, dense,
                     dense_spec, rmsnorm, rmsnorm_split)

__all__ = ["mamba_specs", "apply_mamba", "mamba_cache_shapes"]


def mamba_specs(cfg):
    d = cfg.d_model
    din = cfg.d_inner
    h = cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_ch = din + 2 * g * n
    s = {"in_proj": dense_spec(d, 2 * din + 2 * g * n + h, "embed", "inner"),
         "A_log": ParamSpec((h,), (None,), init="zeros"),
         "D_skip": ParamSpec((h,), (None,), init="ones"),
         "dt_bias": ParamSpec((h,), (None,), init="zeros"),
         "norm": ParamSpec((din,), ("inner",), init="ones"),
         "out_proj": dense_spec(din, d, "inner", "embed")}
    s.update(causal_conv1d_specs(conv_ch, cfg.conv_width))
    return s


def mamba_cache_shapes(cfg, batch: int):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"conv": (batch, cfg.conv_width - 1, conv_ch),
            "ssm": (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)}


def _ssd_chunked(xs, dt, a, bm, cm, chunk: int):
    """Chunked SSD scan.

    xs: (B,S,H,P) values; dt: (B,S,H) softplus'd steps; a: (H,) negative;
    bm, cm: (B,S,H,N) input/output projections (already head-broadcast).
    Returns (y (B,S,H,P), final_state (B,H,N,P)).
    """
    b, s, h, p = xs.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    nc = math.ceil(s / q)
    pad = nc * q - s
    if pad:  # padded steps get dt=0 => exp(0) decay, zero input: no-ops
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))

    xc = xs.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = bm.reshape(b, nc, q, h, n).float()
    cc = cm.reshape(b, nc, q, h, n).float()

    da = dtc * a.float()                                 # (B,nc,Q,H) <= 0
    da_cum = torch.cumsum(da, dim=2)                     # inclusive
    da_tot = da_cum[:, :, -1, :]                         # (B,nc,H)

    # intra-chunk: L[i,j] = exp(da_cum_i - da_cum_j) for i >= j
    li = da_cum[:, :, :, None, :]                        # i
    lj = da_cum[:, :, None, :, :]                        # j
    ar = torch.arange(q, device=xs.device)
    mask = ar[:, None] >= ar[None, :]
    l = torch.where(mask[None, None, :, :, None], torch.exp(li - lj), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * l
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtc, xc)

    # per-chunk input states: sum_j exp(da_tot - da_cum_j) dt_j B_j x_j
    decay_out = torch.exp(da_tot[:, :, None, :] - da_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", bc, decay_out * dtc, xc)

    # inter-chunk recurrence (sequential over chunks)
    decays = torch.exp(da_tot)                           # (B,nc,H)
    st = torch.zeros((b, h, n, p), dtype=torch.float32, device=xs.device)
    prev = []                                            # state before chunk c
    for c in range(nc):
        prev.append(st)
        st = st * decays[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                      # (B,nc,H,N,P)

    y_off = torch.einsum("bcihn,bchnp,bcih->bcihp", cc, prev,
                         torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y.to(xs.dtype), st


def _widths(cfg):
    din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return din, din + 2 * g * n, 2 * din + 2 * g * n + h


def apply_mamba(params, cfg, x, cache=None, decode: bool = False, tp=None):
    """x: (B,S,D). Returns (out, new_cache)."""
    if T.splits(tp, cfg.ssm_heads):
        return _mamba_split(params, cfg, x, cache, decode, tp)
    if tp is not None and tp.size > 1:      # the whole layer on every rank
        din, conv_ch, width = _widths(cfg)
        params = dict(params,
                      **{k: T.gather(params[k], tp, dim, size, f"mamba.{k}")
                         for k, dim, size in (("in_proj", 1, width),
                                              ("conv_w", 1, conv_ch),
                                              ("conv_b", 0, conv_ch),
                                              ("norm", 0, din),
                                              ("out_proj", 0, din))})
        if cache is not None:
            cache = {"conv": T.gather(cache["conv"], tp, 2, conv_ch,
                                      "cache.conv"),
                     "ssm": T.gather(cache["ssm"], tp, 1, cfg.ssm_heads,
                                     "cache.ssm")}
        out, new = _mamba_whole(params, cfg, x, cache, decode)
        return out, {"conv": T.shard(new["conv"], tp, 2),
                     "ssm": T.shard(new["ssm"], tp, 1)}
    return _mamba_whole(params, cfg, x, cache, decode)


def _mamba_whole(params, cfg, x, cache, decode):
    b, s, d = x.shape
    din, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    rep = h // g

    zxbcdt = dense(x, params["in_proj"])
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * g * n]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - h:]

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = apply_causal_conv1d(
        {"conv_w": params["conv_w"], "conv_b": params["conv_b"]}, xbc,
        conv_state)
    xbc = F.silu(xbc)

    xs = xbc[..., :din].reshape(b, s, h, p)
    bm = xbc[..., din:din + g * n].reshape(b, s, g, n)
    cm = xbc[..., din + g * n:].reshape(b, s, g, n)
    bm = torch.repeat_interleave(bm, rep, dim=2)
    cm = torch.repeat_interleave(cm, rep, dim=2)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())

    if decode:
        st = cache["ssm"].float()                        # (B,H,N,P)
        da = torch.exp(dt[:, 0] * a)                     # (B,H)
        upd = torch.einsum("bh,bhn,bhp->bhnp", dt[:, 0],
                           bm[:, 0].float(), xs[:, 0].float())
        st = st * da[:, :, None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", cm[:, 0].float(), st)
        y = y[:, None].to(x.dtype)                       # (B,1,H,P)
        new_ssm = st
    else:
        y, new_ssm = _ssd_chunked(xs, dt, a, bm, cm, cfg.ssm_chunk)

    y = y + params["D_skip"].to(x.dtype)[None, None, :, None] \
        * xs.to(x.dtype)
    y = y.reshape(b, s, din)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype),
                params["norm"], cfg.norm_eps)
    y = shard_act(y, "batch", "seq", "inner")
    out = dense(y, params["out_proj"])
    return out, {"conv": new_conv, "ssm": new_ssm.float()}


def _mamba_split(params, cfg, x, cache, decode, tp):
    """:func:`apply_mamba` on this rank's heads (module docstring)."""
    b, s, d = x.shape
    din, conv_ch, width = _widths(cfg)
    g, n, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    heads = T.span(tp, cfg.ssm_heads)
    h = heads.stop - heads.start
    dl = h * p                                  # this rank's d_inner
    c0 = heads.start * p                        # its first channel
    rep = cfg.ssm_heads // g

    def whole(name, dim, size):
        return T.enter(T.gather(params[name], tp, dim, size,
                                f"mamba.{name}"), tp)

    w_in = whole("in_proj", 1, width)
    cols = torch.cat([torch.arange(c0, c0 + dl),               # z
                      torch.arange(din + c0, din + c0 + dl),   # x
                      torch.arange(2 * din, 2 * din + 2 * g * n),  # B, C
                      2 * din + 2 * g * n + torch.arange(heads.start,
                                                         heads.stop)])
    cols = cols.to(w_in.device)
    chans = cols[dl:dl + dl + 2 * g * n] - din      # x | B | C channels
    x = T.enter(x, tp)
    zxbcdt = dense(x, w_in.index_select(1, cols))
    z = zxbcdt[..., :dl]
    xbc = zxbcdt[..., dl:2 * dl + 2 * g * n]
    dt_raw = zxbcdt[..., 2 * dl + 2 * g * n:]

    conv = {"conv_w": whole("conv_w", 1, conv_ch).index_select(1, chans),
            "conv_b": whole("conv_b", 0, conv_ch).index_select(0, chans)}
    conv_state = None
    if cache is not None:
        conv_state = T.gather(cache["conv"], tp, 2, conv_ch,
                              "cache.conv").index_select(2, chans)
    xbc, new_conv = apply_causal_conv1d(conv, xbc, conv_state)
    xbc = F.silu(xbc)

    xs = xbc[..., :dl].reshape(b, s, h, p)
    bm = xbc[..., dl:dl + g * n].reshape(b, s, g, n)
    cm = xbc[..., dl + g * n:].reshape(b, s, g, n)
    # the B / C group of each of this rank's heads
    grp = torch.arange(heads.start, heads.stop, device=x.device) // rep
    bm = bm.index_select(2, grp)
    cm = cm.index_select(2, grp)
    dt_bias = T.enter(params["dt_bias"], tp)[heads]
    a_log = T.enter(params["A_log"], tp)[heads]
    d_skip = T.enter(params["D_skip"], tp)[heads]
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    a = -torch.exp(a_log.float())

    if decode:
        st = cache["ssm"].float()                        # (B,H,N,P)
        da = torch.exp(dt[:, 0] * a)                     # (B,H)
        upd = torch.einsum("bh,bhn,bhp->bhnp", dt[:, 0],
                           bm[:, 0].float(), xs[:, 0].float())
        st = st * da[:, :, None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", cm[:, 0].float(), st)
        y = y[:, None].to(x.dtype)                       # (B,1,H,P)
        new_ssm = st
    else:
        y, new_ssm = _ssd_chunked(xs, dt, a, bm, cm, cfg.ssm_chunk)

    y = y + d_skip.to(x.dtype)[None, None, :, None] * xs.to(x.dtype)
    y = y.reshape(b, s, dl)
    # the axis divides the heads, so norm and out_proj hold this rank's
    # channels
    y = rmsnorm_split(y * F.silu(z.float()).to(y.dtype), params["norm"],
                      din, tp, cfg.norm_eps)
    y = shard_act(y, "batch", "seq", "inner")
    out = T.leave(dense(y, params["out_proj"]), tp)
    if cache is None and torch.is_grad_enabled():
        # a training pass: no caller keeps the state, so it is not put
        # together (no collective for it)
        return out, {"conv": new_conv, "ssm": new_ssm.float()}
    # the conv state whole from every rank's channels (B and C from the
    # first rank), then this rank's block of it as the cache stores it
    full = new_conv.new_zeros(new_conv.shape[:2] + (conv_ch,))
    keep = new_conv if tp.rank == 0 else torch.cat(
        [new_conv[..., :dl], torch.zeros_like(new_conv[..., dl:])], -1)
    full.index_copy_(2, chans, keep)
    full = T.leave(full, tp)
    return out, {"conv": T.shard(full, tp, 2), "ssm": new_ssm.float()}
