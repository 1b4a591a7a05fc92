"""Attention: chunked-online-softmax GQA, sliding-window, cross, and MLA.

The port of :mod:`repro.models.attention`, in plain PyTorch, with the
reference's formulation kept (no fused attention kernel):

* Global causal attention streams KV chunks through an online softmax
  (running max, running sum, ``NEG_INF`` masking, a ``1e-30`` floor on
  the sum); ``attn_impl`` picks the reference's ``chunked``,
  ``qchunked`` (a loop over query chunks) or ``segmented`` (causal
  triangle segments) form, with ``chunk_q`` / ``chunk_kv`` /
  ``attn_segments`` as its knobs.
* Sliding-window attention uses the chunk-pair scheme (each W-sized
  query chunk attends to its own + previous chunk); its cache is a ring
  buffer where absolute position p lives at slot p % window.
* Decode writes the new K/V into the cache in place (the reference's
  ``dynamic_update_slice``) and attends over the valid prefix.
* MLA (DeepSeek-V2) prefills in expanded form and decodes in the
  absorbed form over the compressed ``c_kv`` / ``k_rope`` cache.

On a mesh's ``model`` axis (``tp``) a layer whose query heads the axis
divides computes this rank's heads: ``wq`` (MLA: ``q_up`` / ``wq``,
``k_up``, ``v_up``) column-parallel and ``wo`` row-parallel.  Under GQA
the rank uses the kv heads its query heads map to -- its own shard of
``wk`` / ``wv`` where the axis divides the kv heads, else the whole
weights (gathered where a shard is not whole heads), every kv head
computed and cached.  MLA's ``lora`` weights and its latent cache stay
whole on every rank.  A layer whose query heads the axis does not
divide runs whole on every rank, on its gathered weights.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import tensor as T
from ..parallel.sharding import shard_act
from .layers import dense, dense_spec, rmsnorm, rmsnorm_spec, rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def attn_specs(cfg):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = {"wq": dense_spec(d, h * hd),
         "wk": dense_spec(d, hkv * hd),
         "wv": dense_spec(d, hkv * hd),
         "wo": dense_spec(h * hd, d, "ffn", "embed")}
    if cfg.qk_norm:
        s["q_norm"] = rmsnorm_spec(hd, "head_dim")
        s["k_norm"] = rmsnorm_spec(hd, "head_dim")
    return s


def mla_specs(cfg):
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    s = {"kv_down": dense_spec(d, cfg.kv_lora_rank + cfg.rope_head_dim,
                               "embed", "lora"),
         "kv_norm": rmsnorm_spec(cfg.kv_lora_rank, "lora"),
         "k_up": dense_spec(cfg.kv_lora_rank, h * cfg.nope_head_dim,
                            "lora", "ffn"),
         "v_up": dense_spec(cfg.kv_lora_rank, h * cfg.v_head_dim,
                            "lora", "ffn"),
         "wo": dense_spec(h * cfg.v_head_dim, d, "ffn", "embed")}
    if cfg.q_lora_rank:
        s["q_down"] = dense_spec(d, cfg.q_lora_rank, "embed", "lora")
        s["q_norm"] = rmsnorm_spec(cfg.q_lora_rank, "lora")
        s["q_up"] = dense_spec(cfg.q_lora_rank, h * qk, "lora", "ffn")
    else:
        s["wq"] = dense_spec(d, h * qk)
    return s


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, S, ...) tensor at its end."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


# ---------------------------------------------------------------------------
# chunked online-softmax scaled dot product (GQA grouped, no KV repeat)
# ---------------------------------------------------------------------------
def _sdpa_chunked(q, k, v, *, q_positions, causal: bool,
                  window: int = 0, kv_valid=None, chunk_kv: int = 1024):
    """q: (B,Sq,H,hd); k,v: (B,Skv,Hkv,hd). Returns (B,Sq,H,hd).

    ``q_positions``: (Sq,) absolute positions of queries.
    ``kv_valid``: count of valid cache entries (decode), else None.
    """
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = hd ** -0.5

    ckv = min(chunk_kv, skv)
    nkv = math.ceil(skv / ckv)
    pad = nkv * ckv - skv
    if pad:
        k = _pad_seq(k, pad)
        v = _pad_seq(v, pad)

    qg = q.reshape(b, sq, hkv, g, hd).float()
    qpos = q_positions.to(torch.int32)                       # (Sq,)
    limit = skv if kv_valid is None else kv_valid

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    offs = torch.arange(ckv, dtype=torch.int32, device=q.device)
    for j in range(nkv):
        kj = k[:, j * ckv:(j + 1) * ckv].float()
        vj = v[:, j * ckv:(j + 1) * ckv].float()
        kvpos = j * ckv + offs                                # (ckv,)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj) * scale
        valid = (kvpos[None, :] < limit)
        if causal:
            valid = valid & (kvpos[None, :] <= qpos[:, None])
        if window:
            valid = valid & (qpos[:, None] - kvpos[None, :] < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                   p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def _sdpa_qchunked(q, k, v, *, q_positions, causal: bool,
                   window: int = 0, kv_valid=None,
                   chunk_q: int = 512, chunk_kv: int = 1024):
    """Two-level flash attention: a loop over query chunks, each an
    online-softmax pass over the KV chunks."""
    b, sq, h, hd = q.shape
    cq = min(chunk_q, sq)
    nq = math.ceil(sq / cq)
    pad = nq * cq - sq
    if pad:
        q = _pad_seq(q, pad)
        # padded queries get position -1: fully masked, cropped after
        q_positions = F.pad(q_positions, (0, pad), value=-1)
    outs = [_sdpa_chunked(q[:, i * cq:(i + 1) * cq], k, v,
                          q_positions=q_positions[i * cq:(i + 1) * cq],
                          causal=causal, window=window, kv_valid=kv_valid,
                          chunk_kv=chunk_kv)
            for i in range(nq)]
    return torch.cat(outs, dim=1)[:, :sq]


def _sdpa_segmented(q, k, v, *, q_positions, causal: bool,
                    segments: int = 4, chunk_kv: int = 1024):
    """Causal triangular segmentation (self-attention, Sq == Skv): query
    segment s attends only kv[: (s+1)*Sq/segments]."""
    b, sq, h, hd = q.shape
    seg = math.ceil(sq / segments)
    outs = []
    for s in range(segments):
        lo, hi = s * seg, min((s + 1) * seg, sq)
        if lo >= hi:
            break
        kv_end = min(hi, k.shape[1])
        outs.append(_sdpa_chunked(
            q[:, lo:hi], k[:, :kv_end], v[:, :kv_end],
            q_positions=q_positions[lo:hi], causal=causal,
            chunk_kv=chunk_kv))
    return torch.cat(outs, dim=1)


def _sdpa(q, k, v, *, cfg, q_positions, causal, window=0, kv_valid=None):
    """Dispatch on cfg.attn_impl: chunked (baseline) | qchunked | segmented."""
    long_self = (q.shape[1] > cfg.chunk_q and kv_valid is None
                 and window == 0)
    if cfg.attn_impl == "qchunked" and long_self:
        return _sdpa_qchunked(q, k, v, q_positions=q_positions,
                              causal=causal, window=window,
                              kv_valid=kv_valid, chunk_q=cfg.chunk_q,
                              chunk_kv=cfg.chunk_kv)
    if (cfg.attn_impl == "segmented" and long_self and causal
            and q.shape[1] == k.shape[1]):
        return _sdpa_segmented(q, k, v, q_positions=q_positions,
                               causal=causal, segments=cfg.attn_segments,
                               chunk_kv=cfg.chunk_kv)
    return _sdpa_chunked(q, k, v, q_positions=q_positions, causal=causal,
                         window=window, kv_valid=kv_valid,
                         chunk_kv=cfg.chunk_kv)


def _local_attention(q, k, v, window: int):
    """Sliding-window causal attention (prefill), chunk size == window:
    each query chunk attends to [prev | own].  q,k,v: (B,S,H|Hkv,hd)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    w = window
    nc = math.ceil(s / w)
    pad = nc * w - s
    if pad:
        q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    scale = hd ** -0.5
    qc = q.reshape(b, nc, w, hkv, g, hd).float()
    kc = k.reshape(b, nc, w, hkv, hd)
    vc = v.reshape(b, nc, w, hkv, hd)
    prev_k = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    prev_v = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([prev_k, kc], dim=2)                  # (B,nc,2W,Hkv,hd)
    vv = torch.cat([prev_v, vc], dim=2)

    scores = torch.einsum("bcqkgd,bcskd->bckgqs", qc, kk.float()) * scale
    dev = q.device
    qi = torch.arange(w, device=dev)[:, None]         # in-chunk query index
    kj = torch.arange(2 * w, device=dev)[None, :] - w  # kv offset vs chunk
    delta = qi - kj                                   # q_pos - kv_pos
    valid = (delta >= 0) & (delta < w)                # causal, in window
    not_first = torch.arange(nc, device=dev)[:, None, None] > 0
    valid = valid[None] & (not_first | (kj >= 0)[None])  # no prev for c=0
    scores = torch.where(valid[None, :, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgqs,bcskd->bcqkgd", p, vv.float())
    out = out.reshape(b, nc * w, h, hd)[:, :s]
    return out.to(q.dtype)


def _positions_2d(positions: torch.Tensor, b: int) -> torch.Tensor:
    return positions[None, :].expand(b, positions.shape[0])


# ---------------------------------------------------------------------------
# the split over the model axis
# ---------------------------------------------------------------------------
def _kv_use(k, q_heads: slice, kv_heads: slice, g: int):
    """The kv heads of ``k`` (``kv_heads`` of the layer's) that the query
    heads ``q_heads`` attend to, as a tensor whose heads group them
    evenly (GQA): a contiguous slice, or one kv head per query head."""
    need = [i // g - kv_heads.start for i in range(q_heads.start,
                                                    q_heads.stop)]
    lo, hi = need[0], need[-1] + 1
    n = q_heads.stop - q_heads.start
    if n % (hi - lo) == 0 and all(
            j == lo + i // (n // (hi - lo)) for i, j in enumerate(need)):
        return k[:, :, lo:hi] if (lo, hi) != (0, k.shape[2]) else k
    return k[:, :, need]


class _Split:
    """How one attention layer splits over ``tp``: ``heads`` whether the
    axis divides its query heads (then this rank computes ``q`` of them
    and leaves by a row-parallel ``wo``), ``kv`` the kv heads it
    computes and caches (its shard, or all)."""

    def __init__(self, cfg, tp, mla: bool = False):
        h, hkv = cfg.num_heads, (cfg.num_heads if mla else
                                 cfg.num_kv_heads)
        self.tp = tp
        self.heads = T.splits(tp, h)
        self.q = T.span(tp, h) if self.heads else slice(0, h)
        self.kv = (T.span(tp, hkv) if self.heads and T.splits(tp, hkv)
                   else slice(0, hkv))
        self.g = h // hkv

    def w(self, w, n: int, dim: int, name: str):
        """A weight of ``n`` along ``dim`` that this rank uses whole
        (gathered where stored split), entered where the rank uses it
        in a partial region."""
        w = T.gather(w, self.tp, dim, n, name)
        return T.enter(w, self.tp) if self.heads else w

    def shared(self, t):
        """A value every rank holds whole, used in the partial region."""
        return T.enter(t, self.tp) if self.heads else t


# ---------------------------------------------------------------------------
# GQA attention block (self / cross / cached decode)
# ---------------------------------------------------------------------------
def apply_attention(params, cfg, x, *, positions, causal=True,
                    local: bool = False, cross: bool = False,
                    cache=None, decode_pos=None, kv_x=None, use_rope=True,
                    tp=None):
    """Returns (out, new_cache).

    * prefill: ``cache=None`` -> new_cache holds this segment's K/V
      (ring-buffered to ``window`` when ``local``).
    * decode: ``cache`` given, ``x`` is (B,1,D), ``decode_pos`` an int;
      the new K/V are written into ``cache`` in place.
    * cross: ``kv_x`` is the encoder output at prefill (cache stores the
      projected K/V); at decode the cross cache is static.
    * ``tp``: the model axis (module docstring); the cache holds the kv
      heads this rank computes.
    """
    b, sq, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    window = cfg.window if local else 0
    sp = _Split(cfg, tp)
    if sp.heads:
        wq, wo = params["wq"], params["wo"]
        kv_own = sp.kv.stop - sp.kv.start < hkv
        wk = params["wk"] if kv_own else sp.w(params["wk"], hkv * hd, 1,
                                              "attn.wk")
        wv = params["wv"] if kv_own else sp.w(params["wv"], hkv * hd, 1,
                                              "attn.wv")
        x = T.enter(x, tp)
        if kv_x is not None:
            kv_x = T.enter(kv_x, tp)
    else:
        wq, wk, wv = (T.gather(params[n], tp, 1, hh * hd, f"attn.{n}")
                      for n, hh in (("wq", h), ("wk", hkv), ("wv", hkv)))
        wo = T.gather(params["wo"], tp, 0, h * hd, "attn.wo")
    nq = sp.q.stop - sp.q.start
    nkv = sp.kv.stop - sp.kv.start

    def attend_kv(k):
        return _kv_use(k, sp.q, sp.kv, sp.g) if sp.heads else k

    def out_proj(out):
        out = dense(out.reshape(b, sq, nq * hd), wo)
        return T.leave(out, tp) if sp.heads else out

    q = dense(x, wq).reshape(b, sq, nq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, sp.shared(params["q_norm"]), cfg.norm_eps)

    is_decode = cache is not None and decode_pos is not None

    if cross:
        if kv_x is not None:       # prefill: project encoder output once
            k = dense(kv_x, wk).reshape(b, -1, nkv, hd)
            v = dense(kv_x, wv).reshape(b, -1, nkv, hd)
            new_cache = {"k": k, "v": v}
        else:                      # decode: static projected cache
            new_cache = cache
            k, v = cache["k"], cache["v"]
        out = _sdpa(q, attend_kv(k), attend_kv(v), cfg=cfg,
                    q_positions=positions, causal=False)
        return out_proj(out), new_cache

    k = dense(x, wk).reshape(b, sq, nkv, hd)
    v = dense(x, wv).reshape(b, sq, nkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, sp.shared(params["k_norm"]), cfg.norm_eps)
    if use_rope:
        pos2d = _positions_2d(positions, b)
        q = rope(q, pos2d, cfg.rope_theta)
        k = rope(k, pos2d, cfg.rope_theta)

    if is_decode:
        kc, vc = cache["k"], cache["v"]
        cap = kc.shape[1]
        slot = decode_pos % cap if window else decode_pos
        kc[:, slot:slot + 1] = k.to(kc.dtype)
        vc[:, slot:slot + 1] = v.to(vc.dtype)
        if window:
            out = _sdpa_chunked(q, attend_kv(kc), attend_kv(vc),
                                q_positions=positions, causal=False,
                                kv_valid=min(decode_pos + 1, cap),
                                chunk_kv=cfg.chunk_kv)
        else:
            out = _sdpa_chunked(q, attend_kv(kc), attend_kv(vc),
                                q_positions=positions, causal=True,
                                kv_valid=decode_pos + 1,
                                chunk_kv=cfg.chunk_kv)
        return out_proj(out), cache

    # prefill
    if local:
        out = _local_attention(q, attend_kv(k), attend_kv(v), window)
        # ring-buffer invariant: absolute position p lives at slot p % window
        if sq >= window:
            ring_k = torch.roll(k[:, -window:], sq % window, dims=1)
            ring_v = torch.roll(v[:, -window:], sq % window, dims=1)
        else:
            ring_k = _pad_seq(k, window - sq)
            ring_v = _pad_seq(v, window - sq)
        new_cache = {"k": ring_k, "v": ring_v}
    else:
        out = _sdpa(q, attend_kv(k), attend_kv(v), cfg=cfg,
                    q_positions=positions, causal=causal)
        new_cache = {"k": k, "v": v}
    out = shard_act(out.reshape(b, sq, nq * hd), "batch", "seq", "ffn")
    return out_proj(out), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def _mla_q(params, cfg, x, sp):
    b, sq, _ = x.shape
    h = cfg.num_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(dense(x, params["q_down"]), params["q_norm"],
                     cfg.norm_eps)
        q = dense(sp.shared(cq), _mla_w(params["q_up"], sp, h * qk, "q_up"))
    else:
        q = dense(sp.shared(x), _mla_w(params["wq"], sp, h * qk, "wq"))
    q = q.reshape(b, sq, sp.q.stop - sp.q.start, qk)
    return q[..., :cfg.nope_head_dim], q[..., cfg.nope_head_dim:]


def _mla_w(w, sp, n: int, name: str, dim: int = 1):
    """A head-split MLA weight: this rank's heads, else whole."""
    return w if sp.heads else T.gather(w, sp.tp, dim, n, f"mla.{name}")


def apply_mla(params, cfg, x, *, positions, cache=None, decode_pos=None,
              tp=None):
    """Returns (out, new_cache); cache = {c_kv (B,S,r), k_rope (B,S,rd)}.

    On ``tp`` the compressed projections run whole on every rank and the
    head-split ones on this rank's heads."""
    b, sq, d = x.shape
    h = cfg.num_heads
    nope, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    scale = (nope + rd) ** -0.5
    pos2d = _positions_2d(positions, b)
    sp = _Split(cfg, tp, mla=True)
    nh = sp.q.stop - sp.q.start

    q_nope, q_rope = _mla_q(params, cfg, x, sp)
    q_rope = rope(q_rope, pos2d, cfg.rope_theta)

    ckv_full = dense(x, params["kv_down"])
    c_kv = rmsnorm(ckv_full[..., :cfg.kv_lora_rank], params["kv_norm"],
                   cfg.norm_eps)
    k_rope = rope(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :],
                  pos2d, cfg.rope_theta)[:, :, 0, :]
    k_up = _mla_w(params["k_up"], sp, h * nope, "k_up")
    v_up = _mla_w(params["v_up"], sp, h * vd, "v_up")
    wo = _mla_w(params["wo"], sp, h * vd, "wo", 0)

    def out_proj(out):
        out = dense(out, wo)
        return T.leave(out, tp) if sp.heads else out

    if cache is not None and decode_pos is not None:
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        ckv_c[:, decode_pos:decode_pos + 1] = c_kv.to(ckv_c.dtype)
        kr_c[:, decode_pos:decode_pos + 1] = k_rope.to(kr_c.dtype)
        # absorbed decode
        w_kup = k_up.reshape(cfg.kv_lora_rank, nh, nope)
        w_vup = v_up.reshape(cfg.kv_lora_rank, nh, vd)
        q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope.float(),
                             w_kup.float())
        s = (torch.einsum("bqhl,bsl->bhqs", q_abs, ckv_c.float())
             + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                            kr_c.float())) * scale
        kvpos = torch.arange(ckv_c.shape[1], device=x.device)
        s = torch.where(kvpos[None, None, None, :] <= decode_pos, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqs,bsl->bqhl", p, ckv_c.float())
        out = torch.einsum("bqhl,lhv->bqhv", ctx, w_vup.float())
        out = out.to(x.dtype).reshape(b, sq, nh * vd)
        return out_proj(out), cache

    # prefill: expanded attention
    c_in, kr_in = sp.shared(c_kv), sp.shared(k_rope)
    k_nope = dense(c_in, k_up).reshape(b, sq, nh, nope)
    v = dense(c_in, v_up).reshape(b, sq, nh, vd)
    k_rope_b = kr_in[:, :, None, :].expand(b, sq, nh, rd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    # pad v to qk dim for the shared attention, crop after
    vpad = F.pad(v, (0, nope + rd - vd))
    out = _sdpa(q, k, vpad, cfg=cfg, q_positions=positions,
                causal=True)[..., :vd]
    out = out.reshape(b, sq, nh * vd)
    new_cache = {"c_kv": c_kv, "k_rope": k_rope}
    return out_proj(out), new_cache
