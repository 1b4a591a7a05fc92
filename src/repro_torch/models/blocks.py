"""Transformer-block assembly: pre-norm residual blocks of every family
(the port of :mod:`repro.models.blocks`).  ``tp`` (the mesh's ``model``
axis, or ``None``) goes to every sublayer; the residual stream and the
norms stay whole on every rank."""
from __future__ import annotations

from .attention import apply_attention, apply_mla, attn_specs, mla_specs
from .layers import apply_mlp, mlp_specs, rmsnorm, rmsnorm_spec
from .moe import apply_moe, moe_specs
from .rglru import apply_rglru, rglru_cache_shapes, rglru_specs
from .ssm import apply_mamba, mamba_cache_shapes, mamba_specs

__all__ = ["block_specs", "apply_block", "block_cache_shapes",
           "CACHE_MODEL_DIMS"]

#: the dimension of each cache leaf (of one layer, batch first) that the
#: ``model`` axis splits where it divides it -- kv heads, recurrent and
#: conv channels, SSM heads; MLA's latent cache stays whole
#: (``launch/shapes.py:tp_cache_shardings`` places the cache by it)
CACHE_MODEL_DIMS = {"k": 2, "v": 2, "conv": 2, "h": 1, "ssm": 1}


def block_specs(cfg, blk: str, mlp: str, cross: bool = False):
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d)}
    if blk in ("attn", "local_attn"):
        s["attn"] = mla_specs(cfg) if cfg.is_mla else attn_specs(cfg)
    elif blk == "recurrent":
        s["rec"] = rglru_specs(cfg)
    elif blk == "mamba":
        s["mamba"] = mamba_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {blk!r}")
    if cross:
        s["ln_x"] = rmsnorm_spec(d)
        s["cross"] = attn_specs(cfg)
    if mlp == "dense":
        s["ln2"] = rmsnorm_spec(d)
        s["mlp"] = mlp_specs(d, cfg.d_ff, cfg.mlp_act)
    elif mlp == "moe":
        s["ln2"] = rmsnorm_spec(d)
        s["moe"] = moe_specs(cfg)
    return s


def block_cache_shapes(cfg, blk: str, cross: bool, batch: int, kv_len: int,
                       enc_len: int = 0):
    """Shape dict mirroring the cache tree of one block."""
    hkv, hd = cfg.num_kv_heads, cfg.hd
    if blk == "attn":
        if cfg.is_mla:
            c = {"c_kv": (batch, kv_len, cfg.kv_lora_rank),
                 "k_rope": (batch, kv_len, cfg.rope_head_dim)}
        else:
            c = {"k": (batch, kv_len, hkv, hd),
                 "v": (batch, kv_len, hkv, hd)}
    elif blk == "local_attn":
        w = min(cfg.window, kv_len)
        c = {"k": (batch, w, hkv, hd), "v": (batch, w, hkv, hd)}
    elif blk == "recurrent":
        c = rglru_cache_shapes(cfg, batch)
    elif blk == "mamba":
        c = mamba_cache_shapes(cfg, batch)
    else:
        raise ValueError(blk)
    out = {"self": c}
    if cross:
        out["cross"] = {"k": (batch, enc_len, hkv, hd),
                        "v": (batch, enc_len, hkv, hd)}
    return out


def apply_block(params, cfg, x, blk: str, mlp: str, *, positions,
                causal: bool = True, cache=None, decode_pos=None,
                enc_out=None, use_rope: bool = True, tp=None):
    """Returns (x, new_cache, aux).  ``cache``/``decode_pos`` given => decode
    (the cache is updated in place); cache None => prefill (new_cache
    still returned)."""
    aux = 0.0                      # a tensor where a MoE layer ran
    decode = cache is not None and decode_pos is not None
    self_cache = cache["self"] if decode else None

    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    if blk in ("attn", "local_attn"):
        if cfg.is_mla:
            sub, new_self = apply_mla(params["attn"], cfg, h,
                                      positions=positions, cache=self_cache,
                                      decode_pos=decode_pos, tp=tp)
        else:
            sub, new_self = apply_attention(
                params["attn"], cfg, h, positions=positions, causal=causal,
                local=(blk == "local_attn"), cache=self_cache,
                decode_pos=decode_pos, use_rope=use_rope, tp=tp)
    elif blk == "recurrent":
        sub, new_self = apply_rglru(params["rec"], cfg, h, cache=self_cache,
                                    decode=decode, tp=tp)
    elif blk == "mamba":
        sub, new_self = apply_mamba(params["mamba"], cfg, h,
                                    cache=self_cache, decode=decode, tp=tp)
    else:
        raise ValueError(blk)
    x = x + sub
    new_cache = {"self": new_self}

    if "cross" in params:
        hx = rmsnorm(x, params["ln_x"], cfg.norm_eps)
        sub, new_cross = apply_attention(
            params["cross"], cfg, hx, positions=positions, cross=True,
            cache=cache["cross"] if decode else None,
            decode_pos=decode_pos if decode else None,
            kv_x=None if decode else enc_out, use_rope=False, tp=tp)
        x = x + sub
        new_cache["cross"] = new_cross

    if mlp == "dense":
        x = x + apply_mlp(params["mlp"],
                          rmsnorm(x, params["ln2"], cfg.norm_eps),
                          cfg.mlp_act, tp, cfg.d_ff)
    elif mlp == "moe":
        sub, aux = apply_moe(params["moe"],
                             cfg, rmsnorm(x, params["ln2"], cfg.norm_eps),
                             tp)
        x = x + sub
    return x, new_cache, aux
