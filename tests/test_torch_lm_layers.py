"""The LM substrate's layers in the port against the reference
(``repro_torch.models.{layers,attention,rglru,ssm,moe}`` vs ``repro``'s).

Every case feeds the same numpy inputs and weights (drawn from a seeded
``numpy`` generator) to both packages and compares in float32 within
``REL`` of the reference output's peak; the attention and scan cases run
at sequence lengths past their chunk or window so the chunked paths are
taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import rglru as RG
from repro.models import ssm as RS
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TG
from repro_torch.models import ssm as TS
from repro_torch.parallel.sharding import map_specs

REL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-12)


def _pair(arr):
    """One numpy array as (jax, torch) inputs."""
    arr = np.asarray(arr)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _weights(specs, seed, scale=None):
    """Numpy weights for a spec tree, as (jax tree, torch tree)."""
    rng = np.random.default_rng(seed)

    def one(_path, spec):
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = scale or (spec.scale if spec.scale is not None
                        else fan_in ** -0.5)
        return (rng.normal(size=spec.shape) * std).astype(np.float32)

    tree = map_specs(one, specs)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


def _ref(fn, *args, **kw):
    """A reference function under ``jax.jit`` (one compile, not one per
    primitive): array (and dict) positional arguments are traced, the
    others and the keyword arguments closed over."""
    traced = [i for i, a in enumerate(args)
              if isinstance(a, (jax.Array, dict))]

    def call(*xs):
        full = list(args)
        for i, x in zip(traced, xs):
            full[i] = x
        return fn(*full, **kw)

    return jax.jit(call)(*(args[i] for i in traced))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rmsnorm_and_rope():
    xj, xt = _pair(_normal(0, 2, 9, 4, 16) * 3)
    sj, st = _pair(_normal(1, 16))
    want = _ref(RL.rmsnorm, xj, sj, 1e-6)
    assert _rel(TL.rmsnorm(xt, st, 1e-6), want) <= REL
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    pj, pt = _pair(pos)
    for theta in (1e4, 1e6):
        want = _ref(RL.rope, xj, pj, theta)
        assert _rel(TL.rope(xt, pt, theta), want) <= REL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    wj, wt = _weights(TL.mlp_specs(32, 48, act), 2)
    xj, xt = _pair(_normal(3, 2, 5, 32) * 2)
    want = _ref(RL.apply_mlp, wj, xj, act)
    assert _rel(TL.apply_mlp(wt, xt, act), want) <= REL


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu``'s default: the exact erf form differs by ~1e-4."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert _rel(TL.gelu(torch.from_numpy(x)), want) <= REL
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _rel(exact, want) > 1e-5


def test_cross_entropy_loss_with_and_without_mask():
    lj, lt = _pair(_normal(8, 2, 5, 11) * 4)
    yj, yt = _pair(np.random.default_rng(9).integers(0, 11, (2, 5))
                   .astype(np.int32))
    mj, mt = _pair((np.arange(10).reshape(2, 5) % 3 > 0)
                   .astype(np.float32))
    assert _rel(TL.cross_entropy_loss(lt, yt),
                _ref(RL.cross_entropy_loss, lj, yj)) <= REL
    assert _rel(TL.cross_entropy_loss(lt, yt, mt),
                _ref(RL.cross_entropy_loss, lj, yj, mj)) <= REL


def test_causal_conv1d_with_and_without_state():
    wj, wt = _weights(TL.causal_conv1d_specs(12, 4), 4)
    wj["conv_b"] = jnp.asarray(_normal(5, 12))
    wt["conv_b"] = torch.from_numpy(np.asarray(wj["conv_b"]).copy())
    xj, xt = _pair(_normal(6, 2, 7, 12))
    yj, sj = _ref(RL.apply_causal_conv1d, wj, xj)
    yt, s_t = TL.apply_causal_conv1d(wt, xt)
    assert _rel(yt, yj) <= REL and _rel(s_t, sj) <= REL
    cj, ct = _pair(_normal(7, 2, 3, 12))
    yj, sj = _ref(RL.apply_causal_conv1d, wj, xj[:, :1], cj)
    yt, s_t = TL.apply_causal_conv1d(wt, xt[:, :1], ct)
    assert _rel(yt, yj) <= REL and _rel(s_t, sj) <= REL


def _qkv(seed, sq, skv, h=4, hkv=2, hd=8):
    return (_pair(_normal(seed, 2, sq, h, hd)),
            _pair(_normal(seed + 1, 2, skv, hkv, hd)),
            _pair(_normal(seed + 2, 2, skv, hkv, hd)))


@pytest.mark.parametrize("causal,window,kv_valid", [
    (True, 0, None), (False, 0, None), (True, 5, None), (False, 0, 13)])
def test_sdpa_chunked(causal, window, kv_valid):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(10, 19, 19)
    pj, pt = _pair(np.arange(19, dtype=np.int32))
    kw = dict(causal=causal, window=window, chunk_kv=8)
    want = _ref(RA._sdpa_chunked, qj, kj, vj, q_positions=pj,
                kv_valid=kv_valid, **kw)
    got = TA._sdpa_chunked(qt, kt, vt, q_positions=pt, kv_valid=kv_valid,
                           **kw)
    assert _rel(got, want) <= REL


def test_sdpa_qchunked_and_segmented():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(20, 21, 21)
    pj, pt = _pair(np.arange(21, dtype=np.int32))
    want = _ref(RA._sdpa_qchunked, qj, kj, vj, q_positions=pj, causal=True,
                chunk_q=8, chunk_kv=8)
    got = TA._sdpa_qchunked(qt, kt, vt, q_positions=pt, causal=True,
                            chunk_q=8, chunk_kv=8)
    assert _rel(got, want) <= REL
    want = _ref(RA._sdpa_segmented, qj, kj, vj, q_positions=pj,
                causal=True, segments=3, chunk_kv=8)
    got = TA._sdpa_segmented(qt, kt, vt, q_positions=pt, causal=True,
                             segments=3, chunk_kv=8)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("impl", ["chunked", "qchunked", "segmented"])
def test_sdpa_dispatch(impl):
    rcfg = r_get_smoke_config("tinyllama_1_1b").replace(
        attn_impl=impl, chunk_q=8, chunk_kv=8, attn_segments=3)
    cfg = get_smoke_config("tinyllama_1_1b").replace(
        attn_impl=impl, chunk_q=8, chunk_kv=8, attn_segments=3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(30, 21, 21)
    pj, pt = _pair(np.arange(21, dtype=np.int32))
    want = _ref(RA._sdpa, qj, kj, vj, cfg=rcfg, q_positions=pj, causal=True)
    got = TA._sdpa(qt, kt, vt, cfg=cfg, q_positions=pt, causal=True)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("s", [11, 16])
def test_local_attention(s):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(40, s, s)
    assert _rel(TA._local_attention(qt, kt, vt, 4),
                _ref(RA._local_attention, qj, kj, vj, 4)) <= REL


@pytest.mark.parametrize("local", [False, True])
def test_attention_prefill_and_decode(local):
    """apply_attention's prefill (cache incl. the ring buffer past the
    window) and one decode step against a max_len cache."""
    rcfg = r_get_smoke_config("recurrentgemma_2b").replace(window=8)
    cfg = get_smoke_config("recurrentgemma_2b").replace(window=8)
    wj, wt = _weights(TA.attn_specs(cfg), 41)
    s, max_len = 13, 16
    xj, xt = _pair(_normal(42, 2, s, cfg.d_model))
    pj, pt = _pair(np.arange(s, dtype=np.int32))
    oj, cj = _ref(RA.apply_attention, wj, rcfg, xj, positions=pj, local=local)
    ot, ct = TA.apply_attention(wt, cfg, xt, positions=pt, local=local)
    assert _rel(ot, oj) <= REL
    for k in ("k", "v"):
        assert _rel(ct[k], cj[k]) <= REL
    cap = cj["k"].shape[1] if local else max_len
    full_j = {k: jnp.zeros((2, cap) + cj[k].shape[2:]).at[:, :cj[k].shape[1]]
              .set(cj[k]) for k in cj}
    full_t = {k: torch.from_numpy(np.array(full_j[k])) for k in full_j}
    x1j, x1t = _pair(_normal(43, 2, 1, cfg.d_model))
    p1j, p1t = _pair(np.array([s], np.int32))
    oj, nj = _ref(RA.apply_attention, wj, rcfg, x1j, positions=p1j,
                  local=local, cache=full_j, decode_pos=jnp.int32(s))
    ot, nt = TA.apply_attention(wt, cfg, x1t, positions=p1t, local=local,
                                cache=full_t, decode_pos=s)
    assert _rel(ot, oj) <= REL
    for k in ("k", "v"):
        assert _rel(nt[k], nj[k]) <= REL


def test_linear_scan_is_the_recurrence():
    a = np.random.default_rng(50).uniform(0, 1, (2, 37, 5)).astype(np.float32)
    x = _normal(51, 2, 37, 5)
    h = np.zeros((2, 5), np.float64)
    want = []
    for t in range(37):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    got = TG.linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert _rel(got, np.stack(want, 1)) <= REL


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan(carried):
    """The RG-LRU block over 37 steps, fresh and with a carried ``h`` and
    conv state (the state injected at step 0)."""
    rcfg = r_get_smoke_config("recurrentgemma_2b")
    cfg = get_smoke_config("recurrentgemma_2b")
    wj, wt = _weights(TG.rglru_specs(cfg), 52)
    xj, xt = _pair(_normal(53, 2, 37, cfg.d_model))
    cache_j = cache_t = None
    if carried:
        hj, ht = _pair(_normal(54, 2, cfg.lru_width))
        sj, st = _pair(_normal(55, 2, cfg.conv_width - 1, cfg.lru_width))
        cache_j, cache_t = {"h": hj, "conv": sj}, {"h": ht, "conv": st}
    oj, nj = _ref(RG.apply_rglru, wj, rcfg, xj, cache=cache_j)
    ot, nt = TG.apply_rglru(wt, cfg, xt, cache=cache_t)
    assert _rel(ot, oj) <= 1e-4
    assert _rel(nt["h"], nj["h"]) <= 1e-4
    assert _rel(nt["conv"], nj["conv"]) <= REL
    # one decode step from the carried state
    x1j, x1t = _pair(_normal(56, 2, 1, cfg.d_model))
    oj, _ = _ref(RG.apply_rglru, wj, rcfg, x1j, cache=nj, decode=True)
    ot, _ = TG.apply_rglru(wt, cfg, x1t, cache=nt, decode=True)
    assert _rel(ot, oj) <= 1e-4


def test_ssd_chunked_past_a_partial_chunk():
    """S = 45 over chunks of 16: the last chunk is padded with dt = 0."""
    b, s, h, p, n = 2, 45, 3, 4, 5
    xj, xt = _pair(_normal(60, b, s, h, p))
    dt = np.log1p(np.exp(_normal(61, b, s, h)))
    dj, dt_t = _pair(dt.astype(np.float32))
    aj, at = _pair(-np.exp(_normal(62, h)))
    bj, bt = _pair(_normal(63, b, s, h, n))
    cj, ct = _pair(_normal(64, b, s, h, n))
    yj, fj = _ref(RS._ssd_chunked, xj, dj, aj, bj, cj, 16)
    yt, ft = TS._ssd_chunked(xt, dt_t, at, bt, ct, 16)
    assert _rel(yt, yj) <= 1e-4 and _rel(ft, fj) <= 1e-4


def test_mamba_block_prefill_and_decode():
    rcfg = r_get_smoke_config("mamba2_2_7b").replace(ssm_chunk=8)
    cfg = get_smoke_config("mamba2_2_7b").replace(ssm_chunk=8)
    wj, wt = _weights(TS.mamba_specs(cfg), 65)
    xj, xt = _pair(_normal(66, 2, 19, cfg.d_model))
    oj, nj = _ref(RS.apply_mamba, wj, rcfg, xj)
    ot, nt = TS.apply_mamba(wt, cfg, xt)
    assert _rel(ot, oj) <= 1e-4
    assert _rel(nt["ssm"], nj["ssm"]) <= 1e-4
    x1j, x1t = _pair(_normal(67, 2, 1, cfg.d_model))
    oj, _ = _ref(RS.apply_mamba, wj, rcfg, x1j, cache=nj, decode=True)
    ot, _ = TS.apply_mamba(wt, cfg, x1t, cache=nt, decode=True)
    assert _rel(ot, oj) <= 1e-4


def _moe_case(seed, tied: bool):
    rcfg = r_get_smoke_config("qwen3_moe_235b_a22b").replace(
        capacity_factor=1.0)
    cfg = get_smoke_config("qwen3_moe_235b_a22b").replace(
        capacity_factor=1.0)
    wj, wt = _weights(TMOE.moe_specs(cfg), seed)
    t = 80
    x = _normal(seed + 1, t, cfg.d_model)
    if tied:   # every token routes to experts 0 and 1: full experts drop
        router = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
        router[:, :2] = 1.0
        x = np.abs(x) + 0.1
        wj["router"] = jnp.asarray(router)
        wt["router"] = torch.from_numpy(router)
    xj, xt = _pair(x)
    return rcfg, cfg, wj, wt, xj, xt


@pytest.mark.parametrize("tied", [False, True])
def test_moe_tokens_with_capacity_drops(tied):
    """capacity_factor 1.0 over 80 tokens (capacity 32 per expert): the
    reference's drops, kept to the token; with every token tied on
    experts 0 and 1 only a stable sort keeps the reference's 32."""
    rcfg, cfg, wj, wt, xj, xt = _moe_case(70, tied)
    oj, aj = _ref(RMOE._moe_tokens, wj, rcfg, xj)
    ot, at = TMOE._moe_tokens(wt, cfg, xt)
    assert _rel(ot, oj) <= 1e-4
    assert abs(float(at) - float(aj)) <= 1e-5 * max(1.0, abs(float(aj)))
    if tied:
        kept = (np.abs(np.asarray(oj)).sum(-1) > 0).sum()
        assert kept == 32, kept   # tokens 0..31 keep both experts


def test_moe_unstable_order_would_differ(monkeypatch):
    """The tied case catches a sort that breaks ties another way: the
    port with the ties reversed disagrees with the reference."""
    rcfg, cfg, wj, wt, xj, xt = _moe_case(70, True)
    oj, _ = _ref(RMOE._moe_tokens, wj, rcfg, xj)
    real = torch.argsort

    def reversed_ties(x, stable=False):
        return (x.numel() - 1) - real(x.flip(0), stable=True)

    monkeypatch.setattr(TMOE.torch, "argsort", reversed_ties)
    ot, _ = TMOE._moe_tokens(wt, cfg, xt)
    assert _rel(ot, oj) > 1e-2


def test_moe_block_with_shared_experts():
    rcfg = r_get_smoke_config("deepseek_v2_236b")
    cfg = get_smoke_config("deepseek_v2_236b")
    wj, wt = _weights(TMOE.moe_specs(cfg), 80)
    xj, xt = _pair(_normal(81, 2, 9, cfg.d_model))
    oj, aj = _ref(RMOE.apply_moe, wj, rcfg, xj)
    ot, at = TMOE.apply_moe(wt, cfg, xt)
    assert _rel(ot, oj) <= 1e-4
    assert abs(float(at) - float(aj)) <= 1e-5 * max(1.0, abs(float(aj)))


def test_mla_prefill_and_absorbed_decode():
    rcfg = r_get_smoke_config("deepseek_v2_236b")
    cfg = get_smoke_config("deepseek_v2_236b")
    wj, wt = _weights(TA.mla_specs(cfg), 90)
    s, max_len = 11, 16
    xj, xt = _pair(_normal(91, 2, s, cfg.d_model))
    pj, pt = _pair(np.arange(s, dtype=np.int32))
    oj, cj = _ref(RA.apply_mla, wj, rcfg, xj, positions=pj)
    ot, ct = TA.apply_mla(wt, cfg, xt, positions=pt)
    assert _rel(ot, oj) <= REL
    for k in ("c_kv", "k_rope"):
        assert _rel(ct[k], cj[k]) <= REL
    full_j = {k: jnp.zeros((2, max_len, cj[k].shape[2])).at[:, :s].set(cj[k])
              for k in cj}
    full_t = {k: torch.from_numpy(np.array(full_j[k])) for k in full_j}
    x1j, x1t = _pair(_normal(92, 2, 1, cfg.d_model))
    p1j, p1t = _pair(np.array([s], np.int32))
    oj, nj = _ref(RA.apply_mla, wj, rcfg, x1j, positions=p1j, cache=full_j,
                  decode_pos=jnp.int32(s))
    ot, nt = TA.apply_mla(wt, cfg, x1t, positions=p1t, cache=full_t,
                          decode_pos=s)
    assert _rel(ot, oj) <= 1e-4
    for k in ("c_kv", "k_rope"):
        assert _rel(nt[k], nj[k]) <= REL
