"""The port's LM substrate against the reference, architecture by
architecture (``repro_torch.models`` vs ``repro.models``).

Every architecture of ``ARCH_IDS`` at its smoke size, with the
reference's float32 weights carried across
(``models.convert.params_from_reference``) and the same numpy inputs:
``forward`` logits, ``prefill`` logits and caches, and one
``decode_step``, within the reference's own bounds (1e-4 of the logits'
peak for forward and prefill, 2e-3 for decode; caches 1e-4 of each
leaf's peak).  Also the port's own decode-vs-teacher-forcing check,
every full config's parameter count (specs only, nothing materialised)
and the cache shape trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import Model as RModel
from repro.parallel.sharding import count_params as r_count_params
from repro.parallel.sharding import init_params as r_init_params
from repro_torch.configs import (ALIASES, ARCH_IDS, get_config,
                                 get_smoke_config)
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference
from repro_torch.parallel.sharding import count_params, init_params

B, S, EXTRA = 2, 24, 4
PREFILL_REL = 1e-4
DECODE_REL = 2e-3


def _inputs(cfg, seq, seed=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size,
                                    (B, seq)).astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["patch_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["audio_embed"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _prefix(batch, s):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :s]
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_RUNS = {}


def _run(arch):
    """Reference and port on the same weights and inputs, once per arch
    (one jit of the reference per architecture)."""
    if arch in _RUNS:
        return _RUNS[arch]
    rcfg = r_get_smoke_config(arch)
    rm = RModel(rcfg)
    rp = r_init_params(rm.specs(), jax.random.key(1), jnp.float32)
    batch = _inputs(rcfg, S + 1)

    def ref_all(p, b):
        logits, aux = rm.forward(p, b)
        last, cache = rm.prefill(p, _prefix(b, S), max_len=S + EXTRA)
        dec, cache2 = rm.decode_step(p, cache, b["tokens"][:, S:S + 1],
                                     jnp.int32(S))
        return logits, aux, last, cache, dec, cache2, rm.loss(p, b)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.tree.map(np.asarray, jax.jit(ref_all)(rp, jb))
    model = params_from_reference(Model(get_smoke_config(arch)),
                                  jax.tree.map(np.asarray, rp),
                                  device="cpu")
    tb = _torch(batch)
    with torch.inference_mode():
        logits, aux = model.forward(tb)
        last, cache = model.prefill(_prefix(tb, S), max_len=S + EXTRA)
        pre_cache = jax.tree.map(lambda t: t.clone(), cache)
        dec, cache2 = model.decode_step(cache, tb["tokens"][:, S:S + 1], S)
        loss = model.loss(tb)
    got = (logits, aux, last, pre_cache, dec, cache2, loss)
    _RUNS[arch] = (ref, got)
    return _RUNS[arch]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-9
    return float(np.abs(got - want).max()) / scale


def _compare_caches(got, want, rel, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _compare_caches(got[k], want[k], rel, f"{path}/{k}")
        return
    g = got.numpy()
    assert g.dtype == want.dtype, (path, g.dtype, want.dtype)
    assert _rel(g, want) <= rel, (path, _rel(g, want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    (logits, aux, *_), (t_logits, t_aux, *_) = _run(arch)
    assert tuple(t_logits.shape) == logits.shape == (
        B, S + 1, get_smoke_config(arch).vocab_size)
    assert _rel(t_logits, logits) <= PREFILL_REL, arch
    assert abs(float(t_aux) - float(aux)) <= 1e-5 * max(1.0, abs(float(aux)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch):
    (_, _, last, cache, *_), (_, _, t_last, t_cache, *_) = _run(arch)
    assert _rel(t_last, last) <= PREFILL_REL, arch
    _compare_caches(t_cache, cache, PREFILL_REL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference(arch):
    (*_, dec, cache2, _), (*_, t_dec, t_cache2, _) = _run(arch)
    assert _rel(t_dec, dec) <= DECODE_REL, arch
    _compare_caches(t_cache2, cache2, DECODE_REL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_matches_reference(arch):
    """``loss``: next-token cross entropy plus 0.01 x the MoE balance
    loss, and its parts."""
    *_, (loss, parts) = _run(arch)[0]
    *_, (t_loss, t_parts) = _run(arch)[1]
    for got, want in ((t_loss, loss), (t_parts["ce"], parts["ce"]),
                      (t_parts["aux"], parts["aux"])):
        assert abs(float(got) - float(want)) <= 1e-5 * max(
            1.0, abs(float(want))), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_teacher_forcing(arch):
    """The port alone: prefill(S) + decode_step(S) equals forward(S+1) at
    positions S-1 and S (MoE capacity drops disabled, as the reference's
    own test does)."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    model = Model(cfg)
    model.load_params(init_params(model.specs(), 1, torch.float32, "cpu"))
    batch = _torch(_inputs(cfg, S + 1))
    with torch.inference_mode():
        ref, _ = model.forward(batch)
        last, cache = model.prefill(_prefix(batch, S), max_len=S + 8)
        dec, _ = model.decode_step(cache, batch["tokens"][:, S:S + 1], S)
    scale = float(ref[:, S - 1].abs().max()) + 1e-9
    assert float((ref[:, S - 1] - last[:, 0]).abs().max()) / scale < 1e-4
    assert float((ref[:, S] - dec[:, 0]).abs().max()) / scale < 2e-3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count_matches_reference(arch):
    cfg = get_config(arch)
    assert cfg.__dict__ == r_get_config(arch).__dict__
    assert count_params(Model(cfg).specs()) == \
        r_count_params(RModel(r_get_config(arch)).specs())


def _shape_tree(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda v: isinstance(v, tuple))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shapes_match_reference(arch):
    for get, r_get in ((get_smoke_config, r_get_smoke_config),
                       (get_config, r_get_config)):
        for batch, max_len in ((1, 64), (3, 1024)):
            got = Model(get(arch)).cache_shapes(batch, max_len)
            want = RModel(r_get(arch)).cache_shapes(batch, max_len)
            assert _shape_tree(got) == _shape_tree(want), arch


def _cache_size(model, max_len):
    return sum(int(np.prod(s)) for s in jax.tree.leaves(
        model.cache_shapes(1, max_len),
        is_leaf=lambda v: isinstance(v, tuple)))


def test_long_context_states_are_o1():
    """SSM / hybrid decode state does not grow with the context; a full
    attention cache does."""
    for arch in ("mamba2_2_7b", "recurrentgemma_2b"):
        model = Model(get_smoke_config(arch))
        assert _cache_size(model, 1024) == _cache_size(model, 1024 * 512)
    model = Model(get_smoke_config("phi3_medium_14b"))
    assert _cache_size(model, 256) > _cache_size(model, 128)


def test_registry_resolves_aliases_and_refuses_unknown():
    assert set(ALIASES.values()) == set(ARCH_IDS)
    for alias, arch in ALIASES.items():
        assert get_config(alias) == get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-17")


def test_init_cache_dtypes_follow_the_reference():
    """``h`` / ``ssm`` leaves are float32, the others the parameters'."""
    model = Model(get_smoke_config("recurrentgemma_2b"))
    model.load_params(init_params(model.specs(), 0, torch.bfloat16, "cpu"))
    cache = model.init_cache(2, 8)
    leaves = {}
    jax.tree_util.tree_map_with_path(
        lambda p, t: leaves.setdefault(str(p[-1].key), set()).add(t.dtype),
        cache)
    assert leaves["h"] == {torch.float32}
    assert leaves["k"] == leaves["conv"] == {torch.bfloat16}


def test_ring_cache_shorter_than_the_window():
    """A local-attention prefill of fewer tokens than the window into a
    cache of ``max_len < window`` slots: the port crops the ring's
    padding and decodes as teacher forcing does.  The reference raises
    there (its ``dynamic_update_slice`` of the padded ring)."""
    cfg = get_smoke_config("recurrentgemma_2b")     # window 16
    s, max_len = 8, 12
    model = Model(cfg)
    model.load_params(init_params(model.specs(), 2, torch.float32, "cpu"))
    batch = _torch(_inputs(cfg, s + 1))
    with torch.inference_mode():
        ref, _ = model.forward(batch)
        _, cache = model.prefill(_prefix(batch, s), max_len=max_len)
        dec, _ = model.decode_step(cache, batch["tokens"][:, s:s + 1], s)
    assert _rel(dec[:, 0], ref[:, s]) < 2e-3

    rm = RModel(r_get_smoke_config("recurrentgemma_2b"))
    rp = r_init_params(rm.specs(), jax.random.key(2), jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _inputs(cfg, s).items()}
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        rm.prefill(rp, jb, max_len=max_len)


def test_bf16_params_with_float32_audio_embed():
    """bfloat16 weights and a float32 ``audio_embed`` (whisper smoke):
    jnp promotes, so the reference's encoder runs in float32 and its
    logits come out bfloat16; the port matches each stage's dtype, and
    its values sit within 2e-2 of the reference's peak (bfloat16 noise:
    one bfloat16 step is 2^-8 of a value)."""
    arch = "whisper_large_v3"
    rcfg = r_get_smoke_config(arch)
    rm = RModel(rcfg)
    rp = r_init_params(rm.specs(), jax.random.key(1), jnp.bfloat16)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    audio = rng.normal(size=(2, rcfg.encoder_seq, rcfg.d_model)).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(tokens), "audio_embed": jnp.asarray(audio)}

    def ref_all(p, b):
        return (rm.forward(p, b)[0], rm._encode(p, b["audio_embed"]),
                rm.prefill(p, b), rm.prefill(p, b, max_len=10))

    logits, enc, (last, cache), (last10, cache10) = jax.jit(ref_all)(rp, jb)
    model = params_from_reference(Model(get_smoke_config(arch)),
                                  jax.tree.map(np.asarray, rp), device="cpu")
    tb = {"tokens": torch.from_numpy(tokens),
          "audio_embed": torch.from_numpy(audio)}
    with torch.inference_mode():
        t_logits, _ = model.forward(tb)
        t_enc = model._encode(model.param_tree(), tb["audio_embed"])
        t_last, t_cache = model.prefill(tb)
        t_last10, t_cache10 = model.prefill(tb, max_len=10)
    for got, want, rel in ((t_logits, logits, 2e-2), (t_enc, enc, 1e-5),
                           (t_last, last, 2e-2), (t_last10, last10, 2e-2)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert tuple(got.shape) == want.shape
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < rel
    assert str(t_enc.dtype) == "torch.float32"
    for got, want in ((t_cache, cache), (t_cache10, cache10)):
        got_dt = jax.tree.map(lambda t: str(t.dtype).split(".")[-1], got)
        assert got_dt == jax.tree.map(lambda a: str(a.dtype), want)
