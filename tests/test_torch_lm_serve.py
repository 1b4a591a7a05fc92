"""The LM serving slice as a whole: ``serve --mode lm`` in the port
against the reference's, the token stream, and the weights carried
across (``repro_torch.models.convert``).

The slice test runs the reference's ``serve_lm`` (weights from
``jax.random.key(0)``) and the port's CLI on those same weights (the
port's ``init_params`` replaced by the reference's converted tree), and
requires equal greedy tokens.  A row may differ from some step on only
where the reference's own top-2 logit margin at that step is below 1e-4
of the logits' peak (a near tie that float32 summation order may break
either way); the test names such a step.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.data.synthetic import TokenStream as RTokenStream
from repro.launch import serve as RSERVE
from repro.models import Model as RModel
from repro.parallel.sharding import init_params as r_init_params
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import serve as TSERVE
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference, \
    params_to_numpy
from repro_torch.parallel.sharding import init_params

MARGIN_REL = 1e-4


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, batch_size=4, seed=1),
    dict(vocab_size=256, seq_len=32, batch_size=8),
    dict(vocab_size=32000, seq_len=7, batch_size=3, seed=5, shard=1,
         num_shards=2, noise=0.2)])
def test_token_stream_matches_reference(kw):
    for step in (0, 3):
        want = RTokenStream(**kw).batch(step)
        got = TokenStream(**kw).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = iter(TokenStream(**kw))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  TokenStream(**kw).batch(0)["tokens"])


def _reference_tree(arch, key=0):
    rm = RModel(r_get_smoke_config(arch))
    return rm, jax.tree.map(
        np.asarray, r_init_params(rm.specs(), jax.random.key(key),
                                  jnp.float32))


def test_params_round_trip_and_refuse_a_bad_tree():
    _, tree = _reference_tree("deepseek_v2_236b")
    cfg = get_smoke_config("deepseek_v2_236b")
    model = params_from_reference(Model(cfg), tree, device="cpu")
    names = dict(model.named_parameters())
    assert "embed.embedding" in names and "prefix.0.attn.kv_down" in names
    assert "body.0.moe.shared.w_gate" in names
    back = params_to_numpy(model)
    jax.tree.map(np.testing.assert_array_equal, back, tree)

    fresh = Model(cfg)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["body"]["0"]["attn"]["kv_norm"]
    with pytest.raises(ValueError, match=r"missing \['kv_norm'\]"):
        params_from_reference(fresh, missing, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["embed"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match=r"extra \['bias'\]"):
        params_from_reference(fresh, extra, device="cpu")
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm: shape"):
        params_from_reference(fresh, wrong, device="cpu")
    mixed = jax.tree.map(lambda a: a, tree)
    mixed["final_norm"] = mixed["final_norm"].astype(np.float64)
    with pytest.raises(TypeError, match="mixes dtypes"):
        params_from_reference(fresh, mixed, device="cpu")
    ints = jax.tree.map(lambda a: a, tree)
    ints["final_norm"] = ints["final_norm"].astype(np.int32)
    with pytest.raises(TypeError, match="parameters are floating"):
        params_from_reference(fresh, ints, device="cpu")


def test_init_params_is_per_leaf_and_seeded():
    model = Model(get_smoke_config("tinyllama_1_1b"))
    specs = model.specs()
    a = init_params(specs, 0, torch.float32, "cpu")
    b = init_params(specs, 0, torch.float32, "cpu")
    c = init_params(specs, 1, torch.float32, "cpu")
    assert torch.equal(a["body"]["0"]["attn"]["wq"],
                       b["body"]["0"]["attn"]["wq"])
    assert not torch.equal(a["body"]["0"]["attn"]["wq"],
                           c["body"]["0"]["attn"]["wq"])
    # a leaf's values do not depend on the rest of the tree
    alone = init_params({"body": {"0": {"attn": {"wq": specs["body"]["0"][
        "attn"]["wq"]}}}}, 0, torch.float32, "cpu")
    assert torch.equal(alone["body"]["0"]["attn"]["wq"],
                       a["body"]["0"]["attn"]["wq"])
    assert torch.equal(a["final_norm"], torch.ones(64))
    std = float(a["embed"]["embedding"].std())
    assert 0.018 < std < 0.022                      # spec scale 0.02


def _reference_margins(rm, tree, batch, gen):
    """The reference's logits along its own greedy tokens ``gen``: per
    step and row, the top-2 margin over the logits' peak."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    s = batch["tokens"].shape[1]
    logits, cache = rm.prefill(params, b, max_len=s + gen.shape[1])
    steps = [np.asarray(logits[:, -1])]
    for i in range(gen.shape[1] - 1):
        logits, cache = rm.decode_step(params, cache,
                                       jnp.asarray(gen[:, i:i + 1]),
                                       jnp.int32(s + i))
        steps.append(np.asarray(logits[:, -1]))
    out = []
    for lg in steps:
        top = np.sort(lg, axis=-1)
        out.append((top[:, -1] - top[:, -2]) / np.abs(lg).max(-1))
    return np.stack(out, axis=1)                     # (B, gen)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "whisper_large_v3",
                                  "qwen3_moe_235b_a22b"])
def test_serve_lm_tokens_match_reference(arch, monkeypatch, capsys):
    batch, prompt, gen = 8, 32, 16
    args = argparse.Namespace(arch=arch, smoke=True, batch=batch,
                              prompt_len=prompt, gen_tokens=gen)
    want = RSERVE.serve_lm(args)
    rm, tree = _reference_tree(arch, key=0)
    monkeypatch.setattr(
        TSERVE, "init_params",
        lambda specs, seed, dtype, device: jax.tree.map(
            lambda a: torch.from_numpy(a.copy()).to(device, dtype), tree))
    got = TSERVE.main(["--mode", "lm", "--arch", arch, "--smoke",
                       "--device", "cpu", "--batch", str(batch),
                       "--prompt-len", str(prompt),
                       "--gen-tokens", str(gen)]).numpy()
    out = capsys.readouterr().out
    assert f"[serve-lm] {get_smoke_config(arch).name}: batch={batch}" in out
    assert "float32 matmul precision=highest" in out
    assert got.shape == want.shape == (batch, gen) and got.dtype == np.int32
    if np.array_equal(got, want):
        return
    stream_batch = TSERVE.lm_batch(get_smoke_config(arch), batch, prompt,
                                   "cpu")
    margins = _reference_margins(
        rm, tree, {k: v.numpy() for k, v in stream_batch.items()}, want)
    for row in range(batch):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            step = int(diff[0])
            assert margins[row, step] < MARGIN_REL, (
                f"{arch} row {row} step {step}: tokens differ at a "
                f"reference margin of {margins[row, step]:.2e}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_runs_every_arch_on_cpu(arch, capsys):
    gen = TSERVE.main(["--mode", "lm", "--arch", arch, "--smoke",
                       "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen-tokens", "3"])
    assert tuple(gen.shape) == (2, 3) and gen.dtype == torch.int32
    cfg = get_smoke_config(arch)
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
    assert f"[serve-lm] {cfg.name}: batch=2 prompt=12 gen=3" in \
        capsys.readouterr().out


def test_serve_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSERVE.main(["--mode", "lm", "--smoke"])
