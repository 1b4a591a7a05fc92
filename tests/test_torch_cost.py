"""The port's cost models (``launch/roofline.py``, ``launch/hlo_cost.py``)
against the reference's on the CPU.

* ``param_counts`` / ``model_flops`` equal the reference's for the ten
  architectures' full specs, in train and inference modes (exact: both
  count the same integer shapes; the flops are the same float products).
* ``roofline_terms`` equals the reference's on the same inputs, each
  term scaled by the ratio of the two ``HW`` tables (rel 1e-12).
* The collective counter on a ``"fake"`` process group of world size 8
  gives the bytes the reference's ``parse_collectives`` reads from the
  HLO lines of its ``test_roofline_parser_units``: an f32[1024,512]
  all-reduce over 4, a bf16[64,1024] all-gather result over 2, an
  f32[128] reduce-scatter over 8 (exact); a data-parallel train step's
  all-reduces are its gradients, loss and loss parts.
* ``analyze_step``: on the reference's scanned ``tanh(h @ w)`` (6 x
  128x256x256) the products are exactly 6 * 2 * 128 * 256 * 256 flops and
  the total within 1.1x of the reference's ``analyze_hlo``; on every
  smoke config's prefill and train step (float32, batch 2 x 32) the
  flops are within FLOPS_BAND of ``analyze_hlo``'s on the reference's
  same step (XLA counts a softmax's and a scan's elementwise ops apart,
  the eager port some fused).
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.launch import roofline as RL
from repro.launch.hlo_cost import analyze_hlo
from repro.models import Model as RModel
from repro.optim.adamw import AdamWConfig, adamw_update as r_adamw_update
from repro.optim.adamw import cosine_schedule as r_cosine_schedule
from repro.parallel.sharding import abstract_params as r_abstract_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import roofline as TL
from repro_torch.launch.hlo_cost import COLL_CLASSES, analyze_step
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import Model
from repro_torch.optim.adamw import adamw_abstract
from repro_torch.parallel.sharding import abstract_params, count_params

#: counted flops of a smoke step over the reference's analyze_hlo flops
#: (measured 0.89-0.99 over the ten architectures)
FLOPS_BAND = (0.85, 1.10)
B, S = 2, 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_the_reference(arch):
    specs = Model(get_config(arch)).specs()
    rcfg = r_get_config(arch)
    rspecs = RModel(rcfg).specs()
    assert TL.param_counts(specs) == RL.param_counts(rspecs)
    assert TL.param_counts(specs)[0] == count_params(specs)
    for mode in ("train", "inference"):
        for tokens in (1, 4096 * 256):
            assert TL.model_flops(get_config(arch), specs, tokens, mode) \
                == RL.model_flops(rcfg, rspecs, tokens, mode)


def test_roofline_terms_at_the_h100_peaks():
    inputs = [(197e12, 819e9, 50e9, 256), (3.1e12, 2.2e9, 0.0, 1),
              (1.0, 5e12, 7e9, 8)]
    keys = {"compute_s": "peak_flops", "memory_s": "hbm_bw",
            "collective_s": "link_bw"}
    for args in inputs:
        got, want = TL.roofline_terms(*args), RL.roofline_terms(*args)
        for term, hw in keys.items():
            scaled = want[term] * RL.HW[hw] / TL.HW[hw]
            assert got[term] == pytest.approx(scaled, rel=1e-12, abs=0)
        for k in ("chips", "global_flops", "global_bytes",
                  "global_coll_bytes"):
            assert got[k] == want[k]
        assert got["step_s_lower_bound"] == max(got[k] for k in keys)
    f32 = TL.roofline_terms(67e12, 0.0, 0.0, 1,
                            peak_flops=TL.HW["f32_flops"])
    assert f32["compute_s"] == 1.0 and f32["dominant"] == "compute"
    assert set(RL.HW) <= set(TL.HW)


# ---------------------------------------------------------------------------
# collectives on a fake process group of world size 8
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized(), "a process group was left open"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_bytes_match_parse_collectives(fake_world):
    hlo = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%x), replica_groups=[2,4]<=[8]
  %all-gather.2 = bf16[64,1024]{1,0} all-gather(%y), replica_groups=[4,2]<=[8], dimensions={1}
  %reduce-scatter.3 = f32[128]{0} reduce-scatter(%z), replica_groups=[1,8]<=[8]
"""
    want = RL.parse_collectives(hlo)
    g4, g2 = dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])

    def step():
        dist.all_reduce(torch.ones(1024, 512), group=g4)
        dist.all_gather_into_tensor(
            torch.empty(64, 1024, dtype=torch.bfloat16),
            torch.ones(32, 1024, dtype=torch.bfloat16), group=g2)
        dist.reduce_scatter_tensor(torch.empty(128),
                                   torch.ones(128 * 8))

    got = analyze_step(step)
    assert got["collectives"] == want
    assert set(want) == set(COLL_CLASSES) | {"count", "total"}
    assert got["coll_bytes"] == want["total"]
    assert got["coll_all-reduce"] == 1024 * 512 * 4


def test_data_parallel_step_all_reduces_its_gradients(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    model = Model(get_smoke_config("tinyllama_1_1b"))
    params = abstract_params(model.specs(), torch.float32)
    step, _ = make_train_step(model, mesh, "train_4k",
                              param_dtype=torch.float32)
    got = analyze_step(step, params, adamw_abstract(params),
                       _structs(model.cfg, labels=True))
    c = got["collectives"]
    # float32 gradients, the loss and its two parts (ce, aux)
    assert c["all-reduce"] == c["total"] == \
        4 * count_params(model.specs()) + 3 * 4


# ---------------------------------------------------------------------------
# analyze_step against analyze_hlo
# ---------------------------------------------------------------------------
def test_scanned_tanh_products_and_total():
    def scanned_ref(x, w):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        h, _ = jax.lax.scan(body, x, w)
        return h

    a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    w = jax.ShapeDtypeStruct((6, 256, 256), jnp.float32)
    ref = analyze_hlo(jax.jit(scanned_ref).lower(a, w).compile().as_text())

    def scanned(x, w):
        h = x
        for wi in w:
            h = torch.tanh(h @ wi)
        return h

    got = analyze_step(scanned, torch.empty(128, 256, device="meta"),
                       torch.empty(6, 256, 256, device="meta"))
    assert got["dot_flops"] == 6 * 2 * 128 * 256 * 256
    assert got["flops"] == got["dot_flops"] + 6 * 128 * 256
    assert 1 / 1.1 <= got["flops"] / ref["flops"] <= 1.1
    # mm reads h and w[i], writes h; tanh reads and writes h; views free
    assert got["bytes"] == 6 * 4 * (2 * 128 * 256 + 256 * 256
                                    + 2 * 128 * 256)


def _structs(cfg, labels, jax_side=False):
    """The batch of a (B, S) step: tokens (and labels), stub embeddings."""
    if jax_side:
        def make(shape, dtype):
            return jax.ShapeDtypeStruct(shape, {torch.int32: jnp.int32,
                                                torch.float32:
                                                jnp.float32}[dtype])
    else:
        def make(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
    out = {"tokens": make((B, S), torch.int32)}
    if labels:
        out["labels"] = make((B, S), torch.int32)
    if cfg.frontend == "patch_stub":
        out["patch_embed"] = make((B, cfg.prefix_len, cfg.d_model),
                                  torch.float32)
    if cfg.frontend == "audio_stub":
        out["audio_embed"] = make((B, cfg.encoder_seq, cfg.d_model),
                                  torch.float32)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_steps_count_the_reference_flops(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = abstract_params(model.specs(), torch.float32)
    rmodel = RModel(r_get_smoke_config(arch))
    rparams = r_abstract_params(rmodel.specs(), jnp.float32)

    prefill, _ = make_prefill_step(model, None, "prefill_32k",
                                   param_dtype=torch.float32)
    with torch.inference_mode():
        got = analyze_step(prefill, params, _structs(cfg, False))
    ref = analyze_hlo(jax.jit(lambda p, b: rmodel.prefill(p, b)).lower(
        rparams, _structs(cfg, False, True)).compile().as_text())
    lo, hi = FLOPS_BAND
    assert lo <= got["flops"] / ref["flops"] <= hi, (got, ref)

    step, _ = make_train_step(model, None, "train_4k",
                              param_dtype=torch.float32)
    got = analyze_step(step, params, adamw_abstract(params),
                       _structs(cfg, True))
    opt_cfg = AdamWConfig(lr=3e-4)
    sched = r_cosine_schedule(3e-4, 100, 10000)

    def ref_step(p, opt, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: rmodel.loss(q, batch), has_aux=True)(p)
        return r_adamw_update(p, grads, opt, opt_cfg, sched)[:2] + (loss,)

    f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                       rparams)
    ropt = {"mu": f32, "nu": f32,
            "step": jax.ShapeDtypeStruct((), jnp.int32)}
    ref = analyze_hlo(jax.jit(ref_step).lower(
        rparams, ropt, _structs(cfg, True, True)).compile().as_text())
    assert lo <= got["flops"] / ref["flops"] <= hi, (got, ref)
    assert got["coll_bytes"] == 0 and got["ops"] > 0
