"""The port's production-mesh dry run (``repro_torch.launch.dryrun``, the
counterpart of ``repro.launch.dryrun``).

* Every architecture's smoke widths (at the published ``chunk_q`` /
  ``chunk_kv``, so a 32k sequence is a few chunks) on a fake (2, 4)
  mesh: every shape is ``ok`` but ``long_500k`` for the full-attention
  families, which is ``skipped`` as the reference skips it; a cell's
  flops, bytes and collective bytes are ``analyze_step``'s of the rank-0
  step the step builders give.
* ``main`` writes the reference's keys (``null`` where the port has no
  counterpart), into ``experiments/dryrun_torch`` by default, never the
  reference's ``experiments/dryrun``; importing the module opens no
  process group.
* ``slow``: ``run_cell("qwen3_0_6b", "decode_32k", ...)`` on the
  production mesh (256 fake ranks): ``ok`` and ``chips == 256``, the
  counterpart of the reference's ``test_dryrun_production_mesh_one_cell``.
"""
import dataclasses
import importlib
import json
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun, shapes, steps
from repro_torch.launch.hlo_cost import analyze_step
from repro_torch.models import Model

#: the keys of a cell the reference's ``run_cell`` writes
REF_KEYS = {"arch", "shape", "mesh", "chips", "status", "reason",
            "overrides", "kind", "compile_s", "flops_per_dev",
            "bytes_per_dev", "raw_cost_analysis", "collectives", "memory",
            "roofline", "tokens", "params_total", "params_active",
            "model_flops", "decode_ideal", "useful_flops_ratio",
            "bytes_by_op_unscaled"}
SKIP_KEYS = {"arch", "shape", "mesh", "chips", "status", "reason",
             "overrides"}


@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized(), "a process group was left open"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _smoke_overrides(arch):
    """The smoke config as overrides of the published one, keeping the
    published attention chunks."""
    smoke, full = get_smoke_config(arch), get_config(arch)
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke)
            if getattr(smoke, f.name) != getattr(full, f.name)
            and f.name not in ("chunk_q", "chunk_kv")}


def _counted(model, mesh, shape):
    kind = shapes.SHAPES[shape]["kind"]
    if kind == "train":
        fn, structs = steps.make_train_step(model, mesh, shape)
        return analyze_step(fn, *structs)
    with torch.inference_mode():
        if kind == "prefill":
            fn, structs = steps.make_prefill_step(model, mesh, shape)
            return analyze_step(fn, *structs)
        fn, structs = steps.make_decode_step(model, mesh, shape)
        return analyze_step(fn, *structs[:3],
                            shapes.SHAPES[shape]["seq"] - 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells_on_a_fake_mesh(fake_mesh, arch):
    over = _smoke_overrides(arch)
    cfg = get_config(arch).replace(**over)
    for shape in shapes.SHAPES:
        r = dryrun.run_cell(arch, shape, False, "", mesh=fake_mesh,
                            overrides=over)
        applicable, _ = shapes.shape_applicable(cfg, shape)
        if not applicable:
            assert r["status"] == "skipped" and set(r) == SKIP_KEYS
            continue
        assert r["status"] == "ok", r.get("error")
        assert (r["mesh"], r["chips"]) == ("2x4", 8)
        assert r["roofline"]["chips"] == 8
        if shape == "decode_32k":
            hc = _counted(Model(cfg), fake_mesh, shape)
            assert r["flops_per_dev"] == hc["flops"]
            assert r["bytes_per_dev"] == hc["bytes"]
            assert r["collectives"]["total"] == hc["coll_bytes"] > 0
    assert dist.get_world_size() == 8        # the given group stays open


def test_main_writes_the_reference_keys(tmp_path, capsys):
    assert not dist.is_initialized()
    out = str(tmp_path / "dr")
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k,long_500k",
                 "--outdir", out])
    assert not dist.is_initialized()        # the fake world closed
    assert "all requested cells passed" in capsys.readouterr().out
    files = sorted(os.listdir(out))
    assert files == ["qwen3_0_6b_decode_32k_16x16.json",
                     "qwen3_0_6b_long_500k_16x16.json"]
    ok = json.load(open(os.path.join(out, files[0])))
    assert ok["status"] == "ok" and REF_KEYS <= set(ok)
    assert ok["raw_cost_analysis"] is None and ok["memory"] is None
    assert ok["collectives"]["flat_module"] is None
    assert ok["chips"] == 256 and ok["decode_ideal"]["ideal_memory_s"] > 0
    skip = json.load(open(os.path.join(out, files[1])))
    assert skip["status"] == "skipped" and set(skip) == SKIP_KEYS


def test_default_outdir_is_not_the_references():
    assert dryrun.DEFAULT_OUTDIR == os.path.join("experiments",
                                                 "dryrun_torch")
    assert os.path.normpath(dryrun.DEFAULT_OUTDIR) != os.path.join(
        "experiments", "dryrun")
    importlib.reload(dryrun)
    assert not dist.is_initialized()


@pytest.mark.slow
def test_dryrun_production_mesh_one_cell():
    r = dryrun.run_cell("qwen3_0_6b", "decode_32k", multi_pod=False,
                        outdir="")
    assert r["status"] == "ok", r.get("error")
    assert r["roofline"]["chips"] == 256 and r["mesh"] == "16x16"
    assert not dist.is_initialized()
