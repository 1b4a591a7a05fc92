"""Production-mesh dry run: count every (arch x shape x mesh) step of the
LM substrate on the production meshes, and the roofline terms it implies.

The port of :mod:`repro.launch.dryrun`.  The reference lowers and
compiles each step for the 16 x 16 (or 2 x 16 x 16) TPU mesh on forced
host devices and reads the compiled HLO.  The port has no compiler: one
process stands for rank 0 of the mesh on a ``"fake"`` process group of
the mesh's world size (256 or 512 ranks;
``torch.testing._internal.distributed.fake_pg.FakeStore``, whose
collectives return at once), builds the step on rank 0's meta structs
(its rows of the batch, its parameter and cache shards:
:mod:`repro_torch.launch.steps`), and counts what one call dispatches
with :func:`repro_torch.launch.hlo_cost.analyze_step` -- flops, an HBM
byte model and the collectives by class, per device.  The terms are
:func:`repro_torch.launch.roofline.roofline_terms` at the H100's peaks
(``roofline.HW``), so every number is a count and a prediction for a
hypothetical mesh of that many H100s, never a measurement.

Each cell writes the reference's JSON keys.  Three have no counterpart
and are ``null``: ``raw_cost_analysis`` (XLA's own cost analysis of the
compiled module), ``collectives["flat_module"]`` (the reference's second
reading of the HLO text) and ``memory`` (the compiled module's memory
analysis).  ``compile_s`` is the time to build and count the step.
Three keys are the port's own: ``ops`` (operations dispatched),
``dot_flops`` (the products' share of the flops) and ``gathered`` (the
leaves the step gathers whole, by name and count: a split that does not
fall on whole heads or blocks, ``parallel.tensor.GATHERED``).  A
decode step is counted at the cache's last position (the port's decode
reads every cache chunk whatever the position, as the reference's does).

Importing this module opens no process group: :func:`run_cell` opens the
fake world inside the call (and closes it after) unless it is given a
mesh.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k --mesh single

(default ``--outdir experiments/dryrun_torch``; the reference's
``experiments/dryrun`` is read by its own tests).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ALIASES, ARCH_IDS, get_config
from ..models import Model
from ..parallel import tensor
from ..parallel.sharding import activate_mesh, mesh_axis_sizes
from ..tree import tree_leaves
from . import roofline as rl
from . import shapes as shp
from . import steps as steps_mod
from .hlo_cost import analyze_step
from .mesh import make_production_mesh

__all__ = ["run_cell", "main", "DEFAULT_OUTDIR", "fake_world"]

DEFAULT_OUTDIR = os.path.join("experiments", "dryrun_torch")


@contextlib.contextmanager
def fake_world(world: int):
    """A ``"fake"`` process group of ``world`` ranks with this process as
    rank 0, for the block (an open group of that size is used as is)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is open; the mesh needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def _nbytes(tree) -> int:
    return sum(int(np.prod(t.shape)) * t.element_size()
               for t in tree_leaves(tree))


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: str,
             mesh=None, overrides=None, rules=None, tag="") -> dict:
    """Count one cell; returns (and, with ``outdir``, writes) its dict.
    Without ``mesh``, the production mesh on a fake world of its size."""
    if mesh is None:
        with fake_world(_world(multi_pod)):
            return run_cell(arch, shape, multi_pod, outdir,
                            mesh=make_production_mesh(multi_pod=multi_pod),
                            overrides=overrides, rules=rules, tag=tag)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = Model(cfg)
    sizes = mesh_axis_sizes(mesh)
    chips = int(np.prod(list(sizes.values())))
    mesh_name = "x".join(str(n) for n in sizes.values())

    ok, reason = shp.shape_applicable(cfg, shape)
    result = {"arch": arch + (f"+{tag}" if tag else ""), "shape": shape,
              "mesh": mesh_name, "chips": chips, "status": "skipped",
              "reason": reason, "overrides": overrides or {}}
    if not ok:
        return _emit(result, outdir)

    kind = shp.SHAPES[shape]["kind"]
    seq = shp.SHAPES[shape]["seq"]
    t0 = time.time()
    try:
        if kind == "train":
            fn, structs = steps_mod.make_train_step(model, mesh, shape)
            args = structs
        elif kind == "prefill":
            fn, structs = steps_mod.make_prefill_step(model, mesh, shape)
            args = structs
        else:
            fn, structs = steps_mod.make_decode_step(model, mesh, shape)
            args = structs[:3] + (seq - 1,)

        tensor.GATHERED.clear()
        with activate_mesh(mesh, rules):
            if kind == "train":
                hc = analyze_step(fn, *args)
            else:
                with torch.inference_mode():
                    hc = analyze_step(fn, *args)
        flops = float(hc["flops"])
        nbytes = float(hc["bytes"])
        coll = {k: v for k, v in hc.items() if k.startswith("coll_")}
        coll["total"] = float(hc["coll_bytes"])
        coll["by_class"] = hc["collectives"]
        coll["flat_module"] = None
        result["bytes_by_op_unscaled"] = hc["bytes_by_op_unscaled"]
        terms = rl.roofline_terms(flops, nbytes, coll["total"], chips)

        tokens = shp.SHAPES[shape]["batch"] * (seq if kind != "decode"
                                               else 1)
        mflops, n_total, n_active = rl.model_flops(
            cfg, model.specs(), tokens,
            "train" if kind == "train" else "inference")

        decode_ideal = None
        if kind == "decode":
            # memory-bound by construction: the floor is reading every
            # parameter shard and the cache once per step
            cache_bytes = _nbytes(shp.cache_structs(
                model, shp.SHAPES[shape]["batch"], seq))
            ideal_per_dev = (n_active * 2 / sizes.get("model", 1)
                             + cache_bytes / chips)
            ideal_s = ideal_per_dev / rl.HW["hbm_bw"]
            decode_ideal = {
                "cache_bytes_global": cache_bytes,
                "ideal_bytes_per_dev": ideal_per_dev,
                "ideal_memory_s": ideal_s,
                "fraction_of_modeled": (ideal_s / terms["memory_s"]
                                        if terms["memory_s"] else None),
            }
        global_flops = flops * chips
        result.update(
            status="ok", kind=kind, compile_s=round(time.time() - t0, 1),
            flops_per_dev=flops, bytes_per_dev=nbytes,
            raw_cost_analysis=None, collectives=coll, memory=None,
            roofline=terms, tokens=tokens, params_total=n_total,
            params_active=n_active, model_flops=mflops,
            decode_ideal=decode_ideal,
            useful_flops_ratio=(mflops / global_flops
                                if global_flops else None),
            ops=hc["ops"], dot_flops=hc["dot_flops"],
            gathered=dict(sorted(tensor.GATHERED.items())),
        )
    except Exception as e:
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:],
                      compile_s=round(time.time() - t0, 1))
    return _emit(result, outdir)


def _emit(result: dict, outdir: str) -> dict:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        fname = f"{result['arch']}_{result['shape']}_{result['mesh']}.json"
        with open(os.path.join(outdir, fname), "w") as f:
            json.dump(result, f, indent=1, default=str)
    status = result["status"]
    extra = ""
    if status == "ok":
        t = result["roofline"]
        extra = (f" dom={t['dominant']} comp={t['compute_s']:.3e}s "
                 f"mem={t['memory_s']:.3e}s coll={t['collective_s']:.3e}s "
                 f"compile={result['compile_s']}s")
    elif status == "error":
        extra = " " + result["error"][:160]
    print(f"[dryrun] {result['arch']:22s} {result['shape']:12s} "
          f"mesh={result['mesh']:10s} {status}{extra}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default=DEFAULT_OUTDIR)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [
        ALIASES.get(a, a) for a in args.arch.split(",")]
    shapes = list(shp.SHAPES) if args.shape == "all" else \
        args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_err = 0
    for multi in meshes:
        with fake_world(_world(multi)):
            mesh = make_production_mesh(multi_pod=multi)
            for arch in archs:
                for shape in shapes:
                    r = run_cell(arch, shape, multi, args.outdir, mesh=mesh)
                    n_err += r["status"] == "error"
    if n_err:
        raise SystemExit(f"{n_err} dry-run cells failed")
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
