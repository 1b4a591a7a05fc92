"""Training launcher: ``python -m repro_torch.launch.train --arch
tinyllama-1.1b``.

The port of :mod:`repro.launch.train`, with its flags and defaults and
one more, ``--device`` (default ``cuda``; asking for the card where
there is none raises, ``cpu`` trains on the CPU).  ``--smoke`` runs the
reduced config of the same family through the same path: the trainer's
step, async checkpoints, the straggler watchdog and restart from the
newest checkpoint under ``--ckpt-dir``.

``--mesh`` is ``none`` (one process), ``local`` (the reference's small
``data x model`` mesh over the ranks there are,
:func:`repro_torch.launch.mesh.make_local_mesh`) or ``DxM``; a mesh joins
the process group ``torchrun`` describes (one rank otherwise).  The
trainer is data-parallel over ``data`` (with ZeRO-1) and
tensor-parallel over ``model``, e.g. on the CPU::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --smoke --mesh local --device cpu

(4 ranks: a (2, 2) mesh).  Every rank prints; the mesh's first rank
writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..configs import get_config, get_smoke_config
from ..runtime.trainer import Trainer, TrainerConfig
from .mesh import close_world, init_world, make_local_mesh, mesh_device_type


def _mesh(spec: str, device: str):
    init_world(device)
    if spec == "local":
        return make_local_mesh()
    d, m = (int(x) for x in spec.split("x"))
    return init_device_mesh(mesh_device_type(), (d, m),
                            mesh_dim_names=("data", "model"))


def _train(mcfg, tcfg, mesh_spec: str):
    if mesh_spec == "none":
        return Trainer(mcfg, tcfg).run()
    opened = not dist.is_initialized()
    try:
        return Trainer(mcfg, tcfg, mesh=_mesh(mesh_spec, tcfg.device)).run()
    finally:
        if opened:                  # leave no group this call opened
            close_world()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--mesh", default="none",
                    help="'none' (single device), 'local' (DxM over the "
                         "ranks there are), or 'DxM'")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu "
                         "trains on the CPU)")
    args = ap.parse_args(argv)

    mcfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    tcfg = TrainerConfig(batch_size=args.batch, seq_len=args.seq,
                         steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, lr=args.lr,
                         grad_compress=args.grad_compress,
                         device=args.device)
    out = _train(mcfg, tcfg, args.mesh)
    last = out["last_loss"]
    print(f"[train] {mcfg.name}: finished {args.steps} steps, last loss "
          f"{'n/a' if last is None else format(last, '.4f')}, "
          f"stragglers flagged: {len(out['stragglers'])}")
    for m in out["log"]:
        print(f"  step {m['step']:>5d} loss {m['loss']:.4f} {m['sec']:.2f}s")
    return out


if __name__ == "__main__":
    main()
