"""Serving launcher of the port: the DPRT image service (``--mode radon``).

    python -m repro_torch.launch.serve --mode radon [--smoke] [--device cuda]

The port of :mod:`repro.launch.serve`'s radon mode: a batch of phantom
images in, the exact forward DPRT out, then the exact inverse, timed
over ``--iters`` round trips and checked bit-exact.  The default
configuration is ``configs/radon_251.py`` (N = 251; ``--smoke`` N = 31,
batch 8).  ``--method`` resolves through the backend registry (``auto``
is the hand-written kernel, ``pallas`` an alias of it); ``--n`` accepts
any size (non-prime sizes are zero-embedded and cropped back).
``--stream-rows H`` streams each image through one launch of the
streamed kernel (K5) per transform, in strips of at most H rows (the
giant-N path, e.g. ``--n 4099 --batch 4 --stream-rows 256``).
``--warmup`` builds the kernels and makes one warm call per datapath
(``op.compile()``) before the timing loop; the loop runs inside a
``retrace_guard(max_traces=0)``: no plan or kernel is built in steady
state.

``--mesh-shape D[,M]`` serves on a ``("data", "model")`` mesh (``D``
alone: a ``("model",)`` mesh) through the mesh-aware ``sharded_cuda``
backend: image rows shard over ``model``, the batch over ``data``, and
each rank runs K1 on its block.  It needs D*M ranks, one process each:
``torchrun --nproc-per-node=<D*M> -m repro_torch.launch.serve ...`` on a
host with that many cards; started alone, the process is a group of one
rank, so ``--mesh-shape 1,1``.  Every rank serves its share; rank 0
prints.  ``--method`` of a mesh-aware backend needs ``--mesh-shape``.

Runs on the card (``--device cuda``, the default) and raises when there
is none; ``--device cpu`` runs the kernels' plain versions (a mesh then
runs over gloo).  Not ported yet, and refused with the ROADMAP item that
ports them: ``--mode lm/service/pool``.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from .. import radon
from ..configs.radon_251 import config as radon_config, \
    smoke_config as radon_smoke
from ..core.plan import METHOD_ALIASES, available_backends, \
    backend_capabilities, get_backend
from ..data.synthetic import radon_images
from .service import format_latency, latency_summary

#: flags of the reference's serve CLI that the port refuses for now
NOT_PORTED = {
    "--mode lm": "ROADMAP Queue 1 item 10 (LM substrate)",
    "--mode service": "ROADMAP Queue 1 item 8 (serving tier)",
    "--mode pool": "ROADMAP Queue 1 item 8 (serving tier)",
}


def resolve_device(name: str) -> torch.device:
    """The device to serve on; a CUDA device that is not there raises
    (the service never carries on on the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            f"--device cpu to run the kernels' plain versions)")
    return device


def parse_mesh_shape(spec, device: torch.device):
    """``--mesh-shape D,M`` -> a ``("data", "model")`` DeviceMesh (a 1-D
    ``("model",)`` mesh for ``D``); checked against the ranks running.
    Joins the process group (NCCL for a CUDA device, gloo for the CPU)
    when none is open."""
    if spec is None:
        return None
    try:
        dims = tuple(int(s) for s in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh-shape must be ints like '2,4': {spec!r}")
    if not dims or any(d < 1 for d in dims) or len(dims) > 2:
        raise SystemExit(f"--mesh-shape must be 'D' or 'D,M', got {spec!r}")
    need = 1
    for d in dims:
        need *= d
    from torch.distributed.device_mesh import init_device_mesh
    from .mesh import init_world, mesh_device_type
    init_world(device.type)
    have = dist.get_world_size()
    if need != have:
        raise SystemExit(
            f"--mesh-shape {spec} needs {need} ranks, {have} running "
            f"(start one process per rank: torchrun --nproc-per-node={need})")
    axes = ("data", "model")[:len(dims)] if len(dims) > 1 else ("model",)
    return init_device_mesh(mesh_device_type(), dims, mesh_dim_names=axes)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_radon(args) -> torch.Tensor:
    """The radon service; a process group it had to open for
    ``--mesh-shape`` is closed again when it returns or fails."""
    opened = args.mesh_shape is not None and not dist.is_initialized()
    try:
        return _serve_radon(args)
    finally:
        if opened:
            from .mesh import close_world
            close_world()


def _serve_radon(args) -> torch.Tensor:
    rcfg = radon_smoke() if args.smoke else radon_config()
    device = resolve_device(args.device)
    n = args.n or rcfg.n                       # any size; operator embeds
    mesh = parse_mesh_shape(args.mesh_shape, device)
    if (args.method != "auto" and mesh is None
            and get_backend(args.method).mesh_aware):
        raise SystemExit(f"--method {args.method} needs --mesh-shape")
    lead = mesh is None or dist.get_rank() == 0
    imgs = torch.from_numpy(radon_images(n, args.batch or rcfg.batch,
                                         kind="phantom")).to(device)
    op = radon.DPRT(tuple(imgs.shape), imgs.dtype, args.method,
                    strip_rows=args.strip_rows, m_block=args.m_block,
                    batch_impl=args.batch_impl,
                    stream_rows=args.stream_rows,
                    block_batch=args.block_batch, mesh=mesh)
    inv = op.inverse
    if args.warmup:
        tw = time.perf_counter()
        op.compile(device)
        inv.compile(device)
        if lead:
            print(f"[serve-radon] warmup: built + warmed forward+inverse "
                  f"for {op.shape_in} in "
                  f"{1e3 * (time.perf_counter() - tw):.0f}ms")
    else:
        # warm both datapaths so the timed loop measures steady state
        inv(op(imgs))
        _sync(device)
    iters = max(1, args.iters)
    fwd_lat, inv_lat = [], []
    with radon.retrace_guard(max_traces=0):
        for _ in range(iters):
            t0 = time.perf_counter()
            r = op(imgs)
            _sync(device)
            fwd_lat.append(time.perf_counter() - t0)
            t1 = time.perf_counter()
            back = inv(r)
            _sync(device)
            inv_lat.append(time.perf_counter() - t1)
    exact = bool(torch.equal(back, imgs))      # operator crops the embedding
    b = imgs.shape[0]
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    mesh_note = "" if mesh is None else (
        f" mesh={dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}")
    if lead:
        print(f"[serve-radon] N={n} (prime P={op.plan.geometry.prime}) "
              f"batch={b} method={args.method}->{op.plan.method}{mesh_note} "
              f"device={dev_name}: round-trip exact={exact}, "
              f"traces={op.trace_count}")
        print(f"[serve-radon] route: {route_name(op.plan)}"
              + (" -- its plain torch version on cpu"
                 if device.type == "cpu" else ""))
        print("[serve-radon] forward "
              + format_latency(latency_summary(fwd_lat),
                               b * iters / sum(fwd_lat)))
        print("[serve-radon] inverse "
              + format_latency(latency_summary(inv_lat),
                               b * iters / sum(inv_lat)))
    if not exact:
        raise RuntimeError("DPRT round trip must be bit-exact")
    return r


def route_name(plan) -> str:
    """The kernel route a plan's forward and inverse take."""
    if plan.mesh is not None and plan.backend.mesh_aware:
        where = f"{plan.method} on mesh {plan.describe()['mesh']}"
        if not plan.backend.batched_native:
            return (f"{where}: torch Horner scan per row shard + one "
                    f"all_reduce (a stack: each data shard's images, no "
                    f"collective)")
        kernel = ("streamed kernel K5" if plan.stream_rows is not None
                  else "K1")
        return f"{where}: {kernel} per shard + one all_reduce per transform"
    if plan.stream_rows is None:
        if plan.block_rows is not None:
            return f"block_rows={plan.block_rows} scan ({plan.method})"
        return f"{plan.method} (one launch per transform)"
    if plan.backend.takes_stream_rows:
        return (f"streamed kernel K5 (stream_impl dma), stream_rows="
                f"{plan.stream_rows}, one launch per transform")
    return (f"stream_rows={plan.stream_rows} scan on {plan.method} (no "
            f"streamed kernel)")


def list_backends():
    cols = ("name", "priority", "batched_native", "needs_strip_rows",
            "takes_m_block", "stream", "mesh_aware", "dtypes", "note")
    for row in backend_capabilities():
        print("  ".join(f"{c}={row[c]}" for c in cols))


def main(argv=None):
    methods = ["auto"] + list(available_backends()) + list(METHOD_ALIASES)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["lm", "radon", "service", "pool"],
                    default="radon")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (N=31, batch 8)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--method", default="auto", choices=methods,
                    help="DPRT strategy (auto = registry pick: the cuda "
                         "kernel backend; pallas = alias of cuda)")
    ap.add_argument("--n", type=int, default=None,
                    help="image side; non-prime/any size is embedded into "
                         "the next prime (default: config N)")
    ap.add_argument("--strip-rows", type=int, default=None,
                    help="strip height H (strips/cuda; default: table)")
    ap.add_argument("--m-block", type=int, default=None,
                    help="direction block M (cuda; default: table)")
    ap.add_argument("--stream-rows", type=int, default=None,
                    help="stream the image through ONE launch of the "
                         "streamed kernel in row strips of at most this "
                         "height (giant N; backends without it scan)")
    ap.add_argument("--batch-impl", default="auto",
                    choices=["auto", "map", "vmap"],
                    help="batching for non-batched-native backends")
    ap.add_argument("--block-batch", type=int, default=None,
                    help="run the batch through the backend in chunks of "
                         "this many images (bounded memory)")
    ap.add_argument("--mesh-shape", default=None, metavar="D[,M]",
                    help="serve on a (data, model) mesh of D*M ranks "
                         "(one process each, e.g. torchrun; alone: 1,1)")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and warm both datapaths "
                         "(op.compile()) before the timing loop")
    ap.add_argument("--iters", type=int, default=5,
                    help="timing-loop samples per datapath")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the backend capability table and exit")
    args = ap.parse_args(argv)
    if args.list_backends:
        return list_backends()
    if args.mode != "radon":
        raise SystemExit(f"--mode {args.mode} is not ported to repro_torch "
                         f"yet: {NOT_PORTED['--mode ' + args.mode]}")
    return serve_radon(args)


if __name__ == "__main__":
    main()
