"""Serving launcher of the port: batched LM decode, the DPRT image
service and its tier.

    python -m repro_torch.launch.serve --mode radon [--smoke] [--device cuda]
    python -m repro_torch.launch.serve --mode lm [--arch A] [--smoke] ...
    python -m repro_torch.launch.serve --mode service [--datapath D] ...
    python -m repro_torch.launch.serve --mode pool [--workers W] ...

The port of :mod:`repro.launch.serve`.  ``--mode radon``: a batch of phantom
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

``--mode service`` is the async dynamic-batching front-end
(:mod:`repro_torch.launch.service`): concurrent single-image requests
coalesced into the batched kernels and padded to warm sizes, over one
of five datapaths (``--datapath forward|inverse|roundtrip|conv|solve``;
conv with a 3x3 ones kernel, solve the unmasked least-squares
reconstruction of sinogram requests), with an optional persistent
executable cache (``--aot-dir``: a restart installs the exported nvcc
libraries instead of running nvcc) and a ``/healthz``-style report.
With ``--mesh-shape`` its operators run on the mesh: every rank warms
up, rank 0 batches and answers the requests, and the other ranks run
each of its batches with it (``DPRTService.follow``).
Three sub-modes grow it into the multi-tenant tier:

* ``--jsonl`` runs the stdin-jsonl worker over a
  :class:`~repro_torch.launch.router.ServiceRouter` (multi-geometry
  routing, bounded admission, deadlines, retry/degrade), prefilled from
  a ``--manifest`` of route specs; ``--framed`` speaks the supervisor's
  length-prefixed frames, ``--sigterm-drain`` drains on SIGTERM;
* ``--chaos`` runs the fault-injection smoke: a mixed-geometry burst
  under injected kernel errors, dispatch delays, corrupt executable
  blobs and a queue flood, checking that the router degrades to WARN
  with every response bit-exact or typed;
* default: the single-service benchmark loop (sequential baseline, then
  the same traffic coalesced).

``--mode pool`` supervises ``--workers`` ``--jsonl --framed`` worker
processes (:mod:`repro_torch.launch.supervisor`) over one shared
``--aot-dir``; with ``--chaos`` one worker is SIGKILLed mid-burst.

``--mode lm`` serves the LM substrate (:mod:`repro_torch.models`): it
builds ``--arch`` (``--smoke``: its reduced config) with float32 weights
drawn from seed 0, takes ``--batch`` prompts of ``--prompt-len`` tokens
from ``TokenStream`` (zero stub embeddings for the audio and patch
front ends), prefills a cache of prompt + ``--gen-tokens`` positions and
decodes greedily, the tokens kept on the device until the end, all
under ``torch.inference_mode()``.  It prints the ``[serve-lm]`` line and
a sample and returns the generated tokens.  The substrate has no
hand-written kernel (the reference's has no Pallas kernel): it runs
PyTorch's own operators at its default float32 matmul precision.

Runs on the card (``--device cuda``, the default) and raises when there
is none; ``--device cpu`` runs the kernels' plain versions (a mesh then
runs over gloo; pool workers get the same ``--device``).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import radon
from ..configs import get_config, get_smoke_config
from ..configs.radon_251 import config as radon_config, \
    smoke_config as radon_smoke
from ..core.plan import METHOD_ALIASES, available_backends, \
    backend_capabilities, get_backend
from ..data.synthetic import TokenStream, radon_images
from ..models import Model
from ..parallel.sharding import init_params
from .service import (DPRTService, format_latency, latency_summary,
                      resolve_device)


def lm_batch(mcfg, batch: int, prompt_len: int, device) -> dict:
    """The LM service's input: ``TokenStream`` prompts (seed 0, step 0)
    and, for a stub front end, zero audio frames or patch embeddings."""
    stream = TokenStream(mcfg.vocab_size, prompt_len, batch)
    out = {"tokens": torch.from_numpy(stream.batch(0)["tokens"]).to(device)}
    if mcfg.frontend == "audio_stub":
        out["audio_embed"] = torch.zeros(
            (batch, mcfg.encoder_seq, mcfg.d_model), device=device)
    if mcfg.frontend == "patch_stub":
        out["patch_embed"] = torch.zeros(
            (batch, mcfg.prefix_len, mcfg.d_model), device=device)
    return out


@torch.inference_mode()
def greedy_generate(model: Model, batch: dict, gen_tokens: int):
    """One prefill of a cache of prompt + ``gen_tokens`` positions, then
    greedy decode steps; returns the (B, gen_tokens) int32 tokens, left
    on the device."""
    prompt_len = batch["tokens"].shape[1]
    logits, cache = model.prefill(batch, max_len=prompt_len + gen_tokens)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(gen_tokens - 1):
        logits, cache = model.decode_step(cache, tok, prompt_len + i)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def serve_lm(args) -> torch.Tensor:
    """Prefill a batch of prompts, then greedy-decode ``--gen-tokens``;
    returns the generated tokens (B, gen) on the CPU."""
    device = resolve_device(args.device)
    mcfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = Model(mcfg)
    model.load_params(init_params(model.specs(), 0, torch.float32, device))
    batch = lm_batch(mcfg, args.batch, args.prompt_len, device)
    print(f"[serve-lm] device={device} float32 matmul precision="
          f"{torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    gen = greedy_generate(model, batch, args.gen_tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    gen = gen.cpu()
    tps = args.batch * args.gen_tokens / dt
    print(f"[serve-lm] {mcfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen_tokens} "
          f"-> {tps:.1f} tok/s  ({dt:.2f}s)")
    print("  sample:", gen[0, :16].tolist())
    return gen


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


def _mesh_note(mesh) -> str:
    return str(dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape))))


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
    mesh_note = "" if mesh is None else f" mesh={_mesh_note(mesh)}"
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


#: agreement of float responses (the solve datapath) between coalesced
#: and sequential runs, relative to the response's peak: a batch of 8
#: and a batch of 1 sum in other orders on the card
FLOAT_REL = 1e-4


def _agree(results, ref) -> tuple:
    """``(ok, worst)``: integer responses bit for bit, float ones within
    FLOAT_REL of each reference response's peak (``worst`` the largest
    relative error, 0.0 when every response is bit-equal)."""
    ok, worst = True, 0.0
    for a, b in zip(results, ref):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        if a.dtype.kind != "f" or a.shape != b.shape:
            return False, float("inf")
        err = float(np.abs(a.astype(np.float64) - b).max()) / max(
            1.0, float(np.abs(b).max()))
        worst = max(worst, err)
        ok = ok and err <= FLOAT_REL
    return ok, worst


def _require(ok, msg: str) -> None:
    """A check of the serving modes: raises (``python -O`` keeps it)."""
    if not ok:
        raise RuntimeError(msg)


def _oracle(n: int, img, device) -> np.ndarray:
    """The forward DPRT of one image on ``device``, outside any service:
    the per-operator oracle of the chaos and pool modes."""
    x = torch.from_numpy(np.asarray(img)[None]).to(device)
    return radon.DPRT((1, n, n), torch.int32)(x)[0].cpu().numpy()


def serve_service(args):
    """The dynamic-batching service: warm up (optionally through the
    persistent executable cache), run a sequential per-request baseline,
    then the same traffic coalesced, and print the healthz report.  On
    ``--mesh-shape`` every rank warms up, rank 0 serves and the others
    follow its batches; a process group this function opened is closed
    again when it returns or fails."""
    opened = args.mesh_shape is not None and not dist.is_initialized()
    try:
        return _serve_service(args)
    finally:
        if opened:
            from .mesh import close_world
            close_world()


def _serve_service(args):
    rcfg = radon_smoke() if args.smoke else radon_config()
    device = resolve_device(args.device)
    n = args.n or rcfg.n
    mesh = parse_mesh_shape(args.mesh_shape, device)
    if (args.method != "auto" and mesh is None
            and get_backend(args.method).mesh_aware):
        raise SystemExit(f"--method {args.method} needs --mesh-shape")
    max_batch = args.batch or rcfg.batch
    requests = args.requests or (2 * max_batch if args.smoke else 64)
    kernel = (torch.ones((3, 3), dtype=torch.int32)
              if args.datapath == "conv" else None)
    svc = DPRTService((n, n), torch.int32, max_batch=max_batch,
                      max_wait_us=args.max_wait_us,
                      datapath=args.datapath, method=args.method,
                      conv_kernel=kernel, aot_dir=args.aot_dir,
                      strip_rows=args.strip_rows, m_block=args.m_block,
                      batch_impl=args.batch_impl,
                      stream_rows=args.stream_rows,
                      block_batch=args.block_batch, device=device,
                      **({} if mesh is None else {"mesh": mesh}))
    imgs = list(radon_images(n, requests, kind="phantom"))
    if args.datapath in ("inverse", "solve"):
        # inverse and solve requests are projections: forward-project
        # the phantoms into the service's (P+1, P) contract -- BEFORE
        # warmup, so the projection's own plan build doesn't read as a
        # post-warmup build in the healthz verdict (the counter is
        # process-wide)
        fwd = radon.DPRT((n, n), torch.int32)
        imgs = [fwd(torch.from_numpy(im).to(device)).cpu().numpy()
                .astype(svc.request_np_dtype) for im in imgs]
    winfo = svc.warmup()
    if mesh is not None and dist.get_rank() != 0:
        turns = svc.follow()           # every batch rank 0 dispatches
        print(f"[serve-service] rank {dist.get_rank()} followed {turns} "
              f"batches", file=sys.stderr)
        return None
    try:
        return _lead_service(args, svc, imgs, winfo, mesh)
    finally:
        builds = svc.close()
        if builds is not None:
            print(f"[serve-service] mesh {_mesh_note(mesh)}: "
                  f"{dist.get_world_size()} ranks, {svc.turns} "
                  f"batches on each, builds after warmup on every rank: "
                  f"{builds}")


def _lead_service(args, svc, imgs, winfo, mesh):
    """The service's benchmark: the sequential baseline, the coalesced
    passes and the healthz report, on rank 0 of a mesh."""
    cache_note = ""
    if "persistent" in winfo:
        p = winfo["persistent"]
        cache_note = (f" (persistent: {p['hits']} restored, "
                      f"{p['misses']} compiled, dir={p['directory']})")
    print(f"[serve-service] warmup: {winfo['executables']} executables "
          f"for warm_sizes={winfo['warm_sizes']} in "
          f"{1e3 * winfo['warmup_s']:.0f}ms{cache_note}")
    # warm both serving paths (thread pool, transfer paths), then
    # measure --iters full passes so single-core scheduling noise
    # averages out of the comparison
    ref, _ = svc.run_sequential(imgs)
    results = svc.run_requests(imgs, arrival_us=args.arrival_us)
    exact, worst = _agree(results, ref)
    # best-of-iters throughput on both paths: min is the noise-robust
    # statistic on a shared/single-core host, and the coalesced passes
    # share one event loop the way a real deployment would
    iters = max(1, args.iters)
    seq_lat, seq_walls = [], []
    for _ in range(iters):
        lat = svc.run_sequential(imgs)[1]
        seq_lat += lat
        seq_walls.append(sum(lat))
    svc.reset_metrics()
    svc.run_requests(imgs, arrival_us=args.arrival_us, repeats=iters)
    s = svc.stats()
    seq_rate = len(imgs) / min(seq_walls)
    coal_rate = len(imgs) / min(svc.last_pass_walls)
    print("[serve-service] sequential "
          + format_latency(latency_summary(seq_lat), seq_rate))
    print("[serve-service] coalesced  "
          + format_latency(s["latency"], coal_rate))
    agree = (f"responses exact={exact}" if worst == 0.0 else
             f"responses within {FLOAT_REL:g} of the peak={exact} "
             f"(max |err|/peak {worst:.3g})")
    print(f"[serve-service] coalescing speedup "
          f"{coal_rate / seq_rate:.2f}x (best-of-{iters}), {agree}")
    print(svc.healthz())
    if not exact:
        raise RuntimeError("coalesced responses must match the per-request "
                           "baseline")
    return results


def _load_manifest(spec):
    """A geometry manifest: a JSON list of route specs
    (``[{"n": 13}, {"n": 17, "datapath": "roundtrip"}, …]``) -- either
    a file path or the JSON itself (how the pool supervisor hands a
    manifest to its worker subprocesses without temp files)."""
    if spec.lstrip().startswith("["):
        data = json.loads(spec)
    else:
        with open(spec) as f:
            data = json.load(f)
    if not isinstance(data, list) or not all(isinstance(e, dict)
                                             for e in data):
        raise SystemExit(f"--manifest {spec!r} must be a JSON list of "
                         "route-spec objects")
    return data


def serve_jsonl_mode(args):
    """The transport worker: a prefilled ServiceRouter behind the
    newline-delimited-JSON protocol on stdin/stdout (healthz to stderr
    at exit -- stdout belongs to the protocol).  ``--framed`` switches
    to the supervisor's length-prefixed frames; ``--sigterm-drain``
    makes SIGTERM drain (flush in-flight, final healthz) instead of
    killing the worker mid-batch.  A ``REPRO_FAULTS`` spec in the
    environment arms deterministic chaos inside this process."""
    from . import faults
    from .router import ServiceRouter, serve_jsonl
    device = resolve_device(args.device)
    inj = faults.install_from_env()
    if inj is not None:
        print(f"[serve-jsonl] faults armed from {faults.FAULTS_ENV_VAR}: "
              f"{inj.spec}", file=sys.stderr)
    router = ServiceRouter(
        max_batch=args.batch, max_wait_us=args.max_wait_us,
        max_services=args.max_services, queue_cap=args.queue_cap,
        max_inflight=args.max_inflight, aot_dir=args.aot_dir,
        device=device)
    if args.manifest:
        infos = router.prefill(_load_manifest(args.manifest))
        print(f"[serve-jsonl] prefilled {len(infos)} routes",
              file=sys.stderr)
    serve_jsonl(router, sys.stdin, sys.stdout, framed=args.framed,
                sigterm_drain=args.sigterm_drain)
    print(router.healthz(), file=sys.stderr)
    return router


def serve_chaos(args):
    """The fault-injection smoke: mixed-geometry traffic through a
    deliberately tight router while the :mod:`repro_torch.launch.faults`
    harness injects kernel errors, dispatch delays, corrupt AOT blobs
    and a queue flood.  Asserts the robustness contract: no hang, no
    dropped future, every response bit-exact vs the per-operator oracle
    or a typed rejection, and a healthz that accounts for every
    degradation (verdict WARN, never FAIL)."""
    from . import faults
    from .errors import ServiceError
    from .router import ServiceRouter

    device = resolve_device(args.device)
    seed = args.chaos_seed
    ns = (13, 17)
    requests_n = 16 if args.smoke else 48
    flood_n = 3 * args.queue_cap
    manifest = ([{"n": n} for n in ns]
                + [{"n": ns[0], "datapath": "roundtrip"}])
    aot_dir = args.aot_dir or tempfile.mkdtemp(prefix="repro_chaos_aot_")

    # seed the blob store warm, then corrupt it: the chaos router's
    # prefill must degrade to counted cold compiles, not an outage
    seeder = ServiceRouter(max_batch=4, aot_dir=aot_dir, device=device)
    seeder.prefill(manifest)
    radon.aot_cache_clear()
    corrupted = faults.corrupt_blobs(aot_dir, seed=seed)
    print(f"[serve-chaos] corrupted {corrupted} AOT blobs in {aot_dir}")

    # oracles BEFORE the chaos run (process-global trace counters)
    rng = np.random.default_rng(seed)

    def oracle(n, img):
        return _oracle(n, img, device)
    traffic = []      # (spec, payload, submit kwargs, expected|None)
    for i in range(requests_n):
        n = ns[i % len(ns)]
        img = rng.integers(0, 100, (n, n)).astype(np.int32)
        kw = {}
        if i % 11 == 3:
            kw["deadline_s"] = 1e-6    # unmeetable SLO: typed rejection
        if i % 5 == 0:
            kw["priority"] = 1
        want = oracle(n, img) if "deadline_s" not in kw else None
        traffic.append(({"n": n}, img, kw, want))
    rt_img = rng.integers(0, 100, (ns[0], ns[0])).astype(np.int32)
    traffic.append(({"n": ns[0], "datapath": "roundtrip"}, rt_img, {},
                    rt_img))           # roundtrip oracle = the image
    flood_img = np.zeros((ns[0], ns[0]), np.int32)
    flood_want = oracle(ns[0], flood_img)
    for _ in range(flood_n):           # queue flood: bounded admission
        traffic.append(({"n": ns[0]}, flood_img, {}, flood_want))

    router = ServiceRouter(
        max_batch=4, max_wait_us=500.0, max_services=args.max_services,
        queue_cap=args.queue_cap, max_inflight=args.max_inflight,
        max_retries=1, retry_backoff_s=1e-3, aot_dir=aot_dir,
        device=device)
    router.prefill(manifest)
    _require(router.degraded_compiles() > 0,
             "corrupt blobs must surface as degraded_compiles")

    with faults.FaultInjector(seed=seed, sites=("dispatch",),
                              error_count=3, error_rate=0.05,
                              delay_s=0.002, delay_rate=0.3) as inj:
        outs = router.run_requests([(s, p, kw)
                                    for s, p, kw, _ in traffic])

    # force the degrade path deterministically: every dispatch attempt
    # of ONE targeted route fails, so retries exhaust and the staged
    # fallback must produce the (bit-exact) answer
    fallbacks_before = router.fallbacks
    rt_key = f"{ns[0]}x{ns[0]}/int32/roundtrip"
    with faults.FaultInjector(seed=seed + 1, sites=("dispatch",),
                              error_count=router.max_retries + 1,
                              match=rt_key):
        forced = router.run_requests(
            [({"n": ns[0], "datapath": "roundtrip"}, rt_img)])
    _require(np.array_equal(np.asarray(forced[0]), rt_img),
             "the fallback answer must stay bit-exact")
    _require(router.fallbacks > fallbacks_before,
             "exhausted retries must degrade to the fallback path")
    print(f"[serve-chaos] forced fallback on {rt_key}: bit-exact via "
          "the staged registry path")

    exact = typed = raw = wrong = 0
    for (spec, _p, _kw, want), out in zip(traffic, outs):
        if isinstance(out, ServiceError):
            typed += 1
        elif isinstance(out, BaseException):
            raw += 1
        elif want is not None and not np.array_equal(np.asarray(out),
                                                     want):
            wrong += 1
        else:
            exact += 1
    s = router.stats()
    accounted = (s["delivered"] + s["failed"] + s["pending"]
                 + router.rejected_deadline + router.rejected_shutdown)
    print(f"[serve-chaos] injected: {inj.stats()}")
    print(f"[serve-chaos] responses: exact={exact} typed={typed} "
          f"raw={raw} wrong={wrong} "
          f"(admitted={s['admitted']} accounted={accounted})")
    print(router.healthz())
    _require(wrong == 0, "a degraded response was NOT bit-exact")
    _require(raw == 0, "a failure escaped untyped")
    _require(s["pending"] == 0, "the router dropped a future")
    _require(s["admitted"] == accounted,
             "future accounting does not close")
    _require(typed > 0, "the flood/deadline pressure produced no rejection")
    _require(router.verdict() == "WARN",
             f"chaos must degrade to WARN, got {router.verdict()}")
    print("[serve-chaos] PASS: degraded to WARN, every response exact "
          "or typed")
    return outs


def serve_pool(args):
    """The supervised multi-process tier: spawn ``--workers`` framed
    jsonl router subprocesses over one shared ``--aot-dir``, serve a
    burst through the pool, verify bit-exactness against the local
    oracle, and print the aggregated pool healthz.  Every worker runs on
    ``--device``."""
    from .supervisor import WorkerPool
    device = resolve_device(args.device)
    rcfg = radon_smoke() if args.smoke else radon_config()
    n = args.n or rcfg.n
    manifest = (_load_manifest(args.manifest) if args.manifest
                else [{"n": n}])
    requests_n = args.requests or (16 if args.smoke else 64)
    aot_dir = args.aot_dir or tempfile.mkdtemp(prefix="repro_pool_aot_")

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 100, (n, n)).astype(np.int32)
            for _ in range(requests_n)]
    expected = [_oracle(n, im, device) for im in imgs]

    pool = WorkerPool(args.workers, aot_dir=aot_dir, manifest=manifest,
                      max_batch=args.batch, pending_cap=args.max_inflight,
                      device=str(device))
    with pool:
        t_boot = time.perf_counter()
        _require(pool.wait_ready(600.0), "pool workers never became ready")
        boot_s = time.perf_counter() - t_boot
        t0 = time.perf_counter()
        futs = [pool.submit({"n": n}, im) for im in imgs]
        outs = [f.result(timeout=300) for f in futs]
        dt = time.perf_counter() - t0
        report = pool.healthz(probe=True)
        print(pool.healthz_text(report))
    exact = all(np.array_equal(np.asarray(o), e)
                for o, e in zip(outs, expected))
    print(f"[serve-pool] workers={args.workers} N={n} "
          f"requests={requests_n}: {requests_n / dt:.1f} req/s "
          f"(boot {boot_s:.1f}s), exact={exact}")
    _require(exact, "pool responses must match the local oracle")
    return outs


def serve_pool_chaos(args):
    """Process-level chaos: ≥2 workers over one ``aot_dir``, one
    SIGKILLed mid-burst, stale compile locks torn in (dead-PID lock
    files seeded under the restarting worker), a pool flood, and
    env-armed in-worker fault injection.  Asserts the pool invariant:
    every admitted request delivered bit-exact against the local
    oracle or rejected typed, pool accounting closes, verdict WARN
    (never FAIL), and the killed worker is back -- warm, zero
    retraces, its stolen locks cleaned up -- before the run ends."""
    import os
    import subprocess

    from ..checkpoint.store import _blob_path, list_blobs
    from .errors import QueueFull, ServiceError
    from .supervisor import WorkerPool

    device = resolve_device(args.device)
    seed = args.chaos_seed
    ns = (13,) if args.smoke else (13, 17)
    max_batch = 4
    manifest = [{"n": n} for n in ns]
    requests_n = 24 if args.smoke else 48
    workers = max(2, args.workers)
    pending_cap = requests_n + 16
    aot_dir = args.aot_dir or tempfile.mkdtemp(prefix="repro_poolchaos_")

    # deterministic chaos INSIDE each worker, armed across the process
    # boundary via the env seam: the first dispatch in every worker
    # raises (the router's retry absorbs it), spec echoed in healthz
    fault_spec = f"sites=dispatch;error_count=1;seed={seed}"
    env = dict(os.environ, REPRO_FAULTS=fault_spec)

    rng = np.random.default_rng(seed)

    def oracle(n, img):
        return _oracle(n, img, device)

    traffic = []
    for i in range(requests_n):
        n = ns[i % len(ns)]
        img = rng.integers(0, 100, (n, n)).astype(np.int32)
        traffic.append((n, img, oracle(n, img)))
    flood_img = np.zeros((ns[0], ns[0]), np.int32)
    flood_want = oracle(ns[0], flood_img)

    pool = WorkerPool(workers, aot_dir=aot_dir, manifest=manifest,
                      max_batch=max_batch, pending_cap=pending_cap,
                      probe_interval_s=0.5, restart_backoff_s=0.25,
                      env=env, device=str(device))
    with pool:
        _require(pool.wait_ready(600.0), "pool workers never became ready")

        # -- cross-process compile coalescing: N cold workers, one
        # shared aot_dir -> exactly one compile per unique executable,
        # i.e. the pool-wide miss total equals the distinct blob count
        blobs = list_blobs(aot_dir)
        cold = pool.healthz(probe=True)
        miss_total = sum((w["persistent"] or {}).get("misses", 0)
                         for w in cold["workers"])
        hit_total = sum((w["persistent"] or {}).get("hits", 0)
                        for w in cold["workers"])
        print(f"[pool-chaos] cold start: {len(blobs)} blobs, "
              f"pool misses={miss_total} hits={hit_total}")
        _require(miss_total == len(blobs),
                 f"cross-process coalescing broken: {miss_total} compiles "
                 f"for {len(blobs)} unique executables")
        for w in cold["workers"]:
            _require(w["faults_env"] == fault_spec,
                     f"worker healthz must echo the fault spec, got {w}")

        # -- the burst, with worker 0 SIGKILLed while it has requests
        # in flight
        futs = [pool.submit({"n": n}, img) for n, img, _ in traffic]
        time.sleep(0.05)
        killed = pool.kill_worker(0)
        _require(killed, "chaos kill found no live worker process")
        print(f"[pool-chaos] SIGKILLed worker 0 mid-burst "
              f"({pool.pending()} pending)")

        # tear stale compile locks in under the worker that is about to
        # restart: dead-PID lock files next to every blob -- its warm
        # re-prefill must steal them, not deadlock on them
        corpse = subprocess.Popen(["sleep", "0"])
        corpse.wait()
        for key in blobs:
            with open(_blob_path(aot_dir, key) + ".lock", "w") as f:
                json.dump({"pid": corpse.pid, "key": key,
                           "time": time.time() - 3600.0}, f)
        print(f"[pool-chaos] seeded {len(blobs)} stale dead-PID locks")

        # -- flood the pool past its pending budget: typed QueueFull
        # with a retry_after_s hint, never unbounded queueing
        flood_futs, flood_rejects, hints = [], 0, []
        for _ in range(pending_cap + 32):
            try:
                flood_futs.append(pool.submit({"n": ns[0]}, flood_img))
            except QueueFull as e:
                flood_rejects += 1
                hints.append(e.retry_after_s)

        exact = typed = raw = wrong = 0
        want_list = [w for _n, _i, w in traffic] + \
            [flood_want] * len(flood_futs)
        for fut, want in zip(futs + flood_futs, want_list):
            try:
                out = fut.result(timeout=300)
            except ServiceError:
                typed += 1
                continue
            except Exception:
                raw += 1
                continue
            if np.array_equal(np.asarray(out), want):
                exact += 1
            else:
                wrong += 1
        print(f"[pool-chaos] responses: exact={exact} typed={typed} "
              f"raw={raw} wrong={wrong}; flood rejected "
              f"{flood_rejects} with hints={hints[:3]}...")

        # -- the killed worker must come back and serve, warm
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            if pool.wait_ready(10.0) and \
                    all(w.alive for w in pool._workers):
                break
            time.sleep(0.25)
        final = pool.healthz(probe=True)
        w0 = final["workers"][0]
        _require(w0["alive"] and w0["restarts"] >= 1,
                 f"killed worker was not restarted: {w0}")
        p0 = w0["persistent"] or {}
        _require(p0.get("misses", 0) == 0 and p0.get("hits", 0) > 0,
                 f"restarted worker must come back warm from blobs: {p0}")
        _require(p0.get("lock_steals", 0) >= len(blobs),
                 f"stale dead-PID locks were not stolen: {p0}")
        locks_left = [f for f in os.listdir(aot_dir)
                      if f.endswith(".lock")]
        _require(not locks_left, f"stolen locks not cleaned: {locks_left}")
        # serving again, zero retraces pool-wide (every geometry warm)
        post = [pool.submit({"n": ns[0]},
                            rng.integers(0, 100, (ns[0], ns[0]))
                            .astype(np.int32))
                for _ in range(2 * workers)]
        for f in post:
            f.result(timeout=300)
        final = pool.healthz(probe=True)
        for w in final["workers"]:
            _require(w["retraces_since_start"] == 0,
                     f"worker rebuilt in steady state: {w}")
        print(pool.healthz_text(final))

    # -- the invariant --------------------------------------------------
    _require(wrong == 0, "a pool response was NOT bit-exact")
    _require(raw == 0, "a worker failure escaped untyped")
    _require(pool.failed == 0, "raw failures booked in the pool ledger")
    _require(pool.pending() == 0, "the pool dropped a future")
    _require(pool.identity_ok(), "pool accounting identity does not close")
    _require(pool.workers_lost >= 1 and pool.worker_restarts >= 1,
             "the chaos kill did not register as a worker loss + restart")
    _require(pool.replays > 0,
             "killing a loaded worker must replay its in-flight requests")
    _require(flood_rejects > 0, "the flood produced no typed backpressure")
    _require(all(h is not None and h > 0 for h in hints),
             f"QueueFull must carry a positive retry_after_s hint: "
             f"{hints[:5]}")
    _require(pool.verdict() == "WARN",
             f"pool chaos must degrade to WARN, got {pool.verdict()}")
    print(f"[pool-chaos] PASS: worker lost+replayed+restarted warm, "
          f"{exact} exact / {typed} typed, identity closed, verdict WARN")
    return final


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
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="--mode lm: the architecture (configs.ARCH_IDS "
                         "or its dashed alias)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (radon: N=31, batch 8; lm: "
                         "the architecture's reduced config)")
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
    ap.add_argument("--requests", type=int, default=None,
                    help="concurrent single-image requests for --mode "
                         "service/pool (default: 64, or 2*batch with "
                         "--smoke; pool: 16 with --smoke)")
    ap.add_argument("--max-wait-us", type=float, default=2000.0,
                    help="service admission window: max microseconds a "
                         "request waits for co-batching after arrival")
    ap.add_argument("--arrival-us", type=float, default=0.0,
                    help="service traffic shape: request i arrives "
                         "i*arrival_us after the first (0 = all at once)")
    ap.add_argument("--aot-dir", default=None,
                    help="persistent executable cache directory for "
                         "--mode service/pool: a restart installs the "
                         "exported kernel libraries instead of running "
                         "nvcc")
    ap.add_argument("--datapath", default="forward",
                    choices=["forward", "inverse", "roundtrip", "conv",
                             "solve"],
                    help="what one service request computes (conv uses a "
                         "3x3 ones kernel; inverse and solve take "
                         "projection requests, solve returns the "
                         "least-squares reconstruction)")
    ap.add_argument("--jsonl", action="store_true",
                    help="--mode service: run the stdin-jsonl router "
                         "worker instead of the benchmark loop (submit/"
                         "healthz/shutdown ops; typed error codes)")
    ap.add_argument("--framed", action="store_true",
                    help="--jsonl: speak the supervisor's length-"
                         "prefixed frame protocol instead of bare "
                         "newline JSON")
    ap.add_argument("--sigterm-drain", action="store_true",
                    help="--jsonl: on SIGTERM stop reading stdin, flush "
                         "in-flight requests and emit a final healthz")
    ap.add_argument("--manifest", default=None,
                    help="geometry manifest (a JSON list of route specs, "
                         "or a file holding one) to prefill the router's "
                         "warm pool from")
    ap.add_argument("--max-services", type=int, default=8,
                    help="router residency bound: LRU-evict cold routes "
                         "beyond this many")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="router per-route queue cap (typed QueueFull "
                         "beyond it)")
    ap.add_argument("--max-inflight", type=int, default=256,
                    help="router global in-flight request budget (pool: "
                         "its pending budget)")
    ap.add_argument("--chaos", action="store_true",
                    help="--mode service/pool: run the fault-injection "
                         "chaos smoke (exact-or-typed responses, verdict "
                         "WARN)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="deterministic seed for --chaos fault injection")
    ap.add_argument("--workers", type=int, default=2,
                    help="--mode pool: number of supervised router "
                         "worker processes")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the backend capability table and exit")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="--mode lm: prompt tokens per sequence")
    ap.add_argument("--gen-tokens", type=int, default=16,
                    help="--mode lm: tokens generated per sequence")
    args = ap.parse_args(argv)
    if args.list_backends:
        return list_backends()
    if args.mode == "lm":
        return serve_lm(args)
    if args.mode == "pool":
        if args.chaos:
            return serve_pool_chaos(args)
        return serve_pool(args)
    if args.mode == "service":
        if args.chaos:
            return serve_chaos(args)
        if args.jsonl:
            return serve_jsonl_mode(args)
        return serve_service(args)
    return serve_radon(args)


if __name__ == "__main__":
    main()
