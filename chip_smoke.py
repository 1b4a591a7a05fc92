#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # on a machine with one CUDA card

Builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` with nvcc (one nvcc per library, all started together), holds
every kernel against its plain PyTorch version on the card, and drives
nine main paths -- six of the ``radon_251`` configuration (256 phantom
images of 251 x 251, int32; the serving tier at N = 251, also on a
mesh), the giant-N path and the LM substrate's serving and training
paths -- each with the launch counts set to 0 just before it and read
just after, then prints the cost models beside what it measured:

1. the exact forward and inverse DPRT through ``repro_torch.radon.DPRT``
   and ``python -m repro_torch.launch.serve --mode radon`` (kernel K1);
2. the fused projection-domain pipeline (kernel K2): ``radon.Conv2D``
   with a 3 x 3 ones kernel (bit-identical to the staged K1 / 1-D conv /
   K1 composition and to the direct oracle), the fused
   ``op.inverse @ ProjectionFilter(w) @ op``, the DPRT-based DFT and a
   float32 gradient check of ``Conv2D``;
3. the giant-N path (kernels K4/K5, the streamed kernel):
   ``serve --mode radon --n 4099 --batch 4 --stream-rows 256`` through
   K5, the raw functions with ``stream_impl="grid"`` through K4, the
   reference's N = 2053 acceptance image, a uint8 N = 4099 image (int32
   sums, int64 out), a float32 gradient and a streamed ``mul`` pipeline;
4. the mesh path (kernels K1 and K3, the pipeline's mesh tail) on a
   (1, 1) ``("data", "model")`` mesh at world size 1 over NCCL:
   ``serve --mesh-shape 1,1``, ``radon.Conv2D`` under
   ``radon.config(mesh=...)`` (equal to the unsharded K2 ``Conv2D``,
   with no K2 launch), the fused filter, the round trip and a float32
   gradient.  A further check runs each rank's step of the D = 4 mesh
   pipeline in turn on the one card (K1 and K3 at their row offsets,
   the collectives as sums), against K2 and a numpy oracle; and one
   masked CG solve on the mesh (K1 and K3 each iteration, no K2);
5. reconstruction (``radon.solve`` through float32 K1 and K2): the
   unmasked Sherman-Morrison solve (one K1 inverse, exact to the
   phantoms), the masked CG solve with 4 directions lost (one K2 ``mul``
   per iteration, equal to the plain-backend solve), the reference
   bench's N = 13 ``lstsq`` gate, fixed-count runs of preconditioned CG,
   LSQR and Landweber (their launches per iteration), a float32
   gradient's adjoint identity and per-image 3-D masks; timed per CG
   iteration beside the K2 ``mul`` kernel;
6. the serving tier (``repro_torch.launch.service.DPRTService`` at N =
   251, int32, max_batch 8: warm sizes 1, 2, 4, 8) on each datapath --
   forward, inverse, roundtrip, conv (3 x 3 ones), masked CG solve (4
   directions lost): 64 requests sequentially and coalesced, equal to
   each other and to the kernels' plain versions (``sfdprt_plain``,
   ``pipeline_plain``; solve: the ``gather`` backend), with zero builds
   after warmup, no fallback, one K1 per transform and one K2 per conv
   batch per executed batch and one K2 ``mul`` per CG iteration;
   images/s and p50/p99 of both; the persistent executable cache in
   three processes over one aot_dir (cold with nvcc; restored with an
   empty build directory and nvcc that raises; after
   ``faults.corrupt_blobs``); the router under seeded chaos with a
   manifest of N in (13, 31, 251); and a pool of two worker processes on
   the card, one SIGKILLed mid-traffic, every request answered once and
   exactly;
7. the LM substrate's serving path (plain PyTorch: the reference's
   substrate has no Pallas kernel, so none of K1-K5 may launch):
   ``python -m repro_torch.launch.serve --mode lm`` at its defaults
   (tinyllama-1.1b at full depth and width, float32 weights from seed
   0, batch 8, prompt 32, 16 greedy tokens); its prefill logits and
   tokens against the port's CPU run on the same weights, prefill +
   decode against teacher forcing, prefill and decode timed by CUDA
   events at prompt 32 / 16 and 512 / 128 beside their bounds, and one
   decode step profiled; the nine other architectures at published
   width, cut to one block pattern in depth (``lm_cut``), against
   teacher forcing; every smoke config on the card against the CPU;
8. the LM substrate's training path (plain PyTorch; none of K1-K5 may
   launch): ``python -m repro_torch.launch.train --arch tinyllama-1.1b
   --steps 4 --batch 8 --seq 128`` at full depth and width (float32), its
   13.2 GB checkpoint's size, save and restore times (restored equal to
   the run's state, then deleted); ``launch.steps.make_train_step`` at
   full width in float32 and bf16, timed by CUDA events beside its
   bound, its peak memory and one profiled step; at the cut depth
   (``lm_cut``): remat none / full / dots (the same loss and gradients,
   the bytes each keeps), one ``Trainer`` step on the card against the
   CPU, ``fail_at_step`` and a resumed run against an uninterrupted one,
   and a bf16 run's checkpoint restored;
9. the serving tier on a (1, 1) ("data", "model") mesh over NCCL
   (kernels K1 and K3): ``python -m repro_torch.launch.serve --mode
   service --mesh-shape 1,1``, then ``DPRTService(mesh=...)`` on each
   datapath at N = 251, max batch 8, 64 requests, sequentially and
   coalesced, equal to the unsharded service's responses from the same
   run and to the plain versions, one K1 per transform batch (the mesh
   inverse: K1's core), K1 + K3 per conv batch, K1 core per solve batch
   and K1 forward + K3 ``mul`` per CG iteration, no K2, zero builds
   after warmup on every rank, images/s and p50/p99 beside the
   unsharded service's; a restart of the conv and roundtrip services
   from an aot_dir on the mesh plan in two processes (the second
   restored with an empty build directory and nvcc that raises).

The cost phase: ``repro_torch.launch.hlo_cost.analyze_step`` over
tinyllama-1.1b at full width on meta structs (the float32 train step at
8 x 128 with remat full, prefill and a decode step at batch 8) with
``launch.roofline.roofline_terms`` at the float32 peak, beside the hand
bounds and the step ms the LM and training phases measured; and
``core.pareto.h100_strip_cost`` for K1 at ``radon_251`` at each
directions-per-block value the timing phase sweeps, beside its ms.

The tensor-parallel phase: tinyllama-1.1b at full width, the float32
train step (8 x 128) through ``launch.steps.make_train_step`` on a
(1, 1) NCCL mesh equal to the step with no mesh on the same weights and
batch (loss within 1e-5, parameters and first moments within 1e-4 of
each leaf's peak), both timed with CUDA events; two ``Trainer`` steps at
the cut depth on the (1, 1) mesh equal to no mesh; the (1, 2) step as
two processes on the one card over gloo with CUDA tensors (spawned under
a deadline) against the one-process step; every step at a rate that moves
each leaf by at least ten times the bound, so an unchanged state fails;
no K1-K5 launch in this process or in either rank.  Then ``launch.dryrun.run_cell`` for
``qwen3_0_6b`` ``decode_32k`` and tinyllama ``train_4k`` on the 16 x 16
production mesh (256 fake ranks): counts and predictions, printed beside
the measured step.

It checks that each path ran through its kernels without rebuilding
anything in the timed loop, fails if ptxas spills registers in any
instantiation of K1, K2, K3 or the streamed kernel, and times every
kernel against its bound, also with its design, registers and SASS
instructions per add (the conv window of K2 and K3: per multiply-add);
K1 also for one image (``Conv2D``'s kernel) and by directions per
block, K2 by m_block and K3 by directions per block (ms against blocks
per image), the streamed kernel by directions per block; and profiles
one ``Conv2D`` call of the pipeline path and one of the mesh path.

Output: progress lines, a ``{"serving": {...}}`` JSON line of the
serving phase's numbers (the mesh service's among them), an ``{"lm":
{...}}`` line of the LM phase's, a ``{"train": {...}}`` line of the
training phase's, a ``{"cost": {...}}`` line of the cost phase's, a
``{"tp": {...}}`` line of the tensor-parallel phase's (the dry-run cells
under ``"dryrun"``), then a
``{"kernels": [...]}`` JSON line (the int32 K1 and K3 rows also with
their ``mesh_service_launches``), the
card's name and power limit from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a machine without a CUDA card, or a directory that
holds this script without the port's sources.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:        # the port's H100 peaks; main() fails without torch or sources
    from repro_torch.launch.roofline import HW
except ImportError:
    HW = {}

#: H100 SXM peaks (NVIDIA data sheet, ``repro_torch.launch.roofline.HW``):
#: HBM3 bytes/s; int32 adds/s -- 132 SMs x 64 INT32 lanes x 1.98 GHz, half
#: the lane-ops/s behind the 67 TFLOP/s float32 figure (which counts an
#: FMA as two); float32 adds/s (128 lanes per SM); the float32 peak
#: outside the tensor cores and the bf16 dense tensor-core peak
HBM_BYTES_PER_S = HW.get("hbm_bw")
INT32_ADDS_PER_S = HW.get("int32_ops")
FP32_ADDS_PER_S = HW.get("sms", 0) * 128 * HW.get("sm_clock_hz", 0)
F32_FLOPS_PER_S = HW.get("f32_flops")
BF16_FLOPS_PER_S = HW.get("peak_flops")

SERVE_ITERS = 5
CONV_ITERS = 3
TIMING_REPS = 20
F32_RTOL = 1e-5
#: K2 float tolerance, relative to the largest per-direction output
#: (the terms the inverse sums; the output itself can be far smaller
#: after the -S correction cancels): float32 1e-5, float64 1e-12
PIPE_F32_REL = 1e-5
PIPE_F64_REL = 1e-12
#: DPRT-based DFT vs torch.fft.fft2 (both float32 FFTs of length N),
#: relative to the spectrum's peak
DFT_REL = 1e-5


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip-smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = TIMING_REPS, warm: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, got, want, n: int, tol=None) -> float:
    """Bit-exact for integers; floats within ``tol`` when given, else
    float32 within rtol 1e-5, atol 1e-4*N (summation order differs) and
    float64 within 1e-12 relative."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.double()).all()):
        fail(f"{name}: non-finite output")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if got.dtype.is_floating_point:
        scale = float(want.double().abs().max()) if want.numel() else 0.0
        if tol is None:
            tol = (1e-12 * max(scale, 1.0) if got.dtype == torch.float64
                   else 1e-4 * n + F32_RTOL * scale)
        if err > tol:
            fail(f"{name}: max |err| {err} > {tol}")
    elif not torch.equal(got, want):
        fail(f"{name}: integer result differs (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per library: {secs})")
    for name in secs:
        text = _build.build_log(name).strip()
        if text:
            log(f"nvcc output for {name}:\n{text}")


#: mangled type code -> dtype name, for the kernels' instantiations
_TYPES = {"i": "int32", "l": "int64", "f": "float32", "d": "float64"}
_KERNELS = ("stream_kernel", "sfdprt_kernel", "pipeline_kernel",
            "pipeline_tail_kernel", "pipeline_finish_kernel")


def _instance(mangled: str):
    """(kernel, dtype name, variant) of a mangled kernel instantiation --
    dtype "int32>int64" where an int32 operand stores int64 outputs,
    "int32>int64 gated" for the streamed kernel's narrow inverse;
    variant "grid"/"dma" for the streamed kernel, "K=<cols>" for K1, K2
    and K3, "" otherwise -- else None."""
    m = re.search(r"(" + "|".join(_KERNELS) + r")I([ilfd])(?:Li(\d+)E)?"
                  r"([ilfd])?(?:Lb([01])E)?", mangled)
    if m is None:
        return None
    kernel, code, v, out, narrow = m.groups()
    if kernel == "stream_kernel":
        variant = ("grid", "dma")[int(v)]
    else:
        variant = "" if v is None else f"K={v}"
    dtype = _TYPES[code]
    if out not in (None, code):
        dtype = f"{dtype}>{_TYPES[out]}"
    if narrow == "1":
        dtype += " gated"
    return kernel, dtype, variant


def ptxas_report(library: str) -> dict:
    """ptxas's registers and spill bytes per kernel instantiation of
    ``library``, from this run's build log: {(kernel, dtype, variant):
    {"regs", "spill_stores", "spill_loads"}}."""
    from repro_torch.kernels import _build
    report, current = {}, None
    for line in _build.build_log(library).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)", line)
        if m:
            current = _instance(m.group(1))
            continue
        if current is None:
            continue
        entry = report.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["regs"] = int(m.group(1))
    return report


def check_no_spills(library: str) -> dict:
    """ptxas_report(library), failing the run if any instantiation of the
    library spills registers."""
    report = ptxas_report(library)
    if not report:
        fail(f"no ptxas report in the build log of {library}")
    spills = {key: v for key, v in report.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        fail(f"ptxas spills registers in {library}: {spills}")
    return report


#: SASS mnemonics of one multiply-add of the conv window (32-bit types)
_MAD_OPS = ("IMAD", "FFMA", "DFMA")


def sass_hot_blocks(lib_path) -> dict:
    """For each kernel instantiation in the library at ``lib_path``
    (``cuobjdump -sass``), the basic block with the most shared-memory
    loads: its instructions, its LDS count and instructions per LDS (each
    LDS of a skew-sum's inner loop feeds one add, so this is the loop's
    instructions per add); and, where a block does multiply-adds, the one
    with the most (``mad_block``, K2 and K3: instructions per multiply-add
    of their conv window, counted as plain IMAD/FFMA/DFMA, so meaningful
    for the 32-bit types).  Blocks split at labels, at branch targets
    (cuobjdump labels only some of them: a loop's back edge may jump to
    an unlabelled address) and after branches."""
    import os
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         str(lib_path)], capture_output=True, text=True, timeout=300,
        check=True).stdout
    out = {}

    def close(name, rows):
        """rows: (address or None for a label, opcode, branch target)."""
        if name is None:
            return
        targets = {t for _, _, t in rows if t is not None}
        blocks, blk = [], None
        for addr, op, _ in rows:
            if blk is None or addr is None or addr in targets:
                blk = {"instructions": 0, "lds": 0, "mads": 0}
                blocks.append(blk)
            if addr is None:
                continue
            blk["instructions"] += 1
            blk["lds"] += op.startswith("LDS")
            blk["mads"] += op in _MAD_OPS
            if op.split(".")[0] in ("BRA", "EXIT", "RET", "JMP", "BRX"):
                blk = None
        if not blocks:
            return
        best = max(blocks, key=lambda b: b["lds"])
        entry = {"instructions": best["instructions"], "lds": best["lds"]}
        if best["lds"]:
            entry["per_lds"] = best["instructions"] / best["lds"]
        mad = max(blocks, key=lambda b: b["mads"])
        if mad["mads"] and name[0] in ("pipeline_kernel",
                                       "pipeline_tail_kernel"):
            entry["mad_block"] = {
                "instructions": mad["instructions"], "mads": mad["mads"],
                "per_mad": mad["instructions"] / mad["mads"]}
        out[name] = entry

    name, rows = None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close(name, rows)
            name, rows = _instance(m.group(1)), []
            continue
        if name is None:
            continue
        if re.match(r"\s*\.L_\w+:", line):
            rows.append((None, "", None))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        op = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip()).split()[0]
        t = re.search(r"\bBRA(?:\.\w+)*\s+(?:\w+,\s*)?0x([0-9a-f]+)",
                      m.group(2))
        rows.append((int(m.group(1), 16), op,
                     int(t.group(1), 16) if t else None))
    close(name, rows)
    return out


#: K1 and K2's register tile edges: N with one short column run (31: K =
#: 1, 61: K = 2; 257: K = 4 in 3 runs and, in K2, two conv runs of 32R),
#: m_block 1 (the block of row N holds no item) and 5 (row N shares its
#: block; the last block is short), stage heights that do not divide N
TILE_EDGE_NS = (31, 61)
PIPE_EDGE_NS = (31, 61, 257)
TILE_EDGE_MBLOCKS = (1, 5)
TILE_EDGE_HEIGHTS = (3, 7)
#: N at which K1 and K4/K5 run int32 sums stored as int64 against the
#: int64 plain version (257: K = 4 in 3 runs, int16's first int64 N)
NARROW_NS = (13, 61, 257)
#: N past K1's registers, each just above a limit, with the streamed
#: kernel the raw functions take there: K5 above 14336 (int32) / 7168
#: (int64), K4 above 28613 / 14291, where K5's ring holds one padded row
WIDE_ROUTES = (
    (14341, "int32", "dma"), (7177, "int64", "dma"),
    (28619, "int32", "grid"), (14293, "int64", "grid"))


def kernel_phase() -> dict:
    """K1 against its plain version: every mode, sign +-1, awkward blocks,
    batch 1 and 3, int32/int64 bit-exact, float32/float64 within
    tolerance, a nonzero row_offset, the inverse on non-transform inputs
    with negatives; the register tile's edges (N = 31 and 61, m_block 1
    and 5, stage heights 3 and 7, unaligned row_offset partials),
    int32 overflow, and N too wide for K1's block, which the raw
    functions stream through K5 or K4 (``WIDE_ROUTES``).  Fails if ptxas
    spilled in any instantiation."""
    import numpy as np
    import torch
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels.tuning import pallas_block_spec

    check_no_spills("sfdprt")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    dtypes = (torch.int32, torch.int64, torch.float32, torch.float64)
    worst = {}
    cases = 0
    for n in (5, 7, 13, 31, 61, 251):
        blocks = {pallas_block_spec(n)}
        blocks |= ({(3, 8), (5, 3), (n, 16), (1, 1)} if n <= 31
                   else {(16, 8), (97, 7)})
        for h, mb in sorted(blocks):
            for b in (1, 3):
                for dt in dtypes:
                    def make(shape, lo=-200, hi=256):
                        if dt.is_floating_point:
                            a = rng.random(shape)
                        else:
                            a = rng.integers(lo, hi, shape)
                        return torch.as_tensor(a).to(dt).to(dev)

                    g = make((b, n, n))
                    part = make((b, max(1, n - 2), n))
                    corr = make((b, n), -5000, 5000)
                    runs = [
                        ("core+", g, dict(sign=1, mode="core")),
                        ("core-", g, dict(sign=-1, mode="core")),
                        ("core+off", part, dict(sign=1, mode="core",
                                                row_offset=2)),
                        ("core-off", part, dict(sign=-1, mode="core",
                                                row_offset=n + 3)),
                        ("forward", g, dict(sign=1, mode="forward")),
                        ("forward-off", part, dict(sign=1, mode="forward",
                                                   row_offset=2)),
                        ("inverse", g, dict(sign=-1, mode="inverse",
                                            corr=corr)),
                    ]
                    for label, x, kw in runs:
                        got = S.sfdprt(x, strip_rows=h, m_block=mb, **kw)
                        torch.cuda.synchronize()
                        want = S.sfdprt_plain(x, **kw)
                        torch.cuda.synchronize()
                        mode = kw["mode"]
                        err = check_close(
                            f"K1 {label} N={n} H={h} M={mb} B={b} {dt}",
                            got, want, n)
                        worst[mode] = max(worst.get(mode, 0.0), err)
                        cases += 1
    for n in TILE_EDGE_NS:                   # the register tile's edges
        for mb in TILE_EDGE_MBLOCKS:
            for h in TILE_EDGE_HEIGHTS:
                for b in (1, 3):
                    for dt in dtypes:
                        def make(shape, lo=-200, hi=256):
                            if dt.is_floating_point:
                                a = rng.random(shape)
                            else:
                                a = rng.integers(lo, hi, shape)
                            return torch.as_tensor(a).to(dt).to(dev)

                        g = make((b, n, n))
                        # (N - 2)*N batch stride: image b at an unaligned
                        # address for b > 0
                        part = make((b, n - 2, n))
                        corr = make((b, n), -5000, 5000)
                        for label, x, kw in (
                                ("core+off", part, dict(sign=1, mode="core",
                                                        row_offset=3)),
                                ("core-off", part, dict(sign=-1, mode="core",
                                                        row_offset=n + 5)),
                                ("forward", g, dict(sign=1, mode="forward")),
                                ("forward-off", part,
                                 dict(sign=1, mode="forward", row_offset=1)),
                                ("inverse", g, dict(sign=-1, mode="inverse",
                                                    corr=corr))):
                            got = S.sfdprt(x, strip_rows=h, m_block=mb, **kw)
                            torch.cuda.synchronize()
                            err = check_close(
                                f"K1 edge {label} N={n} H={h} M={mb} B={b} "
                                f"{dt}", got, S.sfdprt_plain(x, **kw), n)
                            worst[kw["mode"]] = max(worst.get(kw["mode"], 0.0),
                                                    err)
                            cases += 1
    # int32 overflow: skew-sums, row sums and Z + corr wrap as in JAX, and
    # the inverse's floor divide sees negative numerators
    big = 2 ** 28
    for n in (13, 61, 251):
        h, mb = pallas_block_spec(n)
        g = torch.as_tensor(rng.integers(-big, big, (3, n, n)),
                            dtype=torch.int32).to(dev)
        corr = torch.as_tensor(rng.integers(-big, big, (3, n)),
                               dtype=torch.int32).to(dev)
        for label, kw in (("core+", dict(sign=1, mode="core")),
                          ("core-", dict(sign=-1, mode="core")),
                          ("forward", dict(sign=1, mode="forward")),
                          ("inverse", dict(sign=-1, mode="inverse",
                                           corr=corr))):
            got = S.sfdprt(g, strip_rows=h, m_block=mb, **kw)
            torch.cuda.synchronize()
            check_close(f"K1 overflow {label} N={n}", got,
                        S.sfdprt_plain(g, **kw), n)
            cases += 1
    # int32 sums stored as int64 (the forward of a narrow integer image):
    # int16-range values of both signs, against the int64 plain version
    for n in NARROW_NS:
        h, mb = pallas_block_spec(n)
        g = torch.as_tensor(rng.integers(-2 ** 15, 2 ** 15, (3, n, n)),
                            dtype=torch.int32).to(dev)
        part = g[:, 2:].contiguous()
        for label, x, kw in (
                ("core+", g, dict(sign=1, mode="core")),
                ("core-", g, dict(sign=-1, mode="core")),
                ("core-off", part, dict(sign=-1, mode="core", row_offset=2)),
                ("forward", g, dict(sign=1, mode="forward")),
                ("forward-off", part, dict(sign=1, mode="forward",
                                           row_offset=2))):
            before = S.NARROW_LAUNCHES
            got = S.sfdprt(x, strip_rows=h, m_block=mb,
                           out_dtype=torch.int64, **kw)
            torch.cuda.synchronize()
            if got.dtype != torch.int64 or S.NARROW_LAUNCHES != before + 1:
                fail(f"K1 narrow {label} N={n}: {got.dtype}, "
                     f"{S.NARROW_LAUNCHES - before} narrow launches")
            err = check_close(f"K1 narrow {label} N={n}", got,
                              S.sfdprt_plain(x.to(torch.int64), **kw), n)
            worst[kw["mode"]] = max(worst.get(kw["mode"], 0.0), err)
            cases += 1
    # N too wide for K1's block (14336 int32, 7168 int64 columns): the raw
    # functions stream it through K5, or K4 where K5's ring cannot hold
    # two padded rows (tuning.skew_holds / stream_dma_holds); 4-row
    # partials at full width, unaligned offsets, every mode
    from repro_torch.kernels import stream as ST
    for n, dt_name, impl in WIDE_ROUTES:
        dt = getattr(torch, dt_name)
        g = torch.as_tensor(rng.integers(-200, 256, (1, 4, n)),
                            dtype=dt).to(dev)
        corr = torch.as_tensor(rng.integers(-5000, 5000, (1, n)),
                               dtype=dt).to(dev)
        for label, kw in (("core-", dict(sign=-1, mode="core",
                                         row_offset=n - 2)),
                          ("forward", dict(sign=1, mode="forward",
                                           row_offset=3)),
                          ("inverse", dict(sign=-1, mode="inverse",
                                           corr=corr, row_offset=5))):
            k1_before = S.LAUNCHES
            st_before = ST.IMPL_MODE_LAUNCHES[(impl, kw["mode"])]
            got = S._skew(g, strip_rows=16, m_block=8, **kw)
            torch.cuda.synchronize()
            if (S.LAUNCHES != k1_before or ST.IMPL_MODE_LAUNCHES[
                    (impl, kw["mode"])] != st_before + 1):
                fail(f"wide N={n} {dt} {label} did not stream through "
                     f"{impl} alone")
            err = check_close(f"wide {impl} {label} N={n} {dt}", got,
                              S.sfdprt_plain(g, **kw), n)
            worst[kw["mode"]] = max(worst.get(kw["mode"], 0.0), err)
            cases += 1
            del got
    log(f"kernel phase: {cases} cases agree with the plain version "
        f"(max |err| by mode: {worst})")
    return worst


def pipeline_tol(got, aux_want):
    """K2's float tolerance: relative to the largest per-direction output
    the inverse sums (aux holds two of its rows), for the dtype."""
    import torch
    if not got.dtype.is_floating_point:
        return None
    scale = max(float(aux_want.double().abs().max()), 1.0)
    return (PIPE_F64_REL if got.dtype == torch.float64
            else PIPE_F32_REL) * scale


def pipe_stage(tile, n: int, itemsize: int, op: str, stage_rows: int):
    """K2's ``tile`` at N with stages of at most ``stage_rows`` rows (the
    ring re-sized in the slots it aliases, laid out by
    ``tuning.pipeline_geometry`` as ``tuning.pipeline_tile``'s own), for
    the edges."""
    from repro_torch.kernels.tuning import pipeline_geometry
    return pipeline_geometry(n, itemsize, op, tile.m_block, stage_rows)


def pipeline_kernel_phase() -> dict:
    """K2 against its plain version: ops none/mul/conv, operand forms
    image and proj, shared and batched operands, awkward m_block and
    group, batch 1 and 3, int32/int64 bit-exact, float32/float64 within
    tolerance, inputs with negatives (the mul case is no transform, so
    the final floor divide sees negative numerators) and int32 values
    whose sums and products overflow; the register tile's edges (N = 31,
    61 and 257 -- two conv runs of 32R there -- m_block 1 and 5, stage
    heights 3 and 7, batch 1 and 3).  Fails if ptxas spilled in any
    instantiation."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.sfdprt import sfdprt_plain
    from repro_torch.kernels.tuning import pipeline_block_spec, pipeline_tile

    check_no_spills("pipeline")
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    dtypes = (torch.int32, torch.int64, torch.float32, torch.float64)
    worst = {}
    cases = 0

    def run(label, f, w, op, form, mb, grp, stage_rows=None):
        nonlocal cases
        if stage_rows is None:
            got, got_aux = P.pipeline_raw(f, w, op=op, operand_form=form,
                                          m_block=mb, group=grp)
        else:
            n, item = f.shape[-1], f.element_size()
            tile = pipe_stage(pipeline_tile(n, item, mb, op), n, item, op,
                              stage_rows)
            got, got_aux = P.pipeline_launch_tile(f, w, tile, op=op,
                                                  operand_form=form)
        torch.cuda.synchronize()
        want, want_aux = P.pipeline_plain(f, w, op=op, operand_form=form)
        torch.cuda.synchronize()
        tol = pipeline_tol(got, want_aux)
        err = max(check_close(f"K2 {label} out", got, want, f.shape[-1], tol),
                  check_close(f"K2 {label} aux", got_aux, want_aux,
                              f.shape[-1], tol))
        worst[op] = max(worst.get(op, 0.0), err)
        cases += 1

    for n in (5, 7, 13, 31, 61, 251):
        blocks = {pipeline_block_spec(n)}
        blocks |= ({(1, 1), (3, 2), (8, 5), (n + 5, 4)} if n <= 31
                   else {(8, 4), (3, 1)})
        for mb, grp in sorted(blocks):
            for b in (1, 3):
                for dt in dtypes:
                    def make(shape, lo=-200, hi=256):
                        if dt.is_floating_point:
                            a = rng.random(shape)
                        else:
                            a = rng.integers(lo, hi, shape)
                        return torch.as_tensor(a).to(dt).to(dev)

                    f = make((b, n, n))
                    g1, gb = make((1, n, n), -9, 10), make((b, n, n), -9, 10)
                    runs = [
                        ("none", None, "none", "proj"),
                        ("mul shared", make((1, n + 1, n), -9, 10), "mul",
                         "proj"),
                        ("mul batched", make((b, n + 1, n), -9, 10), "mul",
                         "proj"),
                        ("conv image shared", g1, "conv", "image"),
                        ("conv image batched", gb, "conv", "image"),
                        ("conv proj shared",
                         sfdprt_plain(g1, sign=1, mode="forward"), "conv",
                         "proj"),
                        ("conv proj batched",
                         sfdprt_plain(gb, sign=1, mode="forward"), "conv",
                         "proj"),
                    ]
                    for label, w, op, form in runs:
                        run(f"{label} N={n} M={mb} G={grp} B={b} {dt}", f,
                            w, op, form, mb, grp)
    for n in PIPE_EDGE_NS:                   # the register tile's edges
        for mb in TILE_EDGE_MBLOCKS:
            for h in TILE_EDGE_HEIGHTS:
                for b in (1, 3):
                    for dt in dtypes:
                        def make(shape, lo=-200, hi=256):
                            if dt.is_floating_point:
                                a = rng.random(shape)
                            else:
                                a = rng.integers(lo, hi, shape)
                            return torch.as_tensor(a).to(dt).to(dev)

                        f = make((b, n, n))
                        gb = make((b, n, n), -9, 10)
                        for label, w, op, form in (
                                ("none", None, "none", "proj"),
                                ("mul", make((b, n + 1, n), -9, 10), "mul",
                                 "proj"),
                                ("conv image", gb, "conv", "image"),
                                ("conv proj", sfdprt_plain(
                                    gb, sign=1, mode="forward"), "conv",
                                 "proj")):
                            run(f"edge {label} N={n} M={mb} H={h} B={b} {dt}",
                                f, w, op, form, mb, 1, stage_rows=h)
    # int32 overflow: forward sums, conv products and inverse sums wrap
    for n in (13, 61, 251):
        big = 2 ** 28
        f = torch.as_tensor(rng.integers(-big, big, (3, n, n)),
                            dtype=torch.int32).to(dev)
        w = torch.as_tensor(rng.integers(-big, big, (3, n + 1, n)),
                            dtype=torch.int32).to(dev)
        g = torch.as_tensor(rng.integers(-big, big, (1, n, n)),
                            dtype=torch.int32).to(dev)
        for op, opd, form in (("none", None, "proj"), ("mul", w, "proj"),
                              ("conv", g, "image"), ("conv", w, "proj")):
            run(f"overflow {op} {form} N={n}", f, opd, op, form,
                *pipeline_block_spec(n))
    log(f"pipeline kernel phase: {cases} cases agree with the plain "
        f"version (max |err| by op: {worst})")
    return worst


def main_path_phase() -> dict:
    """The radon_251 main path on the card, through the operator API and
    the serve CLI; returns the launches per mode of that run."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.core.dprt import dprt_oracle_np
    from repro_torch.core.plan import _adjoint_epilogue
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.launch import serve

    cfg = config()
    n, b = cfg.n, cfg.batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    w = torch.from_numpy(rng.integers(-1000, 1000, (b, n + 1, n))
                         .astype(np.int32)).to(dev)
    xf = torch.from_numpy(rng.random((b, n, n), dtype=np.float32)).to(dev)
    wf = torch.from_numpy(rng.random((b, n + 1, n),
                                     dtype=np.float32)).to(dev)
    torch.cuda.synchronize()

    kernel_builds = radon.trace_count(kind="kernel")
    S.reset_launch_counts()
    P.reset_launch_counts()
    # -- the operator API: forward, inverse, adjoint, autograd ----------
    op = radon.DPRT(tuple(imgs.shape), torch.int32)
    if op.plan.method != "cuda":
        fail(f"auto resolved to {op.plan.method!r}, not the cuda kernel")
    r = op(imgs)
    back = op.inverse(r)
    at = op.T(w)
    opf = radon.DPRT(tuple(imgs.shape), torch.float32)
    x = xf.clone().requires_grad_(True)
    (wf * opf(x)).sum().backward()
    atf = opf.T(wf)
    torch.cuda.synchronize()
    # -- the serve CLI ---------------------------------------------------
    served = serve.main(["--mode", "radon", "--batch", str(b), "--n",
                         str(n), "--iters", str(SERVE_ITERS),
                         "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(S.MODE_LAUNCHES)
    if any(P.OP_LAUNCHES.values()):
        fail(f"the DPRT path launched K2 {dict(P.OP_LAUNCHES)}")

    want = {"forward": 2 + 1 + SERVE_ITERS, "inverse": 1 + 1 + SERVE_ITERS,
            "core": 3}
    if launches != want:
        fail(f"K1 launches on the main path {launches}, expected {want}")
    log(f"main path: K1 launches {launches} (expected {want})")

    if tuple(r.shape) != (b, n + 1, n) or r.dtype != torch.int32:
        fail(f"forward gave {tuple(r.shape)} {r.dtype}")
    if not torch.equal(back, imgs):
        fail("op.inverse(op(imgs)) is not bit-exact")
    if not torch.equal(served, r):
        fail("serve --mode radon projections differ from op(imgs)")
    check_close("forward vs plain", r,
                S.sfdprt_plain(imgs, sign=1, mode="forward"), n)
    ref0 = dprt_oracle_np(imgs[0].cpu().numpy())
    if not np.array_equal(r[0].cpu().numpy(), ref0):
        fail("forward of image 0 differs from the numpy oracle")
    plain_at = _adjoint_epilogue(
        S.sfdprt_plain(w[:, :n].contiguous(), sign=-1, mode="core"), w, n)
    check_close("op.T vs plain adjoint", at, plain_at, n)
    check_close("grad vs op.T", x.grad, atf, n)
    plain_atf = _adjoint_epilogue(
        S.sfdprt_plain(wf[:, :n].contiguous(), sign=-1, mode="core"), wf, n)
    err = check_close("grad vs plain adjoint", x.grad, plain_atf, n)
    if radon.trace_count(kind="kernel") != kernel_builds:
        fail("the main path rebuilt a kernel (they were built before it)")
    log(f"main path: N={n} B={b} round trip bit-exact, op.T exact, "
        f"float32 grad == adjoint (max |err| {err:.3g}), serve exact with "
        f"zero rebuilds in its timed loop")
    return launches


def pipeline_main_path_phase() -> dict:
    """The radon_251 pipeline path on the card: Conv2D (3 x 3 ones kernel)
    through K2, the fused filter composite, the DPRT-based DFT and a
    float32 gradient check; returns the launches of that run."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.core.conv import circ_conv1d_exact, circ_conv2d_direct
    from repro_torch.core.dft import dft2_via_dprt_batched
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.radon import flip_image

    cfg = config()
    n, b = cfg.n, cfg.batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    kern = torch.ones((3, 3), dtype=torch.int32, device=dev)
    w = torch.from_numpy(rng.integers(-7, 8, (n + 1, n))
                         .astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.random((4, 13, 13), dtype=np.float32)).to(dev)
    us = torch.from_numpy(rng.random((4, 13, 13), dtype=np.float32)).to(dev)
    ks = torch.from_numpy(rng.random((3, 3), dtype=np.float32)).to(dev)

    conv = radon.Conv2D(tuple(imgs.shape), kern)
    op = radon.DPRT(tuple(imgs.shape), torch.int32)
    filt = op.inverse @ radon.ProjectionFilter(w) @ op
    if conv.plan.method != "cuda" or not conv.describe()["pipeline"]:
        fail(f"Conv2D resolved to {conv.plan.method!r} without the pipeline")
    if len(filt.ops) != 1 or not isinstance(
            filt.ops[0], radon.FusedProjectionPipeline):
        fail(f"inverse @ filter @ forward was not fused: {filt!r}")
    conv(imgs)                  # warm: plans, appliers and kernels built
    torch.cuda.synchronize()

    kernel_builds = radon.trace_count(kind="kernel")
    S.reset_launch_counts()
    P.reset_launch_counts()
    # -- Conv2D: the timed loop must build nothing ------------------------
    walls = []
    with radon.retrace_guard(max_traces=0):
        for _ in range(CONV_ITERS):
            t0 = time.perf_counter()
            out = conv(imgs)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
    conv_launches = (dict(P.OP_LAUNCHES), dict(S.MODE_LAUNCHES))
    # -- the fused filter, the plain round trip, the DFT --------------------
    filtered = filt(imgs)
    round_trip = conv.plan.pipeline(imgs, "none")
    spectrum = dft2_via_dprt_batched(imgs)
    # -- float32 gradients of Conv2D in the image and in the kernel --------
    x = xs.clone().requires_grad_(True)
    k = ks.clone().requires_grad_(True)
    opg = radon.Conv2D(tuple(xs.shape), k, torch.float32)
    (opg(x) * us).sum().backward()
    with torch.no_grad():
        grad_t = opg.T(us)
    torch.cuda.synchronize()
    launches = {"conv": P.OP_LAUNCHES["conv"], "mul": P.OP_LAUNCHES["mul"],
                "none": P.OP_LAUNCHES["none"], "k1": dict(S.MODE_LAUNCHES)}

    # one Conv2D call = one K1 forward of the kernel + one K2 conv call
    want = ({"none": 0, "mul": 0, "conv": CONV_ITERS},
            {"core": 0, "forward": CONV_ITERS, "inverse": 0})
    if conv_launches != want:
        fail(f"Conv2D launches {conv_launches}, expected {want}")
    if launches["mul"] != 1 or launches["none"] != 1:
        fail(f"pipeline launches {launches}: the fused filter and the "
             f"round trip are one K2 call each")
    # backward: K2 conv (image) + K1 core (kernel projections' transpose)
    if launches["conv"] < CONV_ITERS + 3:
        fail(f"the gradient check did not run through K2: {launches}")
    if radon.trace_count(kind="kernel") != kernel_builds:
        fail("the pipeline path rebuilt a kernel")
    log(f"pipeline path: K2 launches by op {launches} (Conv2D: "
        f"{conv_launches}); Conv2D host ms {[round(t, 3) for t in walls]}")

    # -- checks (their own launches are not counted) -----------------------
    if tuple(out.shape) != (b, n, n) or out.dtype != torch.int32:
        fail(f"Conv2D gave {tuple(out.shape)} {out.dtype}")
    rf = op(imgs)
    rg = radon.DPRT((n, n), torch.int32)(conv.kernel)
    staged = op.inverse(circ_conv1d_exact(rf, rg))
    if not torch.equal(out, staged):
        fail("Conv2D differs from the staged K1 / 1-D conv / K1 path")
    for i in (0, b - 1):
        if not torch.equal(out[i], circ_conv2d_direct(imgs[i],
                                                      conv.kernel)):
            fail(f"Conv2D image {i} differs from circ_conv2d_direct")
    if not torch.equal(round_trip, imgs):
        fail("plan.pipeline(f, 'none') is not f")
    if not torch.equal(filtered, op.inverse(w * rf)):
        fail("the fused filter differs from op.inverse(w * op(f))")
    ref = torch.fft.fft2(imgs.float())
    derr = float((spectrum - ref).abs().max())
    dtol = DFT_REL * float(ref.abs().max())
    if spectrum.shape != ref.shape or derr > dtol:
        fail(f"DPRT-based DFT vs fft2: max |err| {derr} > {dtol}")
    check_close("Conv2D image grad vs op.T", x.grad, grad_t, 13)
    want_k = sum(circ_conv2d_direct(flip_image(xs[i]), us[i])
                 for i in range(xs.shape[0]))[:3, :3]
    check_close("Conv2D kernel grad vs correlation", k.grad, want_k, 13)
    log(f"pipeline path: N={n} B={b} Conv2D bit-exact vs staged and "
        f"direct, round trip exact, fused filter exact, DFT max |err| "
        f"{derr:.3g} (tol {dtol:.3g}), float32 grads agree")
    return launches


#: m_block values of K2's sweep at radon_251: blocks per image 32, 16,
#: 12, 8, 6 and 4 (the table's 64 gives 63 directions; the registers
#: allow 66 at most, so no m_block gives fewer blocks)
PIPE_SWEEP_MBLOCKS = (8, 16, 21, 32, 42, 64)


def pipeline_timing_phase(launches: dict, worst: dict) -> list:
    """K2 vs its plain version at the main path's shapes, per op, with its
    design, ptxas's registers and the SASS inner loops (instructions per
    add of the skew-sums, per multiply-add of the conv window); and, for
    conv and none, the kernel by m_block: ms against blocks per image,
    fitted as a + blocks * c, which separates the cost that every block of
    an image repeats (its pass over the image's rows and its N^2 atomics)
    from the cost of the directions."""
    import numpy as np
    import torch
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import _build
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.sfdprt import sfdprt_plain
    from repro_torch.kernels.tuning import pipeline_block_spec, pipeline_tile

    cfg = config()
    n, b = cfg.n, cfg.batch
    mb, grp = pipeline_block_spec(n)
    ptx = ptxas_report("pipeline")
    sass = sass_hot_blocks(_build._lib_path("pipeline"))
    dev = torch.device("cuda")
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    kern = torch.zeros((1, n, n), dtype=torch.int32, device=dev)
    kern[:, :3, :3] = 1
    rg = sfdprt_plain(kern, sign=1, mode="forward")
    w = torch.from_numpy(np.random.default_rng(5).integers(
        -7, 8, (1, n + 1, n)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    item = 4
    fwd = b * n * n * n + b * n * n       # skew-sum adds + row sums
    inv = b * n * n * n + 3 * b * n * n   # skew-sum adds + correction
    io = item * (b * n * n + b * n * n + 2 * b * n)   # f, out, aux
    cases = {
        "conv": (rg, "proj", io + item * (n + 1) * n,
                 fwd + b * (n + 1) * n * n + inv),
        "mul": (w, "proj", io + item * (n + 1) * n,
                fwd + b * (n + 1) * n + inv),
        "none": (None, "proj", io, fwd + inv),
    }
    rows = []
    for op, (opd, form, nbytes, ops) in cases.items():
        t = pipeline_tile(n, item, mb, op)
        k_ms = cuda_ms(lambda: P.pipeline_raw(f, opd, op=op,
                                              operand_form=form,
                                              m_block=mb, group=grp))
        p_ms = cuda_ms(lambda: P.pipeline_plain(f, opd, op=op,
                                                operand_form=form),
                       reps=3, warm=1)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / INT32_ADDS_PER_S
        key = ("pipeline_kernel", "int32", f"K={t.cols}")
        rows.append({
            "name": f"pipeline_kernel[{op}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pipeline.cu",
            "replaces": "src/repro/kernels/sfdprt.py:853",
            "launches": launches[op],
            "max_abs_err": worst.get(op, 0.0),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no PyTorch call computes an exact integer circular
            # convolution (or this fused round trip) on CUDA: integer
            # matmul/conv are not implemented there
            "library_ms": None,
            "shape": f"N={n} B={b} int32 m_block={mb}",
            "design": {"directions_per_block": t.m_block,
                       "blocks_per_image": t.blocks,
                       "consumer_warps": t.warps, "producer_warps": 1,
                       "cols_per_lane": t.cols, "items_per_warp": t.items,
                       "conv_run": t.conv_run, "conv_passes": t.conv_passes,
                       "stage_rows": t.stage_rows, "ring_slots": t.slots,
                       "smem_bytes": t.smem,
                       "atomics_per_call": b * t.blocks * n * n,
                       "ptxas": ptx.get(key),
                       "sass_hot_block": sass.get(key)},
        })
        log(f"timing pipeline {op}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({rows[-1]['bound_by']}; {ops:.4g} int32 ops; N={n} B={b} "
            f"int32 m_block {mb}; {rows[-1]['design']})")
        if op == "mul":
            continue
        by_m = {}
        for m in PIPE_SWEEP_MBLOCKS:
            tm = pipeline_tile(n, item, m, op)
            m_ms = cuda_ms(lambda: P.pipeline_launch_tile(f, opd, tm, op=op))
            by_m[m] = {"directions_per_block": tm.m_block,
                       "blocks_per_image": tm.blocks,
                       "consumer_warps": tm.warps, "ms": m_ms}
            log(f"timing pipeline {op} at m_block {m} ({tm.m_block} "
                f"directions, {tm.blocks} blocks per image, {tm.warps} "
                f"consumer warps): {m_ms:.4f} ms")
        xs = np.array([v["blocks_per_image"] for v in by_m.values()], float)
        ys = np.array([v["ms"] for v in by_m.values()])
        slope, icpt = np.polyfit(xs, ys, 1)
        share = slope * t.blocks / k_ms
        rows[-1]["by_m_block"] = by_m
        rows[-1]["per_block_fit"] = {"ms_per_block_per_image": slope,
                                     "ms_intercept": icpt,
                                     "per_block_share": share}
        log(f"timing pipeline {op}: ms ~ {icpt:.4f} + {slope:.4f} x blocks "
            f"per image; the per-block cost is {100 * share:.1f}% of the "
            f"kernel at {t.blocks} blocks per image")
    return rows


def pipeline_profile_phase(mesh: bool = False) -> None:
    """Where one radon_251 Conv2D call's device time goes, by kernel
    (torch.profiler over CONV_ITERS calls), and the device's busy share
    of the host wall time around them; ``mesh``: the Conv2D on the
    (1, 1) mesh of the mesh path (K1 and K3)."""
    import contextlib
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.launch.mesh import make_local_mesh

    cfg = config()
    n, b = cfg.n, cfg.batch
    dev = torch.device("cuda")
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    where = (radon.config(mesh=make_local_mesh(1, 1)) if mesh
             else contextlib.nullcontext())
    with where:
        conv = radon.Conv2D(tuple(imgs.shape),
                            torch.ones((3, 3), dtype=torch.int32,
                                       device=dev))
    conv(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CONV_ITERS):
            conv(imgs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_call = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            # "void (anonymous namespace)::pipeline_kernel<int>(int const*,
            # ...)" -> "pipeline_kernel<int>"; "Memset (Device)" stays
            m = re.search(r"(\w+)(<[^>]*>)?\(",
                          e.key.replace("(anonymous namespace)", ""))
            name = m.group(1) + (m.group(2) or "") if m else e.key
            per_call[name] = per_call.get(name, 0.0) + us / 1e3 / CONV_ITERS
    if not per_call:
        log("profile: the profiler saw no device time (not measured)")
        return
    busy = sum(per_call.values()) * CONV_ITERS / wall_ms
    log(f"profile: one {'mesh ' if mesh else ''}Conv2D call (N={n} B={b} "
        f"int32), device ms by "
        f"kernel {json.dumps(per_call)}; host wall {wall_ms / CONV_ITERS:.4f}"
        f" ms per call, device busy share {busy:.4f} (idle "
        f"{1 - busy:.4f})")


def k1_design(t, ptx: dict, sass: dict) -> dict:
    """K1's tile (``tuning.skew_tile``) with ptxas's registers and the
    SASS inner loop of its int32 instantiation."""
    key = ("sfdprt_kernel", "int32", f"K={t.cols}")
    return {"directions_per_block": t.m_block, "cols_per_lane": t.cols,
            "items_per_warp": t.items, "consumer_warps": t.warps,
            "producer_warps": 1, "stage_rows": t.stage_rows,
            "ring_slots": t.slots, "pad_cols": t.pad, "smem_bytes": t.smem,
            "blocks_per_image": t.blocks, "blocks_per_sm": t.per_sm,
            "ptxas": ptx.get(key), "sass_hot_block": sass.get(key)}


def timing_phase(launches: dict, worst: dict, one_image_launches: int
                 ) -> list:
    """K1 vs its plain version at the main path's shapes, per mode, with
    its design, ptxas's registers, the SASS inner loop's instructions per
    add and the adds per clock per SM; the forward of one image (B = 1,
    ``Conv2D``'s kernel, launched ``one_image_launches`` times on the
    pipeline path); and the forward by directions per block D and by the
    ring's shape."""
    import numpy as np
    import torch
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import _build
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels.tuning import (pallas_block_spec, skew_geometry,
                                            skew_tile)

    cfg = config()
    n, b = cfg.n, cfg.batch
    h, mb = pallas_block_spec(n)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptx = ptxas_report("sfdprt")
    sass = sass_hot_blocks(_build._lib_path("sfdprt"))
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    r = S.dprt_raw(f, strip_rows=h, m_block=mb)
    corr = (r[:, n, :] - r[:, 0, :].sum(1, keepdim=True,
                                        dtype=torch.int32)).contiguous()
    w = torch.from_numpy(np.random.default_rng(2).integers(
        -1000, 1000, (b, n, n)).astype(np.int32)).to(dev)
    one = f[:1].contiguous()
    torch.cuda.synchronize()
    item = 4
    cases = {
        "forward": (f, dict(sign=1, mode="forward"),
                    item * (b * n * n + b * (n + 1) * n),
                    b * n * n * n + b * n * n),
        "inverse": (r[:, :n], dict(sign=-1, mode="inverse", corr=corr),
                    item * (b * n * n + b * n + b * n * n),
                    b * n * n * n + 2 * b * n * n),
        "core": (w, dict(sign=-1, mode="core"),
                 item * 2 * b * n * n, b * n * n * n),
        "forward,B=1": (one, dict(sign=1, mode="forward"),
                        item * (n * n + (n + 1) * n), n * n * n + n * n),
    }
    rows = []
    for mode, (x, kw, nbytes, ops) in cases.items():
        k_ms = cuda_ms(lambda: S.sfdprt(x, strip_rows=h, m_block=mb, **kw))
        clock = sm_clock_mhz()[0]
        p_ms = cuda_ms(lambda: S.sfdprt_plain(x, **kw), reps=5, warm=1)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / INT32_ADDS_PER_S
        bx = x.shape[0]
        t = skew_tile(n, x.shape[1], item, h, mb, n + 1 if kw["mode"] ==
                      "forward" else n, batch=bx, sms=sms)
        mode_key = kw["mode"]
        rows.append({
            "name": f"sfdprt_kernel[{mode}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfdprt.cu",
            "replaces": "src/repro/kernels/sfdprt.py:210",
            "launches": (one_image_launches if bx == 1
                         else launches[mode_key]),
            "max_abs_err": worst.get(mode_key, 0.0),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no PyTorch call computes the skew-sum
            "library_ms": None,
            "shape": f"N={n} B={bx} int32",
            "design": k1_design(t, ptx, sass),
            "adds_per_clock_per_sm": bx * n ** 3 / (k_ms * 1e-3 * clock
                                                    * 1e6 * sms),
            "sm_clock_mhz": clock,
        })
        log(f"timing {mode}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({rows[-1]['bound_by']}; N={n} B={bx} int32; "
            f"{rows[-1]['adds_per_clock_per_sm']:.2f} adds/clock/SM at "
            f"{clock:.0f} MHz; {rows[-1]['design']})")
    # the forward by directions per block D (the tile lowers the largest
    # the registers allow to fill the waves of SMs)
    fwd = rows[0]
    base = skew_tile(n, n, item, h, mb, n + 1, batch=b, sms=sms)
    by_d = {}
    for d in sorted({8, 16, 24, base.m_block, 32, 40, 48, 56}):
        t = skew_geometry(n, item, n + 1, d, base.stage_rows, base.slots)
        warps = t.warps
        d_ms = cuda_ms(lambda: S.sfdprt_launch_tile(f, t, sign=1,
                                                    mode="forward"))
        by_d[d] = {"ms": d_ms, "blocks_per_image": t.blocks,
                   "consumer_warps": warps}
        log(f"timing K1 forward at D={d} ({warps} consumer warps, "
            f"{t.blocks} blocks per image): {d_ms:.4f} ms")
    fwd["by_directions_per_block"] = by_d
    # the forward by the ring's shape (stage rows x slots) at the tile's D
    by_stage = {}
    for sh, sl in ((base.stage_rows, base.slots), (11, 3), (9, 4)):
        t = skew_geometry(n, item, n + 1, base.m_block, sh, sl)
        s_ms = cuda_ms(lambda: S.sfdprt_launch_tile(f, t, sign=1,
                                                    mode="forward"))
        by_stage[f"{sh}x{sl}"] = s_ms
        log(f"timing K1 forward with stages of {sh} rows x {sl}: "
            f"{s_ms:.4f} ms")
    fwd["by_stage_shape"] = by_stage
    return rows


# ---------------------------------------------------------------------------
# slice 3: giant-N streaming (K4/K5)
# ---------------------------------------------------------------------------
GIANT_N = 4099
GIANT_BATCH = 4
GIANT_STREAM_ROWS = 256
GIANT_TIMING_REPS = 10
#: the reference's acceptance geometry (tests/test_stream.py): one
#: N = 2053 int32 image with stream_rows 256
ACCEPT_N = 2053
#: sizes of the K4/K5 kernel phase: every strip height and batch at the
#: small N, the table's blocks at the giant ones
STREAM_CHECK_NS = (5, 13, 61, 251)
STREAM_OVERFLOW_NS = (13, 251)
#: the register tile's edges: N whose column runs of 32*cols do not
#: divide it (31: one short run; 421: a second run of 5 columns), with
#: m_block 1 (the block of row N holds no item) and 5 (row N shares its
#: block; the last block is short), stage heights that do not divide N
STREAM_EDGE_NS = (31, 421)
STREAM_EDGE_MBLOCKS = (1, 5)
STREAM_EDGE_HEIGHTS = (3, 7)


def stream_kernel_phase() -> dict:
    """K4 (grid) and K5 (dma) against their plain version: every mode,
    sign +-1, row_offset partials (whose (N - 2)*N batch stride leaves
    images unaligned), strip heights 1, 7, the table's and > N, batch 1
    and 3, int32/int64 bit-exact (incl. int32 overflow and negative
    numerators of the inverse), float32/float64 within K1's tolerance;
    the register tile's edges (N = 31 and 421, m_block 1 and 5, stage
    heights 3 and 7); N = 2053 at the table's strip height; one N = 4099
    forward per impl; and one launch per call whatever the strip count."""
    import numpy as np
    import torch
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.kernels.tuning import pallas_block_spec

    check_no_spills("stream")
    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    dtypes = (torch.int32, torch.int64, torch.float32, torch.float64)
    worst = {}
    cases = 0

    def make(dt, shape, lo=-200, hi=256):
        if dt.is_floating_point:
            a = rng.random(shape)
        else:
            a = rng.integers(lo, hi, shape)
        return torch.as_tensor(a).to(dt).to(dev)

    def runs_for(g, part, corr, n):
        return [("core+", g, dict(sign=1, mode="core")),
                ("core-", g, dict(sign=-1, mode="core")),
                ("core+off", part, dict(sign=1, mode="core", row_offset=2)),
                ("core-off", part, dict(sign=-1, mode="core",
                                        row_offset=n + 3)),
                ("forward", g, dict(sign=1, mode="forward")),
                ("forward-off", part, dict(sign=1, mode="forward",
                                           row_offset=2)),
                ("inverse", g, dict(sign=-1, mode="inverse", corr=corr))]

    def check(label, x, h, mb, kw):
        nonlocal cases
        want = ST.stream_plain(x, stream_rows=h, **kw)
        torch.cuda.synchronize()
        for impl in ST.STREAM_IMPLS:
            got = ST.stream_raw(x, stream_rows=h, m_block=mb,
                                stream_impl=impl, **kw)
            torch.cuda.synchronize()
            err = check_close(f"K4/K5 {impl} {label}", got, want,
                              x.shape[-1])
            key = f"{impl},{kw['mode']}"
            worst[key] = max(worst.get(key, 0.0), err)
            cases += 1

    for n in STREAM_CHECK_NS:
        th, tm = pallas_block_spec(n)
        for h in sorted({1, 7, th, n + 5}):
            for b in (1, 3):
                for dt in dtypes:
                    g = make(dt, (b, n, n))
                    part = make(dt, (b, max(1, n - 2), n))
                    corr = make(dt, (b, n), -5000, 5000)
                    for label, x, kw in runs_for(g, part, corr, n):
                        check(f"{label} N={n} H={h} M={tm} B={b} {dt}", x,
                              h, tm, kw)
    for n in STREAM_EDGE_NS:                 # the register tile's edges
        for mb in STREAM_EDGE_MBLOCKS:
            for h in STREAM_EDGE_HEIGHTS:
                for dt in dtypes:
                    g = make(dt, (2, n, n))
                    part = make(dt, (2, n - 2, n))
                    corr = make(dt, (2, n), -5000, 5000)
                    for label, x, kw in runs_for(g, part, corr, n):
                        check(f"edge {label} N={n} H={h} M={mb} {dt}", x, h,
                              mb, kw)
    big = 2 ** 28
    for n in STREAM_OVERFLOW_NS:             # int32 overflow
        th, tm = pallas_block_spec(n)
        g = make(torch.int32, (3, n, n), -big, big)
        part = make(torch.int32, (3, n - 2, n), -big, big)
        corr = make(torch.int32, (3, n), -big, big)
        for label, x, kw in runs_for(g, part, corr, n):
            check(f"overflow {label} N={n} H=7", x, 7, tm, kw)
    n = ACCEPT_N                             # giant N, the table's blocks
    th, tm = pallas_block_spec(n)
    for dt in (torch.int32, torch.int64):
        g = make(dt, (1, n, n))
        corr = make(dt, (1, n), -5000, 5000)
        for label, kw in (("core+", dict(sign=1, mode="core")),
                          ("core-", dict(sign=-1, mode="core")),
                          ("forward", dict(sign=1, mode="forward")),
                          ("inverse", dict(sign=-1, mode="inverse",
                                           corr=corr))):
            check(f"{label} N={n} H={th} M={tm} {dt}", g, th, tm, kw)
    n = GIANT_N
    th, tm = pallas_block_spec(n)
    g = make(torch.int32, (1, n, n), 0, 256)
    check(f"forward N={n} H={th} M={tm}", g, th, tm,
          dict(sign=1, mode="forward"))
    # int32 sums stored as int64 (the forward of a narrow integer image):
    # int16-range values of both signs at the check sizes, and the uint8
    # range at giant N, against the int64 plain version
    narrow = [(n, g, 3, "uint8 range")]
    for n2 in NARROW_NS:
        narrow.append((n2, make(torch.int32, (2, n2, n2), -2 ** 15, 2 ** 15),
                       2, "int16 range"))
    for n2, x, off, what in narrow:
        th, tm = pallas_block_spec(n2)
        want64 = x.to(torch.int64)
        for label, kw in (("core-", dict(sign=-1, mode="core")),
                          ("forward", dict(sign=1, mode="forward")),
                          ("forward-off", dict(sign=1, mode="forward",
                                               row_offset=off))):
            xs = x[:, off:].contiguous() if "off" in label else x
            want = ST.stream_plain(want64[:, off:].contiguous()
                                   if "off" in label else want64,
                                   stream_rows=th, **kw)
            for impl in ST.STREAM_IMPLS:
                before = ST.NARROW_LAUNCHES
                got = ST.stream_raw(xs, stream_rows=th, m_block=tm,
                                    stream_impl=impl, out_dtype=torch.int64,
                                    **kw)
                torch.cuda.synchronize()
                if (got.dtype != torch.int64
                        or ST.NARROW_LAUNCHES != before + 1):
                    fail(f"K4/K5 {impl} narrow {label} N={n2}: {got.dtype}, "
                         f"{ST.NARROW_LAUNCHES - before} narrow launches")
                err = check_close(f"K4/K5 {impl} narrow {label} N={n2} "
                                  f"{what}", got, want, n2)
                key = f"{impl},{kw['mode']}"
                worst[key] = max(worst.get(key, 0.0), err)
                cases += 1
            del want
    # one launch per call, whatever the strip count; K1 never
    g = make(torch.int32, (1, 61, 61))
    for h in (7, 14):
        for impl in ST.STREAM_IMPLS:
            for mode in ("forward", "core"):
                before = (ST.LAUNCHES, S.LAUNCHES)
                if mode == "core":
                    S.skew_sum_raw(g, -1, m_block=16, stream_rows=h,
                                   stream_impl=impl)
                else:
                    S.dprt_raw(g, m_block=16, stream_rows=h,
                               stream_impl=impl)
                torch.cuda.synchronize()
                if (ST.LAUNCHES, S.LAUNCHES) != (before[0] + 1, before[1]):
                    fail(f"streamed {impl} {mode} at H={h} launched "
                         f"{ST.LAUNCHES - before[0]} streamed and "
                         f"{S.LAUNCHES - before[1]} K1 kernels, not 1 and 0")
    # the gated inverse of int64 operands: a batch of one image of uint8
    # projections, one spread over 2**40 and one at the gate's edge, per
    # impl, against today's int64 kernel (no bounds) and the plain pair
    for n2 in (13, 61, 251):
        proj = S.dprt_raw(make(torch.int64, (1, n2, n2), 0, 256),
                          m_block=16, stream_rows=7)
        lo, span = -2 ** 31, (2 ** 32 - 1) // n2
        r = torch.cat([proj, make(torch.int64, (1, n2 + 1, n2), -2 ** 40,
                                  2 ** 40),
                       make(torch.int64, (1, n2 + 1, n2), lo,
                            lo + span + 1)])
        r[2, 0, 0], r[2, 1, 1] = lo, lo + span
        corr = (r[:, n2] - r[:, 0].sum(1, keepdim=True)).contiguous()
        plain = S.idprt_raw(r.cpu(), m_block=16, stream_rows=7).to(dev)
        for impl in ST.STREAM_IMPLS:
            ST.reset_launch_counts()
            got = S.idprt_raw(r, m_block=16, stream_rows=7,
                              stream_impl=impl)
            want = ST.stream_raw(r[:, :n2], sign=-1, mode="inverse",
                                 stream_rows=7, m_block=16, corr=corr,
                                 stream_impl=impl)
            torch.cuda.synchronize()
            images = ST.narrow_inverse_images(dev)
            if (not torch.equal(got, want) or not torch.equal(got, plain)
                    or images != 2 or ST.LAUNCHES != 3):
                fail(f"gated inverse {impl} N={n2}: equal to the int64 "
                     f"kernel {torch.equal(got, want)}, to the plain pair "
                     f"{torch.equal(got, plain)}, {images} narrow images "
                     f"(2), {ST.LAUNCHES} launches (3)")
            cases += 1
    log(f"stream kernel phase: {cases} cases agree with the plain version "
        f"(max |err| by impl,mode: {worst}); one launch per call at H=7, "
        f"14; the gated inverse equals the int64 kernel at N = 13, 61, 251")
    return worst


def giant_main_path_phase() -> dict:
    """The giant-N path on the card: ``serve --mode radon --n 4099
    --batch 4 --stream-rows 256`` (K5), the raw functions with
    ``stream_impl="grid"`` (K4), the N = 2053 acceptance image, a uint8
    N = 4099 image (int32 sums, int64 out), a float32 gradient and a
    streamed ``mul`` pipeline; returns the launches of that run by
    (stream_impl, mode), and under "int32>int64" those of int32 sums
    stored as int64."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.core.dprt import accum_dtype_for
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.launch import serve

    n, b, sr = GIANT_N, GIANT_BATCH, GIANT_STREAM_ROWS
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    n2 = ACCEPT_N
    f2 = torch.from_numpy(rng.integers(0, 256, (n2, n2), dtype=np.int32)
                          ).to(dev)
    w2 = torch.from_numpy(rng.integers(-9, 10, (n2 + 1, n2),
                                       dtype=np.int32)).to(dev)
    u8 = torch.from_numpy(rng.integers(0, 256, (n, n), dtype=np.uint8)
                          ).to(dev)
    xf = torch.from_numpy(rng.random((2, 251, 251), dtype=np.float32)
                          ).to(dev)
    wf = torch.from_numpy(rng.random((2, 252, 251), dtype=np.float32)
                          ).to(dev)
    torch.cuda.synchronize()

    kernel_builds = radon.trace_count(kind="kernel")
    S.reset_launch_counts()
    P.reset_launch_counts()
    ST.reset_launch_counts()
    t0 = time.perf_counter()
    # -- the serve CLI (K5) ------------------------------------------------
    served = serve.main(["--mode", "radon", "--n", str(n), "--batch",
                         str(b), "--stream-rows", str(sr), "--iters",
                         str(SERVE_ITERS), "--device", "cuda"])
    # -- the raw functions with stream_impl="grid" (K4) ---------------------
    r_grid = S.dprt_raw(imgs, m_block=64, stream_rows=sr, stream_impl="grid")
    back_grid = S.idprt_raw(r_grid, m_block=64, stream_rows=sr,
                            stream_impl="grid")
    z_grid = S.skew_sum_raw(r_grid[:, :n], -1, m_block=64, stream_rows=sr,
                            stream_impl="grid")   # the adjoint's core
    # -- the acceptance image, uint8, gradient, pipeline (K5) --------------
    op2 = radon.DPRT((n2, n2), torch.int32, stream_rows=sr)
    r2 = op2(f2)
    back2 = op2.inverse(r2)
    op8 = radon.DPRT((n, n), torch.uint8, stream_rows=sr)
    r8 = op8(u8)
    back8 = op8.inverse(r8)
    opf = radon.DPRT(tuple(xf.shape), torch.float32, stream_rows=64)
    x = xf.clone().requires_grad_(True)
    (wf * opf(x)).sum().backward()
    piped = op2.plan.pipeline(f2, "mul", w2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: v for key, v in ST.IMPL_MODE_LAUNCHES.items() if v}
    k1, k2 = dict(S.MODE_LAUNCHES), dict(P.OP_LAUNCHES)
    narrow = ST.NARROW_LAUNCHES
    gated = (ST.NARROW_INVERSE_LAUNCHES, ST.narrow_inverse_images(dev))

    # serve: 1 warm + SERVE_ITERS each way; then N=2053, uint8 (its
    # inverse the gated pair of two launches), the gradient's forward and
    # adjoint (core), the staged mul pipeline
    want = {("dma", "forward"): 1 + SERVE_ITERS + 1 + 1 + 1 + 1,
            ("dma", "inverse"): 1 + SERVE_ITERS + 1 + 2 + 1,
            ("dma", "core"): 1,
            ("grid", "forward"): 1, ("grid", "inverse"): 1,
            ("grid", "core"): 1}
    if launches != want:
        fail(f"streamed launches on the giant-N path {launches}, expected "
             f"{want}")
    if any(k1.values()) or any(k2.values()):
        fail(f"the giant-N path launched K1 {k1} / K2 {k2}")
    if narrow != 1:  # the uint8 forward sums in int32, nothing else does
        fail(f"{narrow} streamed launches stored int32 sums as int64 on "
             f"the giant-N path, not 1 (the uint8 forward)")
    if gated != (1, 1):  # the uint8 inverse: one gated call, one image
        fail(f"gated inverse calls / images {gated} on the giant-N path, "
             f"not (1, 1) (the uint8 inverse)")
    if radon.trace_count(kind="kernel") != kernel_builds:
        fail("the giant-N path rebuilt a kernel")
    log(f"giant-N path: streamed launches {launches}, K1 0, K2 0, zero "
        f"builds; {wall:.2f} s host wall for the whole path")

    # -- checks (their own launches are not counted) ------------------------
    if tuple(served.shape) != (b, n + 1, n) or served.dtype != torch.int32:
        fail(f"serve gave {tuple(served.shape)} {served.dtype}")
    if not torch.equal(r_grid, served):
        fail("K4 (grid) projections differ from K5's (serve)")
    if not torch.equal(back_grid, imgs):
        fail("K4 round trip is not bit-exact")
    check_close("K4 core vs plain", z_grid[:1],
                ST.stream_plain(r_grid[:1, :n].contiguous(), sign=-1,
                                mode="core", stream_rows=sr), n)
    check_close("served projections vs plain", served[:1],
                ST.stream_plain(imgs[:1].contiguous(), sign=1,
                                mode="forward", stream_rows=sr), n)
    f2n = f2.cpu().numpy().astype(np.int64)
    r2n = r2.cpu().numpy()
    cols = np.arange(n2)
    for m in (0, 1, n2 - 1):
        want_m = np.zeros(n2, dtype=np.int64)
        for i in range(n2):
            want_m += f2n[i, (cols + m * i) % n2]
        if not np.array_equal(r2n[m], want_m):
            fail(f"N={n2} projection row {m} differs from the oracle")
    if not np.array_equal(r2n[n2], f2n.sum(axis=1)):
        fail(f"N={n2} row-sum row differs from the oracle")
    if not torch.equal(back2, f2):
        fail(f"N={n2} round trip is not bit-exact")
    acc8 = accum_dtype_for(torch.uint8, n)
    if (r8.dtype != acc8 or (n >= 2903 and acc8 != torch.int64)
            or not torch.equal(back8, u8.to(acc8))):
        fail(f"uint8 N={n} round trip: {r8.dtype} / {back8.dtype}, not "
             f"exact in int64")
    check_close("streamed float32 grad vs op.T", x.grad, opf.T(wf), 251)
    if not torch.equal(piped, op2.inverse(w2 * op2(f2))):
        fail("the streamed mul pipeline differs from op.inverse(w * op(f))")
    log(f"giant-N path: N={n} B={b} serve round trip exact (K5) and equal "
        f"to K4's; N={n2} oracle rows 0, 1, N-1, N and round trip exact; "
        f"uint8 N={n} (int32 sums, int64 out; the inverse gated to int32 "
        f"sums) round trip exact; float32 "
        f"grad == op.T; "
        f"streamed mul pipeline exact")
    return {**launches, "int32>int64": narrow, "gated inverse": gated[0]}


def sm_clock_mhz() -> tuple:
    """(current, max) SM clock of card 0 from nvidia-smi, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def stream_bound(nbytes, ops) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` at HBM
    bandwidth and ``ops`` int32 operations at the card's rate."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_ADDS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def stream_timing_phase(launches: dict, worst: dict) -> list:
    """K4 and K5 vs their plain version and vs K1 at the giant-N path's
    shape (N = 4099, B = 4, int32, stream_rows 256), per mode, with each
    row's design (directions per block, the register tile, stage rows and
    ring depth) and ptxas's registers and spills; K5 forward also at the
    largest direction block the registers allow (the tile lowers it to
    fill the waves of SMs) and at ``radon_251`` beside K1; K5 forward on
    int64 accumulators (B = 1) and on the uint8 images' route, int32 sums
    stored as int64 (B = 4)."""
    import numpy as np
    import torch
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import _build
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.kernels.tuning import (STREAM_WARPS, pallas_block_spec,
                                            skew_tile, stream_tile)

    n, b, sr = GIANT_N, GIANT_BATCH, GIANT_STREAM_ROWS
    _, mb = pallas_block_spec(n)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptx = ptxas_report("stream")
    sass = sass_hot_blocks(_build._lib_path("stream"))
    log(f"ptxas (registers, spill bytes) by instantiation: {ptx}")
    log(f"SASS hot block by instantiation: {sass}")
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    r = S.dprt_raw(f, m_block=mb, stream_rows=sr)
    corr = (r[:, n, :] - r[:, 0, :].sum(1, keepdim=True,
                                        dtype=torch.int32)).contiguous()
    rz = r[:, :n]
    torch.cuda.synchronize()
    cases = {
        "forward": (f, dict(sign=1, mode="forward"),
                    b * (n * n + (n + 1) * n), b * n ** 3 + b * n * n),
        "inverse": (rz, dict(sign=-1, mode="inverse", corr=corr),
                    b * (n * n + n + n * n), b * n ** 3 + 2 * b * n * n),
        "core": (rz, dict(sign=-1, mode="core"), 2 * b * n * n, b * n ** 3),
    }
    replaces = {"grid": "src/repro/kernels/sfdprt.py:396",
                "dma": "src/repro/kernels/sfdprt.py:457"}

    def design(t, impl, batch, dtype):
        return {"directions_per_block": t.m_block, "cols_per_lane": t.cols,
                "items_per_warp": t.items, "consumer_warps": t.warps,
                "producer_warps": int(impl == "dma"),
                "stage_rows": t.stage_rows, "ring_slots": t.slots,
                "cluster": 1, "pad_cols": t.pad, "smem_bytes": t.smem,
                "blocks": batch * t.blocks,
                "image_rereads": t.blocks,
                "ptxas": ptx.get(("stream_kernel", dtype, impl)),
                "sass_hot_block": sass.get(("stream_kernel", dtype, impl))}

    def rates(k_ms, adds, t, batch, nbytes_image, clock_mhz):
        secs = k_ms * 1e-3
        return {"adds_per_clock_per_sm": adds / (secs * clock_mhz * 1e6
                                                 * sms),
                "reread_tb_s": batch * t.blocks * nbytes_image / secs / 1e12,
                "sm_clock_mhz": clock_mhz}

    plain = {}
    for mode, (x, kw, _, _) in cases.items():
        # the plain version at B = 1, scaled to B (it is linear in B)
        one = x[:1]
        kw1 = dict(kw, corr=kw["corr"][:1]) if "corr" in kw else kw
        plain[mode] = b * cuda_ms(
            lambda: ST.stream_plain(one, stream_rows=sr, **kw1),
            reps=1, warm=0)
    rows = []
    for impl in ST.STREAM_IMPLS:
        for mode, (x, kw, elems, ops) in cases.items():
            t = stream_tile(n, n, 4, sr, mb, n + 1 if mode == "forward"
                            else n, impl, batch=b, sms=sms)
            k_ms = cuda_ms(lambda: ST.stream_raw(
                x, stream_rows=sr, m_block=mb, stream_impl=impl, **kw),
                reps=GIANT_TIMING_REPS, warm=1)
            clock = sm_clock_mhz()[0]
            b_ms, by = stream_bound(4 * elems, ops)
            rows.append({
                "name": f"stream_kernel[{impl},{mode}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/stream.cu",
                "replaces": replaces[impl],
                "launches": launches.get((impl, mode), 0),
                "max_abs_err": worst.get(f"{impl},{mode}", 0.0),
                "ms": k_ms,
                "plain_ms": plain[mode],
                "plain_ms_note": "B=1 run x B",
                "bound_ms": b_ms,
                "bound_by": by,
                # no PyTorch call computes the skew-sum
                "library_ms": None,
                "shape": f"N={n} B={b} int32 stream_rows={sr}",
                "design": design(t, impl, b, "int32"),
                **rates(k_ms, b * n ** 3, t, b, 4 * n * n, clock),
            })
            log(f"timing stream {impl} {mode}: kernel {k_ms:.4f} ms, plain "
                f"(B=1 x {b}) {plain[mode]:.4f} ms, bound {b_ms:.4f} ms "
                f"({by}; N={n} B={b} int32 stream_rows={sr}; "
                f"{rows[-1]['design']}; "
                f"{rows[-1]['adds_per_clock_per_sm']:.2f} adds/clock/SM at "
                f"{clock:.0f} MHz, rereads {rows[-1]['reread_tb_s']:.2f} "
                f"TB/s)")
    k5_fwd = next(row for row in rows
                  if row["name"] == "stream_kernel[dma,forward]")
    # K5 forward by directions per block D, from the largest the registers
    # allow: a block's cost against D (kernels/tuning.py:STREAM_BLOCK_COST)
    t = stream_tile(n, n, 4, sr, mb, n + 1, "dma", batch=b, sms=sms)
    dmax = min(mb, n + 1, STREAM_WARPS["dma"] * t.items // t.runs)
    by_d = {}
    for d in sorted({dmax, dmax - 2, 5, 1}, reverse=True):
        warps = -(-d * t.runs // t.items)
        tile_d = t._replace(m_block=d, warps=warps, blocks=-(-(n + 1) // d))
        d_ms = cuda_ms(lambda: ST.stream_launch_tile(
            f, tile_d, sign=1, mode="forward", stream_impl="dma"),
            reps=2, warm=1)
        waves = -(-b * tile_d.blocks // sms)
        by_d[d] = {"ms": d_ms, "blocks": b * tile_d.blocks, "waves": waves,
                   "ms_per_block": d_ms / waves}
        log(f"timing stream dma forward at D={d} ({warps} warps, "
            f"{b * tile_d.blocks} blocks, {waves} waves): {d_ms:.4f} ms, "
            f"{d_ms / waves:.4f} ms per block")
    k5_fwd["by_directions_per_block"] = by_d
    # the comparison: K1 forward at the same shape, without stream_rows;
    # K1 is not on this path, so it is a field of the K5 forward row, not
    # a row of its own
    th, _ = pallas_block_spec(n)
    k1_ms = cuda_ms(lambda: S.sfdprt(f, sign=1, mode="forward",
                                     strip_rows=th, m_block=mb),
                    reps=GIANT_TIMING_REPS, warm=1)
    tk1 = skew_tile(n, n, 4, th, mb, n + 1, batch=b, sms=sms)
    k5_fwd["k1_same_shape_ms"] = k1_ms
    k5_fwd["k1_same_shape"] = (f"K1 forward, {tk1.m_block} directions per "
                               f"block, stages of {tk1.stage_rows} rows x "
                               f"{tk1.slots}")
    log(f"timing K1 forward at N={n} B={b}: {k1_ms:.4f} ms "
        f"({k5_fwd['k1_same_shape']})")
    # K5 forward at radon_251 (N = 251, B = 256, stream_rows 251) beside
    # K1 there: data for the K1 redesign, not a route
    cfg = config()
    n1, b1 = cfg.n, cfg.batch
    h1, mb1 = pallas_block_spec(n1)
    f1 = torch.from_numpy(radon_images(n1, b1, kind="phantom")).to(dev)
    k5_251 = cuda_ms(lambda: ST.stream_raw(f1, sign=1, mode="forward",
                                           stream_rows=n1, m_block=mb1))
    k1_251 = cuda_ms(lambda: S.sfdprt(f1, sign=1, mode="forward",
                                      strip_rows=h1, m_block=mb1))
    t1 = stream_tile(n1, n1, 4, n1, mb1, n1 + 1, "dma", batch=b1, sms=sms)
    k5_fwd["radon_251_ms"] = k5_251
    k5_fwd["radon_251_k1_ms"] = k1_251
    k5_fwd["radon_251_design"] = design(t1, "dma", b1, "int32")
    log(f"timing at radon_251 (N={n1} B={b1} int32) forward: K5 "
        f"{k5_251:.4f} ms (stream_rows {n1}; {t1.m_block} directions per "
        f"block, stages of {t1.stage_rows} rows x {t1.slots}), K1 "
        f"{k1_251:.4f} ms")
    # K5 forward on int64 accumulators (the uint8 image), B = 1; an int64
    # add is counted as two int32 operations (add with carry)
    u = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (1, n, n))).to(dev)
    t = stream_tile(n, n, 8, sr, mb, n + 1, "dma", batch=1, sms=sms)
    k_ms = cuda_ms(lambda: ST.stream_raw(u, sign=1, mode="forward",
                                         stream_rows=sr, m_block=mb),
                   reps=GIANT_TIMING_REPS, warm=1)
    clock = sm_clock_mhz()[0]
    p_ms = cuda_ms(lambda: ST.stream_plain(u, sign=1, mode="forward",
                                           stream_rows=sr), reps=1, warm=0)
    b_ms, by = stream_bound(8 * (n * n + (n + 1) * n), 2 * (n ** 3 + n * n))
    rows.append({
        "name": "stream_kernel[dma,forward,int64]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": replaces["dma"],
        "launches": launches.get(("dma", "forward"), 0),
        "max_abs_err": worst.get("dma,forward", 0.0),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_note": "an int64 add counted as two int32 operations",
        "library_ms": None,
        "shape": f"N={n} B=1 int64 stream_rows={sr}",
        "design": design(t, "dma", 1, "int64"),
        **rates(k_ms, n ** 3, t, 1, 8 * n * n, clock),
    })
    log(f"timing stream dma forward int64 N={n} B=1: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
        f"{rows[-1]['design']}; {rows[-1]['adds_per_clock_per_sm']:.2f} "
        f"adds/clock/SM, rereads {rows[-1]['reread_tb_s']:.2f} TB/s)")
    # K5 forward of uint8 images at B = 4 on their route since int32 sums
    # are exact there (core/dprt.py:forward_sum_dtype_for): an int32
    # operand, int32 sums, int64 outputs stored by the kernel
    u4 = torch.from_numpy(np.random.default_rng(14).integers(
        0, 256, (b, n, n), dtype=np.uint8)).to(dev).to(torch.int32)
    t = stream_tile(n, n, 4, sr, mb, n + 1, "dma", batch=b, sms=sms)
    k_ms = cuda_ms(lambda: ST.stream_raw(u4, sign=1, mode="forward",
                                         stream_rows=sr, m_block=mb,
                                         out_dtype=torch.int64),
                   reps=GIANT_TIMING_REPS, warm=1)
    clock = sm_clock_mhz()[0]
    p_ms = b * cuda_ms(lambda: ST.stream_plain(
        u4[:1], sign=1, mode="forward", stream_rows=sr,
        out_dtype=torch.int64), reps=1, warm=0)
    b_ms, by = stream_bound(b * (4 * n * n + 8 * (n + 1) * n), b * (n ** 3 + n * n))
    rows.append({
        "name": "stream_kernel[dma,forward,int32>int64]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": replaces["dma"],
        "launches": launches.get("int32>int64", 0),
        "max_abs_err": worst.get("dma,forward", 0.0),
        "ms": k_ms,
        "plain_ms": p_ms,
        "plain_ms_note": "B=1 run x B",
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
        "shape": f"N={n} B={b} uint8 images, int32 sums, int64 out, "
                 f"stream_rows={sr}",
        "design": design(t, "dma", b, "int32>int64"),
        **rates(k_ms, b * n ** 3, t, b, 4 * n * n, clock),
    })
    log(f"timing stream dma forward uint8 N={n} B={b} (int32 sums, int64 "
        f"out): kernel {k_ms:.4f} ms, plain (B=1 x {b}) {p_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({by}; {rows[-1]['design']}; "
        f"{rows[-1]['adds_per_clock_per_sm']:.2f} adds/clock/SM, rereads "
        f"{rows[-1]['reread_tb_s']:.2f} TB/s)")
    return rows


#: what ptxas reported for the forward's ``stream_kernel<int, 1, long>``
#: (registers, spill store bytes, spill load bytes) before the narrow
#: inverse (nvcc for sm_90a on an H100 host)
K5_FORWARD_PTXAS_BEFORE = {"regs": 128, "spill_stores": 0, "spill_loads": 0}


def narrow_inverse_phase(launches: dict) -> list:
    """The gated inverse at the benchmark's shape (N = 4099, B = 4,
    stream_rows 256): on the int64 projections of uint8 images, the
    whole call beside today's int64 kernel, and its parts -- the pass
    over the operand, the narrow launch, the int64 launch whose blocks
    all exit; on a batch of wide int64 values, which no gate passes, the
    whole call beside the int64 kernel (the pass and the narrow launch
    whose blocks all exit are then overhead); exact against the int64
    kernel, 4 and 0 narrow images a call; ptxas's registers of the
    forward's instantiation (failing if they changed) and of the narrow
    variant."""
    import numpy as np
    import torch
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.kernels.tuning import pallas_block_spec, stream_tile

    n, b, sr = GIANT_N, GIANT_BATCH, GIANT_STREAM_ROWS
    _, mb = pallas_block_spec(n)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptx = ptxas_report("stream")
    fwd = ptx.get(("stream_kernel", "int32>int64", "dma"))
    gate = ptx.get(("stream_kernel", "int32>int64 gated", "dma"))
    log(f"ptxas stream_kernel<int, 1, long> (the forward): before "
        f"{K5_FORWARD_PTXAS_BEFORE}, now {fwd}; the narrow inverse "
        f"stream_kernel<int, 1, long, true>: {gate}")
    if fwd != K5_FORWARD_PTXAS_BEFORE:
        fail(f"the forward's instantiation changed: {fwd}, before "
             f"{K5_FORWARD_PTXAS_BEFORE}")
    u8 = torch.from_numpy(np.random.default_rng(15).integers(
        0, 256, (b, n, n), dtype=np.uint8)).to(dev)
    r = S.dprt_raw(u8, m_block=mb, stream_rows=sr)
    wide = torch.from_numpy(np.random.default_rng(16).integers(
        -2 ** 40, 2 ** 40, (b, n + 1, n), dtype=np.int64)).to(dev)
    kw = dict(sign=-1, mode="inverse", stream_rows=sr, m_block=mb)
    parts = {}
    for name, x, narrow_images in (("uint8", r, b), ("wide", wide, 0)):
        g = x[:, :n]
        corr = (x[:, n] - x[:, 0].sum(1, keepdim=True)).contiguous()
        ST.reset_launch_counts()
        got = S.idprt_raw(x, m_block=mb, stream_rows=sr)
        want = ST.stream_raw(g, corr=corr, **kw)
        torch.cuda.synchronize()
        images = ST.narrow_inverse_images(dev)
        if (not torch.equal(got, want) or images != narrow_images
                or (name == "uint8" and not torch.equal(got, u8.long()))):
            fail(f"the gated inverse of {name} int64 values at N={n} B={b} "
                 f"is not the int64 kernel's bits ({images} narrow images, "
                 f"not {narrow_images})")
        parts[name] = (g, corr)
    g, corr = parts["uint8"]
    bounds = torch.stack([g.amin((1, 2)), g.amax((1, 2))]).contiguous()
    low = g.to(torch.int32)
    kw["corr"] = corr

    def prep():
        bd = torch.empty((2, b), dtype=torch.int64, device=dev)
        torch.aminmax(g.flatten(1), dim=1, out=(bd[0], bd[1]))
        return g.to(torch.int32)

    wg, wcorr = parts["wide"]
    timed = {
        "gated_call": lambda: S.idprt_raw(r, m_block=mb, stream_rows=sr),
        "int64_kernel": lambda: ST.stream_raw(g, **kw),
        "prep": prep,
        "narrow_launch": lambda: ST.stream_raw(
            low, bounds=bounds, out_dtype=torch.int64, **kw),
        "int64_exit_only": lambda: ST.stream_raw(g, bounds=bounds, **kw),
        "wide_gated_call": lambda: S.idprt_raw(wide, m_block=mb,
                                               stream_rows=sr),
        "wide_int64_kernel": lambda: ST.stream_raw(wg, **dict(kw,
                                                               corr=wcorr)),
    }
    ms = {k: cuda_ms(fn, reps=GIANT_TIMING_REPS, warm=1)
          for k, fn in timed.items()}
    clock = sm_clock_mhz()[0]
    # the plain pair (narrow half, then int64 half) on one image, x B
    b1 = bounds[:, :1].contiguous()
    kw1 = dict(sign=-1, mode="inverse", stream_rows=sr, corr=corr[:1],
               bounds=b1)
    p_ms = b * cuda_ms(lambda: ST.stream_plain(
        g[:1], out=ST.stream_plain(low[:1], out_dtype=torch.int64, **kw1),
        **kw1), reps=1, warm=0)
    log(f"timing gated inverse N={n} B={b}: uint8 projections (int64) "
        f"{ms['gated_call']:.4f} ms against the int64 kernel's "
        f"{ms['int64_kernel']:.4f} ms; wide int64 values "
        f"{ms['wide_gated_call']:.4f} ms against "
        f"{ms['wide_int64_kernel']:.4f} ms (the gate's overhead "
        f"{ms['wide_gated_call'] - ms['wide_int64_kernel']:.4f} ms); all "
        f"parts {ms}; plain pair (B=1 x {b}) {p_ms:.4f} ms; {clock:.0f} "
        f"MHz")
    if ms["int64_exit_only"] > 0.5:
        fail(f"the int64 launch whose blocks all exit took "
             f"{ms['int64_exit_only']:.4f} ms")
    t = stream_tile(n, n, 4, sr, mb, n, "dma", batch=b, sms=sms)
    # the pass reads the int64 operand and writes its low 32 bits; the
    # narrow launch reads those and corr and stores int64; int32 adds
    nbytes = b * (8 * n * n + 4 * n * n + 4 * n * n + 8 * n + 8 * n * n)
    b_ms, by = stream_bound(nbytes, b * (n ** 3 + 2 * n * n))
    return [{
        "name": "stream_kernel[dma,inverse,int64 gated to int32]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": "src/repro/kernels/sfdprt.py:457",
        "launches": launches.get("gated inverse", 0),
        "launches_note": "gated calls on the giant-N main path",
        "max_abs_err": 0.0,
        "ms": ms["gated_call"],
        "parts_ms": ms,
        "plain_ms": p_ms,
        "plain_ms_note": "B=1 run of the plain pair x B",
        "bound_ms": b_ms,
        "bound_by": by,
        "library_ms": None,
        "shape": f"N={n} B={b} uint8 projections (int64), stream_rows={sr}",
        "design": {"directions_per_block": t.m_block, "cols_per_lane": t.cols,
                   "consumer_warps": t.warps, "stage_rows": t.stage_rows,
                   "ring_slots": t.slots, "blocks": b * t.blocks,
                   "ptxas": gate, "ptxas_forward": fwd},
        "sm_clock_mhz": clock,
    }]


# ---------------------------------------------------------------------------
# slice 4: the mesh path (K3, the pipeline's mesh tail)
# ---------------------------------------------------------------------------
#: shards of the four-shards phase and of K3's per-shard timing
MESH_SHARDS = 4
TAIL_CHECK_NS = (13, 251)


def tail_rc_scale(rows, w, op: str, off: int, n: int) -> float:
    """The largest per-direction output K3's inverse sums (K2's float
    tolerance is relative to it): the op applied to the shard's rows of
    global direction <= N, at least 1."""
    import torch
    from repro_torch.core.conv import circ_conv1d_exact
    grow = off + torch.arange(rows.shape[1], device=rows.device)
    keep = grow <= n
    rf = rows[:, keep]
    if op == "none" or not bool(keep.any()):
        rc = rf
    else:
        win = w[:, grow[keep]]
        rc = circ_conv1d_exact(rf, win) if op == "conv" else rf * win
    return max(float(rc.double().abs().max()) if rc.numel() else 0.0, 1.0)


def tail_kernel_phase() -> dict:
    """K3 against its plain version: N in {13, 251}, ops none/mul/conv
    with shared and batched operands, int32/int64 bit-exact and float32
    within K2's tolerance, the shards of 1, 2, 4 and 5 ranks at row_offset
    0, a middle shard and the shard that holds direction N and the
    padding past it, batch 1 and 3, the table's and an awkward m_block,
    and int32 values whose sums and products overflow.  Five shards put
    padding rows past direction N into the last shard at N = 251 too.
    The register tile's edges (:func:`tail_edge_shards` at N = 31, 61
    and 257 -- two conv runs of 32R there -- for the four dtypes, float64
    too): a shard of padding only, one that straddles N, a row_offset
    that is no multiple of D, and D = 1; at radon_251 tiles of the most
    directions that fit (blocks of unequal D).  Spills are checked with
    K2's."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.tuning import pipeline_block_spec

    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    worst = {}
    cases = 0

    def run(label, rows, w, op, off, mb, tile=None):
        nonlocal cases
        n = rows.shape[-1]
        if tile is None:
            got, got_aux = P.pipeline_tail_raw(rows, w, op=op,
                                               row_offset=off, m_block=mb)
        else:
            got, got_aux = P.pipeline_tail_launch_tile(rows, w, tile, op=op,
                                                       row_offset=off)
        torch.cuda.synchronize()
        want, want_aux = P.pipeline_tail_plain(rows, w, op=op,
                                               row_offset=off)
        torch.cuda.synchronize()
        tol = aux_tol = None
        if rows.dtype.is_floating_point:
            # K2's tolerance holds for the pipeline's output, which is
            # (Z - S + c) / N; K3 returns Z itself, so N times it
            rel = (PIPE_F64_REL if rows.dtype == torch.float64
                   else PIPE_F32_REL)
            aux_tol = rel * tail_rc_scale(rows, w, op, off, n)
            tol = n * aux_tol
        err = max(check_close(f"K3 {label} out", got, want, n, tol),
                  check_close(f"K3 {label} aux", got_aux, want_aux, n,
                              aux_tol))
        worst[op] = max(worst.get(op, 0.0), err)
        cases += 1

    def maker(dt):
        def make(shape, lo=-200, hi=256):
            if dt.is_floating_point:
                a = rng.random(shape)
            else:
                a = rng.integers(lo, hi, shape)
            return torch.as_tensor(a).to(dt).to(dev)
        return make

    def op_runs(make, b, n):
        return [("none", None, "none"),
                ("mul shared", make((1, n + 1, n), -9, 10), "mul"),
                ("mul batched", make((b, n + 1, n), -9, 10), "mul"),
                ("conv shared", make((1, n + 1, n), -9, 10), "conv"),
                ("conv batched", make((b, n + 1, n), -9, 10), "conv")]

    for n in TAIL_CHECK_NS:
        table_mb = pipeline_block_spec(n)[0]
        for devs in (1, 2, MESH_SHARDS, 5):
            dirs_loc = -(-(n + 1) // devs)
            offsets = sorted({0, (devs // 2) * dirs_loc,
                              (devs - 1) * dirs_loc})
            for mb in sorted({min(table_mb, dirs_loc), 5}):
                for b in (1, 3):
                    for dt in (torch.int32, torch.int64, torch.float32):
                        make = maker(dt)
                        rows = make((b, dirs_loc, n))
                        for label, w, op in op_runs(make, b, n):
                            for off in offsets:
                                run(f"{label} N={n} shards={devs} "
                                    f"off={off} M={mb} B={b} {dt}", rows, w,
                                    op, off, mb)
    # the register tile's edges
    for n in PIPE_EDGE_NS:
        for label_s, off, k, mb in tail_edge_shards(n):
            for b in (1, 3):
                for dt in (torch.int32, torch.int64, torch.float32,
                           torch.float64):
                    make = maker(dt)
                    rows = make((b, k, n))
                    for label, w, op in op_runs(make, b, n):
                        run(f"edge {label_s} {label} N={n} off={off} "
                            f"rows={k} M={mb} B={b} {dt}", rows, w, op, off,
                            mb)
    n = 251
    for op in ("none", "mul", "conv"):
        tile = tail_fit_tile(n, 4, op, n + 1)
        make = maker(torch.int32)
        rows = make((2, n + 1, n))
        w = None if op == "none" else make((2, n + 1, n), -9, 10)
        run(f"edge most directions that fit ({tile.m_block}, {tile.blocks} "
            f"blocks) {op} N={n}", rows, w, op, 0, tile.m_block, tile=tile)
    big = 2 ** 28
    for n in TAIL_CHECK_NS:
        dirs_loc = -(-(n + 1) // MESH_SHARDS)
        rows = torch.as_tensor(rng.integers(-big, big, (3, dirs_loc, n)),
                               dtype=torch.int32).to(dev)
        w = torch.as_tensor(rng.integers(-big, big, (3, n + 1, n)),
                            dtype=torch.int32).to(dev)
        for op, opd in (("none", None), ("mul", w), ("conv", w)):
            for off in (0, (MESH_SHARDS - 1) * dirs_loc):
                run(f"overflow {op} N={n} off={off}", rows, opd, op, off,
                    pipeline_block_spec(n)[0])
    log(f"tail kernel phase: {cases} cases agree with the plain version "
        f"(max |err| by op: {worst})")
    return worst


def tail_edge_shards(n: int) -> list:
    """K3's tile edges at N: (label, row_offset, rows, m_block) -- a shard
    of padding only, one that straddles N (direction N and padding past
    it, in blocks of 2, the last of padding only), a row_offset that is
    no multiple of D (blocks of 5 from direction 7), and D = 1."""
    return [("padding only", n + 1, 4, 2), ("straddles N", n - 2, 7, 2),
            ("offset not a multiple of D", 7, 17, 5), ("D = 1", 3, 4, 1)]


def tail_fit_tile(n: int, itemsize: int, op: str, rows: int):
    """K3's tile of the most directions per block that fit its shared
    memory (``tuning.tail_tile`` then spreads them evenly; this keeps
    them, so the last block is short)."""
    from repro_torch.kernels.tuning import STREAM_SMEM_BUDGET, \
        pipeline_geometry
    d = min(rows, n + 1)
    while pipeline_geometry(n, itemsize, op, d, source="proj",
                            rows=rows).smem > STREAM_SMEM_BUDGET:
        d -= 1
    return pipeline_geometry(n, itemsize, op, d, source="proj", rows=rows)


def circ_conv_np(f, k):
    """Numpy oracle of the circular convolution of each image of ``f``
    (B, N, N) with a small kernel ``k``: sum_{a,b} k[a,b] f[x-a, y-b]."""
    import numpy as np
    out = np.zeros(f.shape, dtype=np.int64)
    for a in range(k.shape[0]):
        for b in range(k.shape[1]):
            out += int(k[a, b]) * np.roll(f, (a, b), axis=(-2, -1))
    return out


def mesh_main_path_phase() -> dict:
    """The radon_251 mesh path on the card at world size 1 over NCCL, on
    a (1, 1) ("data", "model") mesh: serve --mesh-shape 1,1, Conv2D 3 x 3
    under radon.config(mesh=...), the fused filter and round trip, and a
    float32 gradient on a mesh operator; returns the launches of that
    run (K1 by mode, K2 and K3 by op)."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_world, make_local_mesh

    cfg = config()
    n, b = cfg.n, cfg.batch
    dev = torch.device("cuda")
    init_world("cuda")
    mesh = make_local_mesh(1, 1)
    if mesh.device_type != "cuda" or tuple(mesh.mesh.shape) != (1, 1):
        fail(f"expected a (1, 1) cuda mesh, got {mesh}")
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    kern = torch.ones((3, 3), dtype=torch.int32, device=dev)
    w = torch.from_numpy(rng.integers(-7, 8, (n + 1, n))
                         .astype(np.int32)).to(dev)
    xf = torch.from_numpy(rng.random((b, n, n), dtype=np.float32)).to(dev)
    wf = torch.from_numpy(rng.random((b, n + 1, n),
                                     dtype=np.float32)).to(dev)
    with radon.config(mesh=mesh):
        conv = radon.Conv2D(tuple(imgs.shape), kern)
        op = radon.DPRT(tuple(imgs.shape), torch.int32)
        opf = radon.DPRT(tuple(imgs.shape), torch.float32)
    filt = op.inverse @ radon.ProjectionFilter(w) @ op
    if not (conv.plan.method == op.plan.method == opf.plan.method
            == "sharded_cuda") or not conv.describe()["pipeline"]:
        fail(f"the mesh resolved to {conv.plan.method!r}/"
             f"{op.plan.method!r}, not sharded_cuda with the pipeline")
    if len(filt.ops) != 1 or not isinstance(
            filt.ops[0], radon.FusedProjectionPipeline):
        fail(f"inverse @ filter @ forward on the mesh was not fused: "
             f"{filt!r}")
    conv(imgs)                  # warm: plans, appliers and kernels built
    torch.cuda.synchronize()

    kernel_builds = radon.trace_count(kind="kernel")
    S.reset_launch_counts()
    P.reset_launch_counts()
    t0 = time.perf_counter()
    # -- the serve CLI on a (1, 1) mesh -----------------------------------
    served = serve.main(["--mode", "radon", "--batch", str(b), "--n",
                         str(n), "--iters", str(SERVE_ITERS), "--device",
                         "cuda", "--mesh-shape", "1,1"])
    # -- Conv2D on the mesh: the timed loop must build nothing -------------
    walls = []
    with radon.retrace_guard(max_traces=0):
        for _ in range(CONV_ITERS):
            t1 = time.perf_counter()
            out = conv(imgs)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t1))
    # -- the fused filter, the round trip, a float32 gradient ---------------
    filtered = filt(imgs)
    round_trip = conv.plan.pipeline(imgs, "none")
    x = xf.clone().requires_grad_(True)
    (wf * opf(x)).sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": dict(S.MODE_LAUNCHES), "k2": dict(P.OP_LAUNCHES),
                "k3": dict(P.TAIL_OP_LAUNCHES)}

    # serve: 1 warm + SERVE_ITERS each way, the mesh inverse is K1's core
    # skew-sum plus the epilogue in torch; Conv2D: K1 forward of the kernel
    # and of the image strip, then K3; filter: K1 forward + K3 (mul); round
    # trip: K1 forward + K3 (none); gradient: forward, then core (adjoint)
    want = {"k1": {"core": 1 + SERVE_ITERS + 1, "inverse": 0,
                   "forward": 1 + SERVE_ITERS + 2 * CONV_ITERS + 3},
            "k2": {"none": 0, "mul": 0, "conv": 0},
            "k3": {"none": 1, "mul": 1, "conv": CONV_ITERS}}
    if launches != want:
        fail(f"mesh path launches {launches}, expected {want}")
    if radon.trace_count(kind="kernel") != kernel_builds:
        fail("the mesh path rebuilt a kernel")
    log(f"mesh path: launches {launches} (expected; K2 none); Conv2D host "
        f"ms {[round(t, 3) for t in walls]}; {wall:.2f} s host wall")

    # -- checks (their own launches are not counted) -----------------------
    plain_op = radon.DPRT(tuple(imgs.shape), torch.int32)
    plain_conv = radon.Conv2D(tuple(imgs.shape), kern)
    if plain_conv.plan.mesh is not None or plain_op.plan.method != "cuda":
        fail("the unsharded reference operators resolved onto the mesh")
    rf = plain_op(imgs)
    if not torch.equal(served, rf):
        fail("serve --mesh-shape 1,1 projections differ from the unsharded "
             "K1 forward")
    if not torch.equal(out, plain_conv(imgs)):
        fail("the mesh Conv2D differs from the unsharded K2 Conv2D")
    if not torch.equal(filtered, plain_op.inverse(w * rf)):
        fail("the mesh fused filter differs from op.inverse(w * op(f))")
    if not torch.equal(round_trip, imgs):
        fail("the mesh round trip pipeline is not f")
    # int32 wrap on the mesh datapaths: values in +-2^28 overflow the sums
    from repro_torch.core import distributed as D
    big = torch.from_numpy(rng.integers(-2 ** 28, 2 ** 28, (8, n, n))
                           .astype(np.int32)).to(dev)
    for red in D.REDUCES:
        rb = D.dprt_sharded_pallas(big, mesh, reduce=red)
        if not torch.equal(rb.full_tensor(), S.dprt_raw(big)):
            fail(f"mesh forward ({red}) of int32 +-2^28 differs from K1")
        if not torch.equal(D.idprt_sharded_pallas(rb, mesh, reduce=red)
                           .full_tensor(), S.idprt_raw(S.dprt_raw(big))):
            fail(f"mesh inverse ({red}) of int32 +-2^28 differs from K1")
    bw = torch.from_numpy(rng.integers(-2 ** 28, 2 ** 28, (8, n + 1, n))
                          .astype(np.int32)).to(dev)
    for op_, opd in (("none", None), ("mul", bw), ("conv", bw)):
        got = D.projection_pipeline_sharded(big, mesh, op=op_, operand=opd)
        want_p = P.pipeline_raw(big, opd, op=op_)[0]
        if not torch.equal(got.full_tensor(), want_p):
            fail(f"mesh pipeline {op_} of int32 +-2^28 differs from K2")
    with torch.no_grad():
        grad_t = opf.T(wf)
    err = check_close("mesh grad vs op.T", x.grad, grad_t, n)
    check_close("mesh op.T vs unsharded op.T", grad_t,
                radon.DPRT(tuple(imgs.shape), torch.float32).T(wf), n)
    log(f"mesh path: N={n} B={b} on {conv.describe()['mesh']} over "
        f"{torch.distributed.get_backend()}: serve round trip exact with "
        f"zero builds in its timed loop, "
        f"Conv2D == unsharded K2 Conv2D, fused filter and round trip "
        f"exact, int32 +-2^28 forward/inverse (every reduce) and pipeline "
        f"ops wrap as K1/K2 do, float32 grad == op.T (max |err| "
        f"{err:.3g})")
    mesh_solve_check(mesh)
    return launches


def four_shards_phase() -> None:
    """Each rank's step of projection_pipeline_sharded for D = 4, in turn
    on the card, with the collectives done as explicit sums and slices:
    K1 on row strips at row_offset r*63, sum and split into four
    direction shards, K3 on each at row_offset r*63, sum and the floor
    divide correction.  The only run of K1 and K3 at row_offset != 0 in
    the mesh's own data flow; it must equal K2's Conv2D and the numpy
    oracle."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.core.dprt import dprt_oracle_np
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import ops

    cfg = config()
    n, b, devs = cfg.n, cfg.batch, MESH_SHARDS
    dev = torch.device("cuda")
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    kern = torch.ones((3, 3), dtype=torch.int32, device=dev)
    kpad = torch.zeros((n, n), dtype=torch.int32, device=dev)
    kpad[:3, :3] = kern
    rg = radon.DPRT((n, n), torch.int32)(kpad)
    rows = -(-n // devs)
    dirs_loc = -(-(n + 1) // devs)
    # 1. K1 on each rank's row strip at its global row offset
    parts = [ops.dprt_cuda_strip(imgs[:, r * rows:(r + 1) * rows],
                                 row_offset=r * rows) for r in range(devs)]
    # 2. the reduce_scatter: sum, pad the directions, split into shards
    proj = torch.zeros((b, dirs_loc * devs, n), dtype=torch.int32,
                       device=dev)
    proj[:, :n + 1] = sum(parts)
    # 3. K3 on each rank's direction shard at its global offset
    tails = [ops.pipeline_tail_cuda(
        proj[:, r * dirs_loc:(r + 1) * dirs_loc], "conv", rg,
        row_offset=r * dirs_loc, n=n) for r in range(devs)]
    # 4. the sums of z and aux, then the deferred correction
    z = sum(t[0] for t in tails)
    aux = sum(t[1] for t in tails)
    s = aux[:, 0].sum(-1, dtype=torch.int32)[:, None, None]
    out = torch.div(z - s + aux[:, 1, :, None], n, rounding_mode="floor")
    torch.cuda.synchronize()

    fwd = radon.DPRT(tuple(imgs.shape), torch.int32)(imgs)
    if not torch.equal(proj[:, :n + 1], fwd):
        fail("the four K1 strip partials do not sum to the forward")
    if not np.array_equal(proj[0, :n + 1].cpu().numpy(),
                          dprt_oracle_np(imgs[0].cpu().numpy())):
        fail("the summed strip partials of image 0 differ from the numpy "
             "oracle")
    if not torch.equal(out, radon.Conv2D(tuple(imgs.shape), kern)(imgs)):
        fail("the four-shard pipeline differs from K2's Conv2D")
    want = circ_conv_np(imgs.cpu().numpy(), kern.cpu().numpy())
    if not np.array_equal(out.cpu().numpy(), want):
        fail("the four-shard pipeline differs from the numpy oracle")
    log(f"four shards: N={n} B={b}, K1 on {devs} row strips of {rows} "
        f"(row_offset r*{rows}) and K3 on {devs} direction shards of "
        f"{dirs_loc} (row_offset r*{dirs_loc}) == K2 Conv2D == numpy "
        f"oracle, bit for bit")


#: m_block values of K3's D sweep at world size 1 (252 directions):
#: blocks per image 32, 16, 12, 8, 6 and 4, and for mul / none 3 (D = 84,
#: past the table's 64; conv fits 73 directions at most, so 4 blocks)
TAIL_SWEEP_MBLOCKS = (8, 16, 21, 32, 42, 64, 84)


def tail_timing_phase(launches: dict, worst: dict) -> list:
    """K3 vs its plain version at radon_251, per op: at world size 1 (one
    shard of all N+1 directions, the mesh path's shape) and per shard at
    D = 4 (a middle shard of 63 directions), with its tile, ptxas's
    registers and the SASS of its inverse loop (instructions per add) and
    conv window (per multiply-add); and at world size 1 the kernel by
    directions per block: the m_block sweep plus the most directions
    that fit, ms against blocks per image fitted as a + c x blocks."""
    import numpy as np
    import torch
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import _build
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels.sfdprt import sfdprt_plain
    from repro_torch.kernels.tuning import pipeline_block_spec, tail_tile

    cfg = config()
    n, b = cfg.n, cfg.batch
    mb = pipeline_block_spec(n)[0]
    ptx = ptxas_report("pipeline")
    sass = sass_hot_blocks(_build._lib_path("pipeline"))
    dev = torch.device("cuda")
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    rows = sfdprt_plain(f, sign=1, mode="forward")          # (b, N+1, N)
    kern = torch.zeros((1, n, n), dtype=torch.int32, device=dev)
    kern[:, :3, :3] = 1
    rg = sfdprt_plain(kern, sign=1, mode="forward")
    w = torch.from_numpy(np.random.default_rng(8).integers(
        -7, 8, (1, n + 1, n)).astype(np.int32)).to(dev)
    dirs_loc = -(-(n + 1) // MESH_SHARDS)
    shapes = {"world1": (rows, 0),
              "shard": (rows[:, dirs_loc:2 * dirs_loc].contiguous(),
                        dirs_loc)}
    torch.cuda.synchronize()
    item = 4
    out = []
    for op, opd in (("conv", rg), ("mul", w), ("none", None)):
        row = {"name": f"pipeline_tail_kernel[{op}]", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/pipeline.cu",
               "replaces": "src/repro/kernels/sfdprt.py:853",
               "note": 'source="proj", defer=True: the mesh pipeline tail',
               "launches": launches["k3"][op],
               "max_abs_err": worst.get(op, 0.0), "library_ms": None,
               "library_note": "none: no PyTorch call computes the "
                               "skew-sum tail"}
        for key, (x, off) in shapes.items():
            k = x.shape[1]
            t = tail_tile(n, item, mb, op, k)
            live = max(0, min(k, n - off))           # directions < N
            epi = {"conv": b * k * n * n, "mul": b * k * n, "none": 0}[op]
            ops_n = epi + b * live * n * n
            nbytes = item * (b * k * n + b * n * n + 2 * b * n
                             + (0 if opd is None else k * n))
            k_ms = cuda_ms(lambda: P.pipeline_tail_raw(
                x, opd, op=op, row_offset=off, m_block=mb))
            p_ms = cuda_ms(lambda: P.pipeline_tail_plain(
                x, opd, op=op, row_offset=off), reps=3, warm=1)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * ops_n / INT32_ADDS_PER_S
            pkey = ("pipeline_tail_kernel", "int32", f"K={t.cols}")
            fields = {"ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "shape": f"N={n} B={b} int32 dirs_loc={k} "
                               f"row_offset={off} m_block {mb} -> D = "
                               f"{t.m_block}, {t.blocks} blocks per image",
                      "design": {"directions_per_block": t.m_block,
                                 "blocks_per_image": t.blocks,
                                 "consumer_warps": t.warps,
                                 "producer_warps": 0,
                                 "cols_per_lane": t.cols,
                                 "items_per_warp": t.items,
                                 "conv_run": t.conv_run,
                                 "conv_passes": t.conv_passes,
                                 "smem_bytes": t.smem,
                                 "atomics_per_call": b * t.blocks * n * n,
                                 "ptxas": ptx.get(pkey),
                                 "sass_hot_block": sass.get(pkey)}}
            if key == "world1":
                row.update(fields)
            else:
                row.update({f"shard_{k2}": v for k2, v in fields.items()})
            log(f"timing pipeline tail {op} ({key}): kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                f"({fields['bound_by']}; {ops_n:.4g} int32 ops; "
                f"{fields['shape']}; {fields['design']})")
        # the D sweep at world size 1
        by_d = {}
        tiles = [tail_tile(n, item, m, op, n + 1) for m in TAIL_SWEEP_MBLOCKS]
        tiles.append(tail_fit_tile(n, item, op, n + 1))
        for tm in tiles:
            if tm.m_block in by_d:
                continue
            d_ms = cuda_ms(lambda: P.pipeline_tail_launch_tile(
                rows, opd, tm, op=op, row_offset=0))
            by_d[tm.m_block] = {"blocks_per_image": tm.blocks,
                                "consumer_warps": tm.warps,
                                "smem_bytes": tm.smem, "ms": d_ms}
            log(f"timing pipeline tail {op} at D = {tm.m_block} "
                f"({tm.blocks} blocks per image, {tm.smem} shared bytes): "
                f"{d_ms:.4f} ms")
        xs = np.array([v["blocks_per_image"] for v in by_d.values()], float)
        ys = np.array([v["ms"] for v in by_d.values()])
        slope, icpt = np.polyfit(xs, ys, 1)
        t1 = tail_tile(n, item, mb, op, n + 1)
        row["by_directions_per_block"] = by_d
        row["per_block_fit"] = {
            "ms_per_block_per_image": slope, "ms_intercept": icpt,
            "per_block_share": slope * t1.blocks / row["ms"]}
        log(f"timing pipeline tail {op}: ms ~ {icpt:.4f} + {slope:.4f} x "
            f"blocks per image; the per-block cost is "
            f"{100 * slope * t1.blocks / row['ms']:.1f}% of the kernel at "
            f"{t1.blocks} blocks per image")
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# slice 8: reconstruction (radon.solve through float32 K1 and K2)
# ---------------------------------------------------------------------------
#: directions a detector loses (examples/reconstruction.py --drop 4),
#: drawn from numpy.random.default_rng(0)
SOLVE_DROP = 4
SOLVE_TOL = 1e-6
SOLVE_MAXITER = 100
#: iterations of the fixed-count runs (tol = 0, as the reference's
#: benchmarks/bench_recon.py times them)
SOLVE_FIXED = 10
#: ||M x - b|| / ||b|| per image of a masked solve of consistent data
#: (b = M f): float32 rounding leaves ~1e-6; zero-filling the lost
#: directions leaves ~1e-1
SOLVE_RESIDUAL_BOUND = 1e-4
#: images that the plain-backend solve (method="gather") repeats, and the
#: agreement asked of them, relative to the plain image's peak
SOLVE_PLAIN_B = 4
SOLVE_IMAGE_REL = 1e-3
#: |<L b, c> - <b, L^T c>| / |<L b, c>| of the gradient (L = the solve)
SOLVE_ADJOINT_REL = 1e-4
#: the reference bench's oracle gate (benchmarks/bench_recon.py:37-55)
ORACLE_N, ORACLE_MISSING = 13, (2, 7)
SOLVE_TIMING_REPS = 5


def counted(fn):
    """``fn()`` with every launch count and the solver's iteration counts
    set to 0 just before it, under ``retrace_guard(max_traces=0)`` (a warm
    run builds nothing), and read just after: ``(result, counts)``."""
    import importlib
    import torch
    from repro_torch import radon
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    solve_mod = importlib.import_module("repro_torch.radon.solve")
    S.reset_launch_counts()
    P.reset_launch_counts()
    solve_mod.reset_iteration_counts()
    with radon.retrace_guard(max_traces=0):
        out = fn()
        torch.cuda.synchronize()
    return out, {"k1": dict(S.MODE_LAUNCHES), "k2": dict(P.OP_LAUNCHES),
                 "k3": dict(P.TAIL_OP_LAUNCHES),
                 "iters": dict(solve_mod.ITERATIONS)}


def expect_launches(label: str, got: dict, *, forward=0, inverse=0,
                    core=0, mul=0, tail_mul=0) -> None:
    want = {"k1": {"core": core, "forward": forward, "inverse": inverse},
            "k2": {"none": 0, "mul": mul, "conv": 0},
            "k3": {"none": 0, "mul": tail_mul, "conv": 0}}
    have = {k: got[k] for k in want}
    if have != want:
        fail(f"{label}: launches {have}, expected {want}")


def solve_residual(m, x, b) -> float:
    """The largest per-image ||M x - b|| / ||b||."""
    import torch
    with torch.no_grad():
        res = m(x) - b
    num = res.double().flatten(-2).norm(dim=-1)
    den = b.double().flatten(-2).norm(dim=-1).clamp_min(1e-300)
    return float((num / den).max())


def check_solve_image(label: str, got, want) -> float:
    """A solve's image against another's, relative to the latter's peak."""
    import torch
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite image")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got.double() - want.double()).abs().max()) / scale
    if err > SOLVE_IMAGE_REL:
        fail(f"{label}: max |err| / peak {err} > {SOLVE_IMAGE_REL}")
    return err


def solve_problem(mesh=None) -> dict:
    """The radon_251 reconstruction problem on the card (on ``mesh`` when
    given): 256 phantoms, their int32 operator, the mask of SOLVE_DROP
    lost directions, the masked operator M and the measured b = M f."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images

    cfg = config()
    n, b = cfg.n, cfg.batch
    imgs = torch.from_numpy(radon_images(n, b, kind="phantom")).to("cuda")
    with (radon.config(mesh=mesh) if mesh is not None
          else contextlib.nullcontext()):
        op = radon.DPRT(tuple(imgs.shape), torch.int32)
    missing = np.random.default_rng(0).choice(n + 1, SOLVE_DROP,
                                              replace=False)
    mask = radon.direction_mask(n, missing)
    m = radon.MaskedDPRT(op, mask=mask)
    return {"n": n, "b": b, "imgs": imgs, "op": op, "mask": mask,
            "missing": sorted(int(v) for v in missing), "m": m,
            "bm": m(imgs)}


def plain_solve(mask, bm, **kw):
    """The same masked CG solve of the first SOLVE_PLAIN_B images through
    the plain torch backend (``gather``, the reference's oracle backend)
    on the card: no kernel of the port runs."""
    import torch
    from repro_torch import radon
    n = bm.shape[-1]
    op = radon.DPRT((SOLVE_PLAIN_B, n, n), torch.int32, method="gather")
    mp = radon.MaskedDPRT(op, mask=mask[:SOLVE_PLAIN_B] if mask.ndim == 3
                          else mask)
    return radon.solve(mp, bm[:SOLVE_PLAIN_B], "cg", **kw)


def solve_main_path_phase() -> dict:
    """The reconstruction path at radon_251 on the card, through
    ``radon.solve``: the unmasked Sherman-Morrison solve (one K1
    inverse), the masked CG solve (one K2 ``mul`` per iteration, equal to
    the plain-backend solve), the reference bench's N = 13 oracle gate,
    fixed-count runs of CG with both preconditioners, LSQR and Landweber,
    a float32 gradient's adjoint identity at B = 4 and per-image 3-D
    masks at B = 256.  Each run is ``counted``; returns the launches of
    all of them (every one float32) and the problem."""
    import numpy as np
    import torch
    from repro_torch import radon

    pb = solve_problem()
    n, b, imgs, op, mask, m, bm = (pb[k] for k in (
        "n", "b", "imgs", "op", "mask", "m", "bm"))
    r = op(imgs)
    if m.plan.method != "cuda" or m.fdtype != torch.float32:
        fail(f"the masked operator resolved to {m.plan.method!r} "
             f"{m.fdtype}, not the float32 cuda kernels")
    rng = np.random.default_rng(8)
    filt = radon.ProjectionFilter(torch.full((n + 1, n), 1.0 / (n + 1),
                                             device="cuda"))
    masks3 = torch.stack([radon.direction_mask(
        n, rng.choice(n + 1, SOLVE_DROP, replace=False)) for _ in range(b)])
    m3 = radon.MaskedDPRT(op, mask=masks3)
    b3 = m3(imgs)
    m4 = radon.MaskedDPRT(radon.DPRT((SOLVE_PLAIN_B, n, n), torch.int32),
                          mask=mask)
    b4 = m4(imgs[:SOLVE_PLAIN_B])
    c4 = m4.normal_rhs(torch.from_numpy(rng.standard_normal(
        (SOLVE_PLAIN_B, n + 1, n), dtype=np.float32)).to("cuda"))
    x13 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (ORACLE_N, ORACLE_N)).astype(np.int32)).to("cuda")
    op13 = radon.DPRT((ORACLE_N, ORACLE_N), torch.int32)
    m13 = radon.MaskedDPRT(op13, mask=radon.direction_mask(
        ORACLE_N, ORACLE_MISSING))
    b13 = m13(x13)
    fixed = {"cg+sherman": dict(method="cg", precond="sherman"),
             "cg+filter": dict(method="cg", precond=filt),
             "lsqr": dict(method="lsqr"),
             "landweber": dict(method="landweber")}
    main_kw = dict(tol=SOLVE_TOL, maxiter=SOLVE_MAXITER)
    # warm-up: the float32 plans, the solver bodies and their kernels
    radon.solve(op, r)
    radon.solve(m, bm, **main_kw)
    radon.solve(m3, b3, **main_kw)
    radon.solve(op13, op13(x13))
    radon.solve(m13, b13, "cg", tol=1e-7, maxiter=300)
    for kw in fixed.values():
        radon.solve(m, bm, tol=0.0, maxiter=SOLVE_FIXED, **kw)
    xw = b4.clone().requires_grad_(True)
    (radon.solve(m4, xw, **main_kw).image * c4).sum().backward()
    torch.cuda.synchronize()
    kernel_builds = radon.trace_count(kind="kernel")
    totals = {"k1": {}, "k2": {}}

    def run(fn):
        out, got = counted(fn)
        for k in totals:
            for key, v in got[k].items():
                totals[k][key] = totals[k].get(key, 0) + v
        return out, got

    # -- unmasked: the Sherman-Morrison closed form -------------------------
    res, got = run(lambda: radon.solve(op, r))
    expect_launches("sherman", got, inverse=1)
    if int(res.iterations) != 0 or not bool(res.converged):
        fail(f"sherman took {int(res.iterations)} iterations")
    if not torch.equal(res.image.round().to(torch.int32), imgs):
        fail("the unmasked solve does not round to the phantoms")
    sherman_err = float((res.image - imgs).abs().max())
    # -- masked CG: one K2 mul per iteration -------------------------------
    res, got = run(lambda: radon.solve(m, bm, **main_kw))
    k_main = int(res.iterations)
    expect_launches("masked CG", got, inverse=1, mul=k_main)
    if got["iters"]["cg"] != k_main or k_main < 1:
        fail(f"masked CG: {k_main} iterations, loop counted "
             f"{got['iters']}")
    resid = solve_residual(m, res.image, bm)
    if resid > SOLVE_RESIDUAL_BOUND:
        fail(f"masked CG: ||Mx - b|| / ||b|| {resid} > "
             f"{SOLVE_RESIDUAL_BOUND}")
    plain = plain_solve(mask, bm, **main_kw)
    plain_err = check_solve_image("masked CG vs the plain-backend solve",
                                  res.image[:SOLVE_PLAIN_B], plain.image)
    log(f"solve path: N={n} B={b} sherman exact to the phantoms (max "
        f"|err| {sherman_err:.3g}, 1 K1 inverse); masked CG without "
        f"directions {pb['missing']}: {k_main} iterations = {k_main} K2 mul "
        f"launches, 1 K1 inverse, converged {bool(res.converged)}, max "
        f"||Mx-b||/||b|| {resid:.3g} (bound {SOLVE_RESIDUAL_BOUND}), vs "
        f"the plain-backend solve of {SOLVE_PLAIN_B} images {plain_err:.3g}"
        f" of the peak (bound {SOLVE_IMAGE_REL}; it took "
        f"{int(plain.iterations)} iterations)")
    # -- the reference bench's oracle gate at N = 13, through the kernels --
    res13, got = run(lambda: radon.solve(m13, b13, "cg", tol=1e-7,
                                         maxiter=300))
    expect_launches("N=13 oracle CG", got, inverse=1,
                    mul=int(res13.iterations))
    a13 = m13.as_matrix().double().cpu().numpy()
    want = np.linalg.lstsq(a13, b13.double().cpu().numpy().ravel(),
                           rcond=None)[0]
    got13 = res13.image.double().cpu().numpy().ravel()
    if not np.allclose(got13, want, rtol=1e-4,
                       atol=1e-4 * max(1.0, np.abs(want).max())):
        fail(f"N=13 CG vs lstsq: max |err| {np.abs(got13 - want).max()}")
    full13 = radon.solve(op13, op13(x13))
    if int(full13.iterations) != 0 or not torch.allclose(
            full13.image, x13.float(), atol=1e-3):
        fail("N=13 sherman gate")
    log(f"solve path: N={ORACLE_N} missing {list(ORACLE_MISSING)} CG == "
        f"lstsq of m.as_matrix() (rtol 1e-4; max |err| "
        f"{np.abs(got13 - want).max():.3g}) in {int(res13.iterations)} K2 "
        f"mul launches; sherman gate exact")
    # -- fixed-count runs: launches per iteration of each method -----------
    per_iter = {"cg+sherman": dict(mul=1), "cg+filter": dict(mul=2),
                "lsqr": dict(forward=1, inverse=1),
                "landweber": dict(mul=1)}
    # once per solve: the rhs's inverse (LSQR: its first A^T), and the
    # filter's first preconditioning
    once = {"cg+filter": dict(inverse=1, mul=1)}
    fixed_iters = {}
    for label, kw in fixed.items():
        res, got = run(lambda: radon.solve(m, bm, tol=0.0,
                                           maxiter=SOLVE_FIXED, **kw))
        k = int(res.iterations)
        want_l = dict(once.get(label, {"inverse": 1}))
        for key, v in per_iter[label].items():
            want_l[key] = want_l.get(key, 0) + v * k
        expect_launches(f"fixed {label}", got, **want_l)
        if got["iters"][kw["method"]] != k or k < 1:
            fail(f"fixed {label}: {k} iterations, loop counted "
                 f"{got['iters']}")
        if not bool(torch.isfinite(res.image).all()):
            fail(f"fixed {label}: non-finite image")
        fixed_iters[label] = k
    log(f"solve path: fixed runs (tol 0, maxiter {SOLVE_FIXED}) iterations "
        f"{fixed_iters}; per iteration 1 K2 mul (CG+sherman, Landweber), 2 "
        f"(CG+filter), 1 K1 forward + 1 K1 inverse (LSQR)")
    # -- a float32 gradient through the masked CG solve (B = 4) ------------
    x = b4.clone().requires_grad_(True)
    res, got = run(lambda: radon.solve(m4, x, **main_kw))
    k_fwd = int(res.iterations)
    expect_launches("gradient's solve", got, inverse=1, mul=k_fwd)
    loss = (res.image * c4).sum()
    _, got = run(loss.backward)
    k_bwd = got["iters"]["cg"]
    expect_launches("gradient's backward", got, forward=1, mul=k_bwd)
    with torch.no_grad():
        lhs = float((res.image.double() * c4.double()).sum())
        rhs = float((b4.double() * x.grad.double()).sum())
    adj = abs(lhs - rhs) / max(abs(lhs), 1e-300)
    if k_bwd < 1 or adj > SOLVE_ADJOINT_REL:
        fail(f"gradient: <L b, c> {lhs} vs <b, L^T c> {rhs} (rel {adj} > "
             f"{SOLVE_ADJOINT_REL}), backward iterations {k_bwd}")
    log(f"solve path: float32 gradient at B={SOLVE_PLAIN_B}: <Lb, c> == "
        f"<b, L^T c> within {adj:.3g} (bound {SOLVE_ADJOINT_REL}); "
        f"solve {k_fwd} and backward {k_bwd} iterations, each one K2 mul")
    # -- per-image 3-D masks at B = 256 ------------------------------------
    if tuple(m3.d.shape) != (b, n + 1, n) or m3.d.dtype != torch.float32:
        fail(f"per-image diagonal {tuple(m3.d.shape)} {m3.d.dtype}")
    res, got = run(lambda: radon.solve(m3, b3, **main_kw))
    k3 = int(res.iterations)
    expect_launches("per-image masks", got, inverse=1, mul=k3)
    resid3 = solve_residual(m3, res.image, b3)
    if resid3 > SOLVE_RESIDUAL_BOUND:
        fail(f"per-image masks: ||Mx - b|| / ||b|| {resid3} > "
             f"{SOLVE_RESIDUAL_BOUND}")
    err3 = check_solve_image("per-image masks vs the plain-backend solve",
                             res.image[:SOLVE_PLAIN_B],
                             plain_solve(masks3, b3, **main_kw).image)
    if radon.trace_count(kind="kernel") != kernel_builds:
        fail("the solve path rebuilt a kernel")
    log(f"solve path: per-image masks ({b}, {n + 1}, {n}) float32 "
        f"({m3.d.numel() * 4 / 2 ** 20:.1f} MiB): {k3} iterations = {k3} "
        f"K2 mul launches, max ||Mx-b||/||b|| {resid3:.3g}, vs plain "
        f"{err3:.3g}; zero builds in every run; launches of the phase "
        f"{totals}")
    return {"launches": totals, "problem": pb}


def mesh_solve_check(mesh) -> None:
    """One masked CG solve on the (1, 1) mesh: each iteration K1 forward of
    the strip + K3 mul (the sharded pipeline), no K2; the image equals
    the unsharded solve's."""
    from repro_torch import radon

    pb = solve_problem(mesh)
    m, bm = pb["m"], pb["bm"]
    if m.plan.method != "sharded_cuda":
        fail(f"the mesh solve resolved to {m.plan.method!r}")
    kw = dict(tol=SOLVE_TOL, maxiter=SOLVE_MAXITER)
    radon.solve(m, bm, **kw)              # warm: its plans and body
    res, got = counted(lambda: radon.solve(m, bm, **kw))
    k = int(res.iterations)
    # the rhs's inverse on the mesh is K1's core skew-sum and the
    # epilogue in torch
    expect_launches("mesh CG", got, core=1, forward=k, tail_mul=k)
    flat = solve_problem()
    want = radon.solve(flat["m"], flat["bm"], **kw).image
    err = check_solve_image("mesh CG vs the unsharded K2 solve", res.image,
                            want)
    resid = solve_residual(m, res.image, bm)
    if resid > SOLVE_RESIDUAL_BOUND:
        fail(f"mesh CG: ||Mx - b|| / ||b|| {resid} > "
             f"{SOLVE_RESIDUAL_BOUND}")
    log(f"mesh path: masked CG {k} iterations = {k} K3 mul + {k} K1 forward "
        f"launches, 1 K1 core, no K2; vs the unsharded solve {err:.3g} of "
        f"the peak, max ||Mx-b||/||b|| {resid:.3g}")


def solve_sparse_matrix(n: int, kind: str):
    """The float32 DPRT (``forward``: (N+1)N x N^2) or its exact inverse
    (``inverse``: N^2 x (N+1)N) as a CSR matrix on the card: one sparse
    product with it computes K1's float32 function."""
    import torch
    ar = torch.arange(n, device="cuda")
    m, i, j = ar[:, None, None], ar[None, :, None], ar[None, None, :]
    if kind == "forward":
        # R(m, d) = sum_i f(i, <d + m i>); R(N, d) = sum_j f(d, j)
        rows = torch.cat([(m * n + j).expand(n, n, n).reshape(-1),
                          n * n + ar.repeat_interleave(n)])
        cols = torch.cat([(i * n + (j + m * i) % n).reshape(-1),
                          torch.arange(n * n, device="cuda")])
        vals = torch.ones(rows.numel(), device="cuda")
        shape = ((n + 1) * n, n * n)
    else:
        # f(i, j) = (sum_m R(m, <j - m i>) - S + R(N, i)) / N,
        # S = sum_d R(0, d)
        out = torch.arange(n * n, device="cuda")
        rows = torch.cat([(i * n + j).expand(n, n, n).reshape(-1), out,
                          out.repeat_interleave(n)])
        cols = torch.cat([(m * n + (j - m * i) % n).reshape(-1),
                          n * n + out // n, ar.repeat(n * n)])
        vals = torch.cat([torch.full((n ** 3 + n * n,), 1.0 / n,
                                     device="cuda"),
                          torch.full((n ** 3,), -1.0 / n, device="cuda")])
        shape = (n * n, (n + 1) * n)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def solve_timing_phase(solve_info: dict) -> list:
    """The reconstruction path's kernels in float32 at radon_251 (K2
    ``mul``, K1 ``inverse`` and ``forward``) against their plain versions,
    their bounds (float32 adds at 132 x 128 lanes x 1.98 GHz, or bytes
    over HBM, the larger) and, for K1, the sparse product that computes
    the same function; and one masked CG iteration at B = 256: ms per
    iteration by CUDA events and on the host clock (fixed-count solves of
    1 and SOLVE_FIXED iterations), beside the K2 ``mul`` kernel, and
    where its device time goes (torch.profiler over one fixed solve)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import radon
    from repro_torch.kernels import ops
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S

    pb = solve_info["problem"]
    n, b, m, bm = pb["n"], pb["b"], pb["m"], pb["bm"]
    launches = solve_info["launches"]
    x = torch.from_numpy(np.random.default_rng(9).random(
        (b, n, n), dtype=np.float32)).to("cuda")
    d2 = (m.d * m.d).contiguous()
    r = (d2 * bm).contiguous()                # a CG right-hand side's r
    corr = (r[:, n, :] - r[:, 0, :].sum(1, keepdim=True)).contiguous()
    torch.cuda.synchronize()
    item = 4
    fwd_ops = b * n * n * n + b * n * n
    inv_ops = b * n * n * n + 2 * b * n * n
    cases = {
        "pipeline_kernel[mul,float32]": dict(
            kernel=lambda: ops.projection_pipeline_cuda(x, "mul", d2),
            plain=lambda: P.pipeline_plain(x, d2[None], op="mul"),
            nbytes=item * (2 * b * n * n + 2 * b * n + (n + 1) * n),
            ops=fwd_ops + b * (n + 1) * n + inv_ops + b * n * n,
            launches=launches["k2"].get("mul", 0),
            source="src/repro_torch/kernels/csrc/pipeline.cu",
            replaces="src/repro/kernels/sfdprt.py:853", sparse=None),
        "sfdprt_kernel[inverse,float32]": dict(
            kernel=lambda: ops.idprt_cuda(r),
            plain=lambda: S.sfdprt_plain(r[:, :n], sign=-1, mode="inverse",
                                         corr=corr),
            nbytes=item * (b * (n + 1) * n + b * n * n), ops=inv_ops,
            launches=launches["k1"].get("inverse", 0),
            source="src/repro_torch/kernels/csrc/sfdprt.cu",
            replaces="src/repro/kernels/sfdprt.py:210", sparse="inverse"),
        "sfdprt_kernel[forward,float32]": dict(
            kernel=lambda: ops.dprt_cuda(x),
            plain=lambda: S.sfdprt_plain(x, sign=1, mode="forward"),
            nbytes=item * (b * n * n + b * (n + 1) * n), ops=fwd_ops,
            launches=launches["k1"].get("forward", 0),
            source="src/repro_torch/kernels/csrc/sfdprt.cu",
            replaces="src/repro/kernels/sfdprt.py:210", sparse="forward"),
    }
    rows = []
    for name, c in cases.items():
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        tol = None
        if isinstance(want, tuple):           # K2's plain gives (out, aux)
            want, aux = want
            tol = pipeline_tol(got, aux)
        err = check_close(f"{name} vs plain", got, want, n, tol)
        k_ms = cuda_ms(c["kernel"])
        p_ms = cuda_ms(c["plain"], reps=3, warm=1)
        lib_ms = None
        if c["sparse"] is not None:
            a = solve_sparse_matrix(n, c["sparse"])
            src = x if c["sparse"] == "forward" else r
            cols = src.reshape(b, -1).t().contiguous()
            prod = torch.sparse.mm(a, cols).t().reshape(got.shape)
            check_close(f"{name} vs the sparse product", got, prod, n)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(a, cols), reps=5,
                             warm=1)
            del a, cols, prod
        bytes_ms = 1e3 * c["nbytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * c["ops"] / FP32_ADDS_PER_S
        rows.append({
            "name": name, "route": "cuda", "source": c["source"],
            "replaces": c["replaces"], "launches": c["launches"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # K1's float32 function is one sparse product with the DPRT
            # (or inverse) matrix; no one call computes forward, weights
            # and inverse
            "library_ms": lib_ms,
            "shape": f"N={n} B={b} float32",
        })
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"timing {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {max(bytes_ms, ops_ms):.4f} ms ({rows[-1]['bound_by']})"
            f", sparse product {lib}, {c['launches']} launches on the solve "
            f"path, max |err| {err:.3g}")

    # -- one masked CG iteration at B = 256 --------------------------------
    def fixed(k):
        return radon.solve(m, bm, "cg", tol=0.0, maxiter=k)

    per = {}
    for k in (1, SOLVE_FIXED):
        iters = int(fixed(k).iterations)
        ev = cuda_ms(lambda: fixed(k), reps=SOLVE_TIMING_REPS, warm=1)
        walls = []
        for _ in range(SOLVE_TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fixed(k)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        per[k] = {"iterations": iters, "event_ms": ev,
                  "host_ms": statistics.median(walls)}
    k2_ms = rows[0]["ms"]
    timing = {"solves": per, "k2_mul_ms": k2_ms}
    k_one, k_fix = per[1]["iterations"], per[SOLVE_FIXED]["iterations"]
    if k_fix > k_one:
        for clock in ("event_ms", "host_ms"):
            timing[f"{clock}_per_iteration"] = (
                per[SOLVE_FIXED][clock] - per[1][clock]) / (k_fix - k_one)
        timing["outside_k2_share"] = 1 - k2_ms / timing[
            "event_ms_per_iteration"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fixed(SOLVE_FIXED)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_class = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        cls = ("K2" if "pipeline" in key else "K1" if "sfdprt" in key
               else "memset" if "memset" in key
               else "reductions" if "reduce" in key else "elementwise")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    if by_class:
        timing["profile"] = {
            "iterations": int(res.iterations),
            "device_ms_by_class": by_class, "host_wall_ms": wall_ms,
            "device_busy_share": sum(by_class.values()) / wall_ms}
    else:
        timing["profile"] = "not measured (the profiler saw no device time)"
    rows[0]["per_cg_iteration"] = timing
    log(f"timing masked CG at N={n} B={b} (tol 0): {json.dumps(timing)}")
    return rows


# ---------------------------------------------------------------------------
# the serving tier: DPRTService, the persistent executable cache, the
# router and the supervised pool
# ---------------------------------------------------------------------------
SERVE_DEVICE = "cuda"
SERVE_N = 251
SERVE_MAX_BATCH = 8
SERVE_REQUESTS = 64
SERVE_WAIT_US = 2000.0
#: passes of the coalesced traffic; throughput is the best pass
SERVE_REPEATS = 3
SERVE_DATAPATHS = ("forward", "inverse", "roundtrip", "conv", "solve")
#: the restart check's services: conv launches K1 (the kernel's
#: projections, once per executable) and K2, roundtrip K1 both ways, so
#: the blobs must carry both libraries
RESTART_DATAPATHS = ("conv", "roundtrip")
#: router chaos: the manifest, the seed and the one route faults target
CHAOS_NS = (13, 31, 251)
CHAOS_SEED = 7
CHAOS_ROUTE = "31x31/int32/forward"
POOL_WORKERS = 2
#: seconds a pool or restart child may take, end to end
SERVE_CHILD_TIMEOUT = 300


def serve_problem(n: int, dev):
    """The serving phase's requests and their plain answers on ``dev``:
    SERVE_REQUESTS phantoms, their projections (the inverse requests),
    the mask of SOLVE_DROP lost directions and the masked sinograms (the
    solve requests).  The expected answers are the kernels' plain
    versions -- ``sfdprt_plain`` forward and inverse, ``pipeline_plain``
    conv -- each checked equal to the plain ``gather`` backend, and the
    ``gather`` backend's masked CG solve."""
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S

    imgs_np = radon_images(n, SERVE_REQUESTS, kind="phantom")
    imgs = torch.from_numpy(imgs_np).to(dev)
    shape = (SERVE_REQUESTS, n, n)
    plain = radon.DPRT(shape, torch.int32, method="gather")
    proj = S.sfdprt_plain(imgs, sign=1, mode="forward")
    corr = (proj[:, n] - proj[:, 0].sum(-1, keepdim=True)).contiguous()
    back = S.sfdprt_plain(proj[:, :n].contiguous(), sign=-1, mode="inverse",
                          corr=corr)
    kernel = torch.ones((3, 3), dtype=torch.int32)
    kimg = torch.zeros((1, n, n), dtype=torch.int32, device=dev)
    kimg[0, :3, :3] = 1
    conv = P.pipeline_plain(imgs, kimg, op="conv", operand_form="image")[0]
    for name, got, want in (
            ("forward", proj, plain(imgs)),
            ("inverse", back, plain.inverse(proj)),
            ("conv", conv, radon.Conv2D(shape, kernel, torch.int32,
                                        method="gather")(imgs))):
        if not torch.equal(got, want):
            fail(f"serving reference: the plain {name} version differs "
                 f"from the gather backend")
    if not torch.equal(back, imgs):
        fail("serving reference: the plain inverse is not exact")
    missing = np.random.default_rng(0).choice(n + 1, SOLVE_DROP,
                                              replace=False)
    mask = radon.direction_mask(n, missing, device=dev)
    m = radon.MaskedDPRT(plain, mask=mask)
    bm = m(imgs)
    sol = radon.solve(m, bm, "cg", tol=SOLVE_TOL,
                      maxiter=SOLVE_MAXITER).image
    host = lambda t: list(t.cpu().numpy())      # noqa: E731
    return {
        "n": n, "kernel": kernel, "mask": mask,
        "missing": sorted(int(v) for v in missing),
        "requests": {"forward": list(imgs_np), "inverse": host(proj),
                     "roundtrip": list(imgs_np), "conv": list(imgs_np),
                     "solve": host(bm)},
        "plain": {"forward": host(proj), "inverse": host(back),
                  "roundtrip": list(imgs_np), "conv": host(conv),
                  "solve": host(sol)},
    }


def serve_service(datapath: str, prob: dict, dev, aot_dir=None, mesh=None):
    """One ``DPRTService`` of the serving phase (N from ``prob``, int32,
    max_batch 8: warm sizes 1, 2, 4, 8), on ``mesh`` when given."""
    import torch
    from repro_torch.launch.service import DPRTService
    kw = {} if mesh is None else {"mesh": mesh}
    if datapath == "conv":
        kw["conv_kernel"] = prob["kernel"]
    if datapath == "solve":
        kw.update(solve_mask=prob["mask"], solver="cg", solve_tol=SOLVE_TOL,
                  solve_maxiter=SOLVE_MAXITER)
    return DPRTService((prob["n"], prob["n"]), torch.int32,
                       max_batch=SERVE_MAX_BATCH, max_wait_us=SERVE_WAIT_US,
                       datapath=datapath, aot_dir=aot_dir, device=dev, **kw)


def check_responses(label: str, datapath: str, got, want) -> float:
    """Integer datapaths bit for bit; ``solve`` within SOLVE_IMAGE_REL of
    the expected image's peak.  Returns the worst error."""
    import numpy as np
    import torch
    if len(got) != len(want):
        fail(f"{label}: {len(got)} responses for {len(want)} requests")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            fail(f"{label}: response {i} has shape {g.shape}, want "
                 f"{w.shape}")
        if datapath == "solve":
            worst = max(worst, check_solve_image(
                f"{label} response {i}", torch.from_numpy(g),
                torch.from_numpy(w)))
        elif not np.array_equal(g, w):
            fail(f"{label}: response {i} differs (max |err| "
                 f"{np.abs(g.astype(np.int64) - w).max()})")
    return worst


def serve_expected_launches(datapath: str, batches: int, iters: int) -> dict:
    """The launches ``batches`` executions of one datapath make: one K1 per
    transform, one K2 per conv batch (and no K1 forward: the kernel's
    projections were made at warmup), one K1 inverse per solve batch
    (A^T of the right-hand side) and one K2 ``mul`` per CG iteration."""
    k1 = {"core": 0, "forward": 0, "inverse": 0}
    k2 = {"none": 0, "mul": 0, "conv": 0}
    if datapath in ("forward", "roundtrip"):
        k1["forward"] = batches
    if datapath in ("inverse", "roundtrip", "solve"):
        k1["inverse"] = batches
    if datapath == "conv":
        k2["conv"] = batches
    if datapath == "solve":
        k2["mul"] = iters
    return {"k1": k1, "k2": k2}


def serving_phase() -> dict:
    """``selfcheck`` on the card, then each datapath of ``DPRTService`` at
    N = 251 on the card: 64 requests sequentially (one batch-1
    executable each) and coalesced
    (padded to warm sizes), each run counted with zero builds allowed;
    the responses equal each other and the kernels' plain versions, the
    launches are one K1 per transform per batch, one K2 per conv batch
    and one K2 ``mul`` per CG iteration, and no fallback ran.  Returns
    the measured rates and latencies by datapath."""
    import torch
    from repro_torch.launch.service import latency_summary

    from repro_torch.radon import healthz, selfcheck

    dev = torch.device(SERVE_DEVICE)
    if selfcheck.run(dev) != 0:
        fail("python -m repro_torch.radon.selfcheck failed on the card")
    log("selfcheck passed on the card; " + healthz.report(dev).splitlines()[0])
    prob = serve_problem(SERVE_N, dev)
    out = {"missing": prob["missing"]}
    for dp in SERVE_DATAPATHS:
        reqs = prob["requests"][dp]
        svc = serve_service(dp, prob, dev)
        t0 = time.perf_counter()
        winfo = svc.warmup()
        warm_s = time.perf_counter() - t0
        (ref, seq_lat), seq = counted(lambda: svc.run_sequential(reqs))
        want = serve_expected_launches(dp, len(reqs), seq["iters"]["cg"])
        if {k: seq[k] for k in want} != want or any(seq["k3"].values()):
            fail(f"serve {dp} sequential: launches {seq}, expected {want}")
        svc.reset_metrics()
        got, co = counted(lambda: svc.run_requests(reqs,
                                                   repeats=SERVE_REPEATS))
        s = svc.stats()
        want = serve_expected_launches(dp, s["batches"], co["iters"]["cg"])
        if {k: co[k] for k in want} != want or any(co["k3"].values()):
            fail(f"serve {dp} coalesced: launches {co}, expected {want}")
        if s["requests"] != SERVE_REPEATS * len(reqs) or s["failures"]:
            fail(f"serve {dp}: {s['requests']} requests served, "
                 f"{s['failures']} failed")
        if s["fallback_uses"] != 0:
            fail(f"serve {dp}: fallback ran {s['fallback_uses']} times "
                 f"with no fault injected")
        if svc.steady_state_retraces() != 0:
            fail(f"serve {dp}: {svc.steady_state_retraces()} builds after "
                 f"warmup")
        if not svc.healthy():
            fail(f"serve {dp}: healthz verdict FAIL\n{svc.healthz()}")
        err = check_responses(f"serve {dp} coalesced vs sequential", dp,
                              got, ref)
        err = max(err, check_responses(f"serve {dp} vs plain", dp, got,
                                       prob["plain"][dp]))
        seq_rate = len(reqs) / sum(seq_lat)
        co_rate = len(reqs) / min(svc.last_pass_walls)
        seq_sum = latency_summary(seq_lat)
        lat = s["latency"]
        out[dp] = {"warmup_s": warm_s,
                   "executables": winfo["executables"],
                   "seq_imgs_per_s": seq_rate,
                   "seq_p50_ms": seq_sum["p50_ms"],
                   "seq_p99_ms": seq_sum["p99_ms"],
                   "imgs_per_s": co_rate, "p50_ms": lat["p50_ms"],
                   "p99_ms": lat["p99_ms"], "batches": s["batches"],
                   "batch_size_counts": s["batch_size_counts"],
                   "cg_iterations": co["iters"]["cg"], "max_err": err}
        log(f"serve {dp}: N={SERVE_N} {len(reqs)} requests, warm sizes "
            f"{svc.sizes}; sequential {seq_rate:.1f} img/s p50 "
            f"{seq_sum['p50_ms']:.3f} p99 {seq_sum['p99_ms']:.3f} ms; "
            f"coalesced {co_rate:.1f} img/s p50 {lat['p50_ms']:.3f} p99 "
            f"{lat['p99_ms']:.3f} ms (best of {SERVE_REPEATS}; "
            f"{s['batches']} batches {s['batch_size_counts']}); launches "
            f"k1 {co['k1']} k2 {co['k2']} cg iterations "
            f"{co['iters']['cg']}; exact vs sequential and plain"
            + (f" (solve max |err|/peak {err:.3g})" if dp == "solve"
               else "") + "; 0 builds, 0 fallbacks")
    return out


def restart_child(stage: str, aot_dir: str) -> int:
    """One process of the warm-restart check (``chip_smoke.py
    --serve-restart-child STAGE DIR``): A cold (an empty build directory:
    nvcc builds the libraries), B with an empty build directory and nvcc
    replaced by a function that raises, C after
    ``faults.corrupt_blobs(DIR, seed=0)``; MA and MB are A (the libraries
    already built) and B on a (1, 1) mesh over NCCL.  Builds the
    RESTART_DATAPATHS services over ``DIR``, warms them, serves
    SERVE_MAX_BATCH requests of each against the plain backend and prints
    one JSON line."""
    import tempfile
    import torch
    from repro_torch import radon
    from repro_torch.kernels import _build
    from repro_torch.launch import faults

    if stage in ("A", "B", "MB"):  # no library built yet: a true cold
        _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="restart_build_"))
    if stage in ("B", "MB"):
        def no_nvcc():
            raise RuntimeError("nvcc must not run in a restart from blobs")
        _build._nvcc = no_nvcc
    if stage == "C":
        faults.corrupt_blobs(aot_dir, seed=0)
    dev = torch.device(SERVE_DEVICE)
    mesh = None
    if stage.startswith("M"):
        from repro_torch.launch.mesh import init_world, make_local_mesh
        init_world(SERVE_DEVICE)
        mesh = make_local_mesh(1, 1)
    n = SERVE_N
    shape = (SERVE_MAX_BATCH, n, n)
    from repro_torch.data.synthetic import radon_images
    imgs_np = radon_images(n, SERVE_MAX_BATCH, seed=5, kind="phantom")
    imgs = torch.from_numpy(imgs_np).to(dev)
    kernel = torch.ones((3, 3), dtype=torch.int32)
    plain = {"conv": radon.Conv2D(shape, kernel, torch.int32,
                                  method="gather")(imgs).cpu().numpy(),
             "roundtrip": imgs_np}
    prob = {"n": n, "kernel": kernel}
    builds = radon.trace_count(kind="kernel")
    stats, warm_s = {}, 0.0
    for dp in RESTART_DATAPATHS:
        svc = serve_service(dp, prob, dev, aot_dir=aot_dir, mesh=mesh)
        t0 = time.perf_counter()
        info = svc.warmup()
        warm_s += time.perf_counter() - t0
        for k, v in info["persistent"].items():
            if k != "directory":
                stats[k] = stats.get(k, 0) + v
        stats["executables"] = stats.get("executables", 0) \
            + info["executables"]
        got = svc.run_requests(list(imgs_np))
        check_responses(f"restart {stage} {dp}", dp, got, list(plain[dp]))
        if svc.close():
            fail(f"restart {stage} {dp}: builds after warmup on the mesh")
    if mesh is not None:
        from repro_torch.launch.mesh import close_world
        close_world()
    print(json.dumps({"stage": stage, "warmup_s": warm_s,
                      "nvcc_builds": radon.trace_count(kind="kernel")
                      - builds,
                      "build_dir": str(_build.BUILD_DIR), **stats}),
          flush=True)
    return 0


def run_child(args: list) -> dict:
    """Run ``chip_smoke.py`` with ``args`` in a fresh process; its last
    stdout line is a JSON object."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           *args], capture_output=True, text=True,
                          timeout=SERVE_CHILD_TIMEOUT)
    if proc.returncode != 0:
        fail(f"child {args} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def warm_restart_phase() -> dict:
    """Three processes over one aot_dir: A cold (every executable a
    miss, its libraries built by nvcc), B restored with no build directory and no nvcc (every one a
    hit, 0 nvcc builds, exact responses: the blobs carry the kernels),
    C after corrupt_blobs(seed=0) (every blob an error and a degraded
    compile, no crash, exact responses)."""
    import shutil
    import tempfile
    aot_dir = tempfile.mkdtemp(prefix="serve_aot_")
    try:
        a = run_child(["--serve-restart-child", "A", aot_dir])
        e = a["executables"]
        if (a["misses"], a["hits"], a["errors"]) != (e, 0, 0):
            fail(f"restart A (cold): {a}, expected misses == {e}, hits 0")
        b = run_child(["--serve-restart-child", "B", aot_dir])
        if (b["hits"], b["misses"], b["errors"], b["nvcc_builds"]) \
                != (e, 0, 0, 0):
            fail(f"restart B (from blobs, no nvcc): {b}, expected hits == "
                 f"{e}, 0 misses, 0 nvcc builds")
        c = run_child(["--serve-restart-child", "C", aot_dir])
        if (c["errors"], c["degraded_compiles"], c["hits"]) != (e, e, 0):
            fail(f"restart C (corrupt blobs): {c}, expected errors == "
                 f"degraded_compiles == {e}")
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    log(f"warm restart over one aot_dir, {e} executables "
        f"({'+'.join(RESTART_DATAPATHS)}, N={SERVE_N}): A cold misses "
        f"{a['misses']}, {a['nvcc_builds']} nvcc builds, warmup "
        f"{a['warmup_s']:.3f} s; B restored hits "
        f"{b['hits']} with an empty build dir and no nvcc, warmup "
        f"{b['warmup_s']:.3f} s; C corrupt blobs: errors {c['errors']}, "
        f"degraded compiles {c['degraded_compiles']}, warmup "
        f"{c['warmup_s']:.3f} s; responses exact in all three")
    return {"executables": e, "cold_nvcc_builds": a["nvcc_builds"],
            "cold_warmup_s": a["warmup_s"],
            "restored_warmup_s": b["warmup_s"],
            "corrupt_warmup_s": c["warmup_s"]}


def router_chaos_phase() -> dict:
    """The router on the card with a manifest of N in CHAOS_NS over an
    aot_dir whose blobs were corrupted: a seeded burst with deadlines,
    priorities and a flood under seeded errors and delays aimed at
    CHAOS_ROUTE, then one request of that route whose dispatch and retry
    both fail, so it degrades to the fallback.  Every response is exact
    against the plain backend or a typed error, no future is dropped,
    and fallbacks ran on the faulted route only."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.launch import faults
    from repro_torch.launch.errors import ServiceError
    from repro_torch.launch.router import ServiceRouter

    dev = torch.device(SERVE_DEVICE)
    manifest = [{"n": n} for n in CHAOS_NS]
    aot_dir = tempfile.mkdtemp(prefix="chaos_aot_")
    try:
        seeder = ServiceRouter(max_batch=SERVE_MAX_BATCH, aot_dir=aot_dir,
                               device=dev)
        seeder.prefill(manifest)
        radon.aot_cache_clear()
        corrupted = faults.corrupt_blobs(aot_dir, seed=CHAOS_SEED)
        rng = np.random.default_rng(CHAOS_SEED)
        traffic, want = [], []
        for i in range(48):
            n = CHAOS_NS[i % len(CHAOS_NS)]
            img = rng.integers(0, 256, (n, n)).astype(np.int32)
            kw = {}
            if i % 11 == 3:
                kw["deadline_s"] = 1e-6      # unmeetable: typed rejection
            if i % 5 == 0:
                kw["priority"] = 1
            traffic.append(({"n": n}, img, kw))
        for _ in range(48):                  # a flood of one route
            traffic.append(({"n": CHAOS_NS[0]},
                            np.zeros((CHAOS_NS[0],) * 2, np.int32), {}))
        for spec, img, _kw in traffic:
            n = spec["n"]
            op = radon.DPRT((1, n, n), torch.int32, method="gather")
            want.append(op(torch.from_numpy(img[None]).to(dev))[0].cpu()
                        .numpy())
        router = ServiceRouter(max_batch=SERVE_MAX_BATCH, max_wait_us=500.0,
                               queue_cap=16, max_retries=1,
                               retry_backoff_s=1e-3, aot_dir=aot_dir,
                               device=dev)
        router.prefill(manifest)
        with faults.FaultInjector(seed=CHAOS_SEED, sites=("dispatch",),
                                  match=CHAOS_ROUTE, error_count=1,
                                  error_rate=0.2, delay_s=0.002,
                                  delay_rate=0.3) as inj:
            outs = router.run_requests(traffic)
        # the degrade path, forced: every dispatch attempt of one request
        # of CHAOS_ROUTE fails, so the retries run out
        n = int(CHAOS_ROUTE.split("x")[0])
        img = rng.integers(0, 256, (n, n)).astype(np.int32)
        op = radon.DPRT((1, n, n), torch.int32, method="gather")
        traffic.append(({"n": n}, img, {}))
        want.append(op(torch.from_numpy(img[None]).to(dev))[0].cpu().numpy())
        with faults.FaultInjector(seed=CHAOS_SEED + 1, sites=("dispatch",),
                                  match=CHAOS_ROUTE,
                                  error_count=router.max_retries + 1):
            outs += router.run_requests([({"n": n}, img)])
        exact = typed = 0
        for (spec, _img, kw), out, w in zip(traffic, outs, want):
            if isinstance(out, ServiceError):
                typed += 1
            elif isinstance(out, BaseException):
                fail(f"router chaos: untyped failure {out!r}")
            elif not np.array_equal(np.asarray(out), w):
                fail(f"router chaos: a response for N={spec['n']} is wrong")
            else:
                exact += 1
        s = router.stats()
        fallback = {label: route.service.stats()["fallback_uses"]
                    for label, route in
                    ((r.label, r) for r in router._routes.values())}
        if s["pending"] or s["failed"]:
            fail(f"router chaos: pending {s['pending']} failed "
                 f"{s['failed']}")
        accounted = (s["delivered"] + s["failed"] + s["pending"]
                     + router.rejected_deadline + router.rejected_shutdown)
        if s["admitted"] != accounted:
            fail(f"router chaos: admitted {s['admitted']} != accounted "
                 f"{accounted}")
        if fallback.get(CHAOS_ROUTE, 0) < 1 or any(
                v for k, v in fallback.items() if k != CHAOS_ROUTE):
            fail(f"router chaos: fallback uses {fallback}, expected > 0 on "
                 f"{CHAOS_ROUTE} only")
        if router.degraded_compiles() < 1 or typed < 1:
            fail(f"router chaos: degraded compiles "
                 f"{router.degraded_compiles()}, typed {typed}")
        if router.verdict() != "WARN":
            fail(f"router chaos: verdict {router.verdict()}")
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    log(f"router chaos: N in {CHAOS_NS}, seed {CHAOS_SEED}, {corrupted} "
        f"blobs corrupted ({router.degraded_compiles()} degraded compiles); "
        f"{len(traffic)} requests: {exact} exact, {typed} typed; injected "
        f"{inj.stats()['injected_errors']} errors, "
        f"{inj.stats()['injected_delays']} delays on {CHAOS_ROUTE}; "
        f"fallback uses {fallback}; verdict WARN")
    return {"exact": exact, "typed": typed, "fallback_uses": fallback}


def pool_phase() -> dict:
    """POOL_WORKERS worker processes on the one card over a shared cold
    aot_dir, one SIGKILLed mid-traffic: every request answered once and
    exactly (the killed worker's in-flight ones replayed on its peer),
    the workers' persistent misses summing to the executables."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.checkpoint.store import list_blobs
    from repro_torch.launch.supervisor import WorkerPool

    dev = torch.device(SERVE_DEVICE)
    n = SERVE_N
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (n, n)).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]
    op = radon.DPRT((SERVE_REQUESTS, n, n), torch.int32, method="gather")
    want = op(torch.from_numpy(np.stack(imgs)).to(dev)).cpu().numpy()
    aot_dir = tempfile.mkdtemp(prefix="pool_aot_")
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    pool = WorkerPool(POOL_WORKERS, aot_dir=aot_dir, manifest=[{"n": n}],
                      max_batch=SERVE_MAX_BATCH, pending_cap=256,
                      probe_interval_s=2.0, restart_backoff_s=0.25,
                      env=env, device=str(dev), drain_timeout_s=60.0)
    try:
        with pool:
            t0 = time.perf_counter()
            if not pool.wait_ready(float(SERVE_CHILD_TIMEOUT)):
                fail("pool workers never became ready")
            boot_s = time.perf_counter() - t0
            cold = pool.healthz(probe=True, probe_timeout_s=30.0)
            misses = sum((w["persistent"] or {}).get("misses", 0)
                         for w in cold["workers"])
            blobs = len(list_blobs(aot_dir))
            t1 = time.perf_counter()
            futs = [pool.submit({"n": n}, im) for im in imgs]
            # worker 0 holds half the traffic in flight: kill it now
            lost = len(pool._workers[0].inflight)
            if not lost or not pool.kill_worker(0):
                fail("pool: worker 0 was not live with requests in flight")
            outs = [f.result(timeout=SERVE_CHILD_TIMEOUT) for f in futs]
            wall = time.perf_counter() - t1
            deadline = time.monotonic() + SERVE_CHILD_TIMEOUT
            while pool.workers_lost < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            for i, o in enumerate(outs):
                if not np.array_equal(np.asarray(o), want[i]):
                    fail(f"pool: response {i} is wrong")
            journal = pool.journal.stats()
            report = pool.healthz()
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    if misses != blobs:
        fail(f"pool: the workers' persistent misses sum to {misses}, "
             f"{blobs} executables on disk")
    if pool.delivered != SERVE_REQUESTS or journal["deliver"] \
            != SERVE_REQUESTS or pool.failed or not pool.identity_ok():
        fail(f"pool: delivered {pool.delivered}, journal {journal}, "
             f"failed {pool.failed}, identity {pool.identity_ok()}")
    if pool.workers_lost < 1:
        fail("pool: the SIGKILL did not register as a worker loss")
    log(f"pool: {POOL_WORKERS} workers on the card, N={n}, cold boot "
        f"{boot_s:.1f} s, persistent misses {misses} == {blobs} "
        f"executables; {SERVE_REQUESTS} requests in {wall:.2f} s with "
        f"worker 0 SIGKILLed holding {lost} in flight: all answered once "
        f"and exactly ({pool.replays} replayed, verdict "
        f"{report['verdict']})")
    return {"boot_s": boot_s, "misses": misses, "replays": pool.replays,
            "req_per_s": SERVE_REQUESTS / wall}


# ---------------------------------------------------------------------------
# slice 12: the serving tier on a mesh (K1 and K3 on the mesh service)
# ---------------------------------------------------------------------------
def mesh_serve_expected_launches(datapath: str, batches: int,
                                 iters: int) -> dict:
    """The launches ``batches`` executions of one datapath make on a
    mesh: one K1 forward per forward batch, one K1 core per inverse batch
    (the mesh inverse's skew-sum; its epilogue is torch), K1 forward and
    K3 conv per conv batch, and per solve batch one K1 core (A^T b) with
    one K1 forward and one K3 ``mul`` per CG iteration; never K2."""
    k1 = {"core": 0, "forward": 0, "inverse": 0}
    k3 = {"none": 0, "mul": 0, "conv": 0}
    if datapath in ("forward", "roundtrip", "conv"):
        k1["forward"] = batches
    if datapath in ("inverse", "roundtrip", "solve"):
        k1["core"] = batches
    if datapath == "conv":
        k3["conv"] = batches
    if datapath == "solve":
        k1["forward"] += iters
        k3["mul"] = iters
    return {"k1": k1, "k2": {"none": 0, "mul": 0, "conv": 0}, "k3": k3}


def mark_mesh_service_launches(kernels: list, mesh_service: dict) -> None:
    """Give the int32 K1 and K3 rows of the ``kernels`` line the launches
    of the mesh service's coalesced runs (all datapaths together) as
    ``mesh_service_launches``."""
    total = {}
    for dp in SERVE_DATAPATHS:
        for k, counts in mesh_service[dp]["launches"].items():
            for mode, n in counts.items():
                total[(k, mode)] = total.get((k, mode), 0) + n
    for row in kernels:
        m = re.fullmatch(r"(sfdprt|pipeline_tail)_kernel\[(\w+)\]",
                         row["name"])
        if m:
            k = "k1" if m.group(1) == "sfdprt" else "k3"
            row["mesh_service_launches"] = total.get((k, m.group(2)), 0)


def mesh_turn_cost(prob: dict, dev, mesh) -> dict:
    """Host ms of one forward batch of SERVE_MAX_BATCH through
    ``execute()``, unsharded and on the mesh (median of 20), and of the
    mesh service's turn alone (a header and the stack broadcast, the
    outcome's all_reduce read on the host; median of 50)."""
    import numpy as np
    import torch
    stack = np.stack(prob["requests"]["forward"][:SERVE_MAX_BATCH])
    out = {}
    for label, m in (("unsharded_ms", None), ("mesh_ms", mesh)):
        svc = serve_service("forward", prob, dev, mesh=m)
        svc.warmup()
        walls = []
        for i in range(25):
            t0 = time.perf_counter()
            svc.execute(stack)
            if i >= 5:
                walls.append(1e3 * (time.perf_counter() - t0))
        out[label] = statistics.median(walls)
        if m is not None:
            link = svc._link
            x = torch.from_numpy(stack).to(dev)
            walls = []
            for i in range(55):
                t0 = time.perf_counter()
                link.send(1, SERVE_MAX_BATCH)
                link.stack(x)
                link.agree(True)
                if i >= 5:
                    walls.append(1e3 * (time.perf_counter() - t0))
            out["turn_ms"] = statistics.median(walls)
        svc.close()
    log(f"mesh service: one forward batch of {SERVE_MAX_BATCH} through "
        f"execute() {out['mesh_ms']:.3f} ms on the mesh vs "
        f"{out['unsharded_ms']:.3f} ms unsharded; the turn alone "
        f"{out['turn_ms']:.3f} ms (host clock, medians)")
    return out


def mesh_service_phase() -> dict:
    """``DPRTService`` on a (1, 1) ("data", "model") mesh over NCCL at N =
    251, max batch 8, 64 requests: ``python -m repro_torch.launch.serve
    --mode service --mesh-shape 1,1`` once, then each datapath's
    sequential and coalesced runs counted (mesh_serve_expected_launches;
    zero builds in them, after warmup and on every rank at ``close``; no
    fallback; one turn per batch), its responses equal to the unsharded
    service's from this run, to the plain versions and to each other
    (solve within SOLVE_IMAGE_REL), images/s and p50/p99 beside the
    unsharded service's; then the conv and roundtrip services restarted
    from an aot_dir on the mesh plan in two processes, the second with an
    empty build directory and nvcc that raises (every executable
    restored, 0 builds)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_world, make_local_mesh
    from repro_torch.launch.service import latency_summary

    dev = torch.device(SERVE_DEVICE)
    init_world(SERVE_DEVICE)
    mesh = make_local_mesh(1, 1)
    t0 = time.perf_counter()
    S.reset_launch_counts()
    P.reset_launch_counts()
    served = serve.main([
        "--mode", "service", "--mesh-shape", "1,1", "--device",
        SERVE_DEVICE, "--datapath", "roundtrip", "--n", str(SERVE_N),
        "--batch", str(SERVE_MAX_BATCH), "--requests", str(SERVE_REQUESTS),
        "--iters", "2"])
    cli = {"k1": dict(S.MODE_LAUNCHES), "k2": dict(P.OP_LAUNCHES)}
    if len(served) != SERVE_REQUESTS or cli["k1"]["forward"] < 1 \
            or cli["k1"]["core"] != cli["k1"]["forward"] \
            or any(cli["k2"].values()):
        fail(f"serve --mode service --mesh-shape 1,1: {len(served)} "
             f"responses, launches {cli}")
    log(f"mesh service: serve --mode service --mesh-shape 1,1 --datapath "
        f"roundtrip, {SERVE_REQUESTS} requests in "
        f"{time.perf_counter() - t0:.2f} s, launches {cli['k1']}")
    prob = serve_problem(SERVE_N, dev)
    out = {}
    for dp in SERVE_DATAPATHS:
        reqs = prob["requests"][dp]
        flat = serve_service(dp, prob, dev)
        flat.warmup()
        flat_got = flat.run_requests(reqs, repeats=SERVE_REPEATS)
        flat_lat = flat.stats()["latency"]
        flat_rate = len(reqs) / min(flat.last_pass_walls)
        svc = serve_service(dp, prob, dev, mesh=mesh)
        if svc.stats()["method"] != "sharded_cuda":
            fail(f"mesh service {dp} resolved to {svc.stats()['method']}")
        t1 = time.perf_counter()
        winfo = svc.warmup()
        warm_s = time.perf_counter() - t1
        (ref, seq_lat), seq = counted(lambda: svc.run_sequential(reqs))
        want = mesh_serve_expected_launches(dp, len(reqs),
                                            seq["iters"]["cg"])
        if {k: seq[k] for k in want} != want:
            fail(f"mesh serve {dp} sequential: launches {seq}, expected "
                 f"{want}")
        svc.reset_metrics()
        got, co = counted(lambda: svc.run_requests(reqs,
                                                   repeats=SERVE_REPEATS))
        st = svc.stats()
        want = mesh_serve_expected_launches(dp, st["batches"],
                                            co["iters"]["cg"])
        if {k: co[k] for k in want} != want:
            fail(f"mesh serve {dp} coalesced: launches {co}, expected "
                 f"{want}")
        if st["requests"] != SERVE_REPEATS * len(reqs) or st["failures"] \
                or st["fallback_uses"] or not svc.healthy():
            fail(f"mesh serve {dp}: unhealthy\n{svc.healthz()}")
        turns = svc.turns
        builds = svc.close()
        if builds != 0 or turns != len(reqs) + st["batches"]:
            fail(f"mesh serve {dp}: {builds} builds after warmup, {turns} "
                 f"turns for {len(reqs)} + {st['batches']} batches")
        err = check_responses(f"mesh serve {dp} coalesced vs sequential",
                              dp, got, ref)
        err = max(err, check_responses(f"mesh serve {dp} vs unsharded",
                                       dp, got, flat_got))
        err = max(err, check_responses(f"mesh serve {dp} vs plain", dp,
                                       got, prob["plain"][dp]))
        lat = st["latency"]
        seq_sum = latency_summary(seq_lat)
        rate = len(reqs) / min(svc.last_pass_walls)
        out[dp] = {"warmup_s": warm_s, "executables": winfo["executables"],
                   "imgs_per_s": rate, "p50_ms": lat["p50_ms"],
                   "p99_ms": lat["p99_ms"],
                   "seq_imgs_per_s": len(reqs) / sum(seq_lat),
                   "seq_p50_ms": seq_sum["p50_ms"],
                   "unsharded_imgs_per_s": flat_rate,
                   "unsharded_p50_ms": flat_lat["p50_ms"],
                   "unsharded_p99_ms": flat_lat["p99_ms"],
                   "batches": st["batches"], "turns": turns,
                   "launches": {k: co[k] for k in ("k1", "k3")},
                   "cg_iterations": co["iters"]["cg"], "max_err": err}
        log(f"mesh serve {dp}: N={SERVE_N} on {mesh.mesh_dim_names} "
            f"(1, 1), {len(reqs)} requests; coalesced {rate:.1f} img/s "
            f"p50 {lat['p50_ms']:.3f} p99 {lat['p99_ms']:.3f} ms vs "
            f"unsharded {flat_rate:.1f} img/s p50 "
            f"{flat_lat['p50_ms']:.3f} p99 {flat_lat['p99_ms']:.3f} ms "
            f"(best of {SERVE_REPEATS}); sequential "
            f"{out[dp]['seq_imgs_per_s']:.1f} img/s; launches k1 "
            f"{co['k1']} k3 {co['k3']} over {st['batches']} batches, cg "
            f"iterations {co['iters']['cg']}; {turns} turns; exact vs "
            f"unsharded, plain and sequential"
            + (f" (solve max |err|/peak {err:.3g})" if dp == "solve"
               else "") + "; 0 builds, 0 fallbacks")
    out["per_batch"] = mesh_turn_cost(prob, dev, mesh)
    aot_dir = tempfile.mkdtemp(prefix="mesh_aot_")
    try:
        a = run_child(["--serve-restart-child", "MA", aot_dir])
        e = a["executables"]
        if (a["misses"], a["hits"], a["errors"]) != (e, 0, 0):
            fail(f"mesh restart MA (cold): {a}, expected misses == {e}")
        b = run_child(["--serve-restart-child", "MB", aot_dir])
        if (b["hits"], b["misses"], b["errors"], b["nvcc_builds"]) \
                != (e, 0, 0, 0):
            fail(f"mesh restart MB (from blobs, no nvcc): {b}, expected "
                 f"hits == {e}, 0 misses, 0 nvcc builds")
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    log(f"mesh service restart over one aot_dir, {e} executables "
        f"({'+'.join(RESTART_DATAPATHS)}, N={SERVE_N}, mesh (1, 1)): MA "
        f"misses {a['misses']}, warmup {a['warmup_s']:.3f} s; MB restored "
        f"hits {b['hits']} with an empty build dir and no nvcc, 0 builds, "
        f"warmup {b['warmup_s']:.3f} s; responses exact")
    out["restart"] = {"executables": e, "cold_warmup_s": a["warmup_s"],
                      "restored_warmup_s": b["warmup_s"]}
    return out


# ---------------------------------------------------------------------------
# the LM substrate's serving path (plain PyTorch: no hand-written kernel)
# ---------------------------------------------------------------------------
LM_DEVICE = "cuda"
LM_ARCH = "tinyllama_1_1b"
#: serve --mode lm's defaults: batch 8, prompt 32, 16 generated
LM_BATCH, LM_PROMPT, LM_GEN = 8, 32, 16
#: (prompt, generated) shapes timed at LM_BATCH
LM_TIMING = ((LM_PROMPT, LM_GEN), (512, 128))
LM_TIMING_REPS = 3
LM_PROFILE_STEPS = 4
#: the prefill-then-decode check: batch, prompt (past any patch prefix)
LM_CHECK_B, LM_CHECK_S = 2, 40
#: the reference test's bounds (tests/test_models.py:65-71), relative to
#: the peak of the teacher-forced logits
LM_PREFILL_REL, LM_DECODE_REL = 1e-4, 2e-3
#: the card against the port's own CPU run, relative to the logits' peak
LM_CPU_REL = 1e-3


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def lm_cut(cfg):
    """A published-width config cut in depth to one block pattern: the
    dense first layers plus one pattern, at least 2 layers; an encoder
    keeps 2 layers at its full ``encoder_seq``."""
    kw = {"num_layers": max(2, cfg.first_dense_layers
                            + len(cfg.block_pattern))}
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    return cfg.replace(**kw)


def lm_no_drops(cfg):
    """MoE capacity past every token, so forward(S+1) and prefill(S) +
    decode route alike (as the reference's own check does)."""
    if cfg.num_experts:
        return cfg.replace(capacity_factor=float(cfg.num_experts))
    return cfg


def lm_inputs(cfg, b: int, s: int, dev, seed: int = 7) -> dict:
    """Random tokens (and stub front-end embeddings) from a seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.frontend == "patch_stub":
        out["patch_embed"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        out["audio_embed"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def lm_model(cfg, device, seed: int = 0, init_device=None):
    """The model with float32 weights from ``seed``, drawn on
    ``init_device`` (default ``device``) and copied to ``device``."""
    import torch
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import init_params
    model = Model(cfg)
    tree = init_params(model.specs(), seed, torch.float32,
                       init_device or device)
    return model.load_params(tree_to(tree, device))


def lm_teacher_forcing(label: str, model, s: int) -> tuple:
    """prefill(S) + one decode_step equal forward(S+1) at positions S-1
    and S within the reference test's bounds; returns both errors."""
    import torch
    dev = model._param().device
    batch = lm_inputs(model.cfg, LM_CHECK_B, s + 1, dev)
    pre = dict(batch, tokens=batch["tokens"][:, :s])
    with torch.inference_mode():
        ref, _ = model.forward(batch)
        last, cache = model.prefill(pre, max_len=s + 8)
        dec, _ = model.decode_step(cache, batch["tokens"][:, s:s + 1], s)
    for name, t in (("forward", ref), ("prefill", last), ("decode", dec)):
        if not bool(torch.isfinite(t).all()):
            fail(f"{label}: non-finite {name} logits")
    scale = float(ref[:, s - 1].abs().max()) + 1e-9
    err_pre = float((ref[:, s - 1] - last[:, 0]).abs().max()) / scale
    err_dec = float((ref[:, s] - dec[:, 0]).abs().max()) / scale
    if err_pre > LM_PREFILL_REL or err_dec > LM_DECODE_REL:
        fail(f"{label}: prefill {err_pre:.2e} / decode {err_dec:.2e} off "
             f"forward(S+1), bounds {LM_PREFILL_REL} / {LM_DECODE_REL}")
    return err_pre, err_dec


def lm_greedy(model, batch: dict, gen: int) -> tuple:
    """Greedy tokens (CPU), the prefill logits, and each step's top-2
    margin over the logits' peak (B, gen)."""
    import torch
    prompt = batch["tokens"].shape[1]
    margins = []
    with torch.inference_mode():
        logits, cache = model.prefill(batch, max_len=prompt + gen)
        first = logits[:, -1].float().cpu()
        toks = []
        for i in range(gen):
            if i:
                logits, cache = model.decode_step(cache, toks[-1],
                                                  prompt + i - 1)
            lg = logits[:, -1].float()
            top = torch.topk(lg, 2, dim=-1).values
            margins.append(((top[:, 0] - top[:, 1])
                            / lg.abs().amax(-1)).cpu())
            toks.append(lg.argmax(-1)[:, None].to(torch.int32))
    return (torch.cat(toks, 1).cpu(), first,
            torch.stack(margins, 1).numpy())


def lm_check_card_vs_cpu(label: str, card_model, cpu_model, batch: dict,
                         gen: int, card_tokens=None) -> dict:
    """The card's prefill logits within LM_CPU_REL of the CPU's peak, and
    its greedy tokens (``card_tokens``, else a greedy run on the card)
    equal to the CPU's up to each row's first step where the CPU's top-2
    margin is within LM_CPU_REL."""
    import torch
    cpu_tokens, cpu_first, margins = lm_greedy(
        cpu_model, tree_to(batch, "cpu"), gen)
    if card_tokens is None:
        tokens, card_first, _ = lm_greedy(card_model, batch, gen)
    else:
        tokens = card_tokens
        with torch.inference_mode():
            card_first = card_model.prefill(batch)[0][:, -1].float().cpu()
    err = float((card_first - cpu_first).abs().max()) / (
        float(cpu_first.abs().max()) + 1e-9)
    if err > LM_CPU_REL:
        fail(f"{label}: prefill logits {err:.2e} of the peak off the "
             f"CPU's (bound {LM_CPU_REL})")
    near = 0
    for row in range(tokens.shape[0]):
        diff = torch.nonzero(tokens[row] != cpu_tokens[row]).flatten()
        if diff.numel():
            step = int(diff[0])
            if margins[row, step] > LM_CPU_REL:
                fail(f"{label}: row {row} step {step}: token "
                     f"{int(tokens[row, step])} on the card, "
                     f"{int(cpu_tokens[row, step])} on the CPU at a margin "
                     f"of {margins[row, step]:.2e}")
            near += 1
    return {"prefill_rel": err, "rows_equal": tokens.shape[0] - near,
            "rows_near_tie": near}


def lm_time(model, batch: dict, gen: int) -> tuple:
    """(prefill ms, decode ms per step) of one greedy generation, by CUDA
    events, the median of LM_TIMING_REPS runs after one warm run."""
    import torch
    prompt = batch["tokens"].shape[1]
    pre, dec = [], []
    for rep in range(LM_TIMING_REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.inference_mode():
            ev[0].record()
            logits, cache = model.prefill(batch, max_len=prompt + gen)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            ev[1].record()
            for i in range(gen - 1):
                logits, cache = model.decode_step(cache, tok, prompt + i)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            ev[2].record()
        ev[2].synchronize()
        if rep:
            pre.append(ev[0].elapsed_time(ev[1]))
            dec.append(ev[1].elapsed_time(ev[2]) / (gen - 1))
        del cache
    return statistics.median(pre), statistics.median(dec)


def lm_profile_decode(model, batch: dict) -> dict:
    """Kernels launched per decode step and the device's busy share of
    the host wall over LM_PROFILE_STEPS steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prompt = batch["tokens"].shape[1]
    with torch.inference_mode():
        logits, cache = model.prefill(batch,
                                      max_len=prompt + LM_PROFILE_STEPS + 1)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        model.decode_step(cache, tok, prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, LM_PROFILE_STEPS + 1):
                logits, cache = model.decode_step(cache, tok, prompt + i)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy_us = 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            busy_us += us
    if not kernels:
        log("lm: the profiler saw no device time (not measured)")
        return {"kernels_per_step": None, "busy_share": None}
    return {"kernels_per_step": kernels / LM_PROFILE_STEPS,
            "busy_share": busy_us / 1e3 / wall_ms,
            "host_ms_per_step": wall_ms / LM_PROFILE_STEPS}


def lm_bounds(cfg, n_params: int, b: int, prompt: int, gen: int) -> dict:
    """The least time the card could take (dense attention models):
    decode reads every weight once per step (the embedding table only
    its b rows, unless it is tied to the output) and the valid K/V
    prefix, at HBM rate; prefill does 2 flops per weight per prompt
    token (the output projection for the last position only) and the
    causal half of the attention products, at the float32 peak."""
    emb = cfg.padded_vocab * cfg.d_model
    read = n_params - (0 if cfg.tie_embeddings else emb) + b * cfg.d_model
    kv_row = 2 * cfg.num_layers * b * cfg.num_kv_heads * cfg.hd
    kv_mean = kv_row * (prompt + (gen + 1) / 2)     # valid prefix, mean
    decode_ms = 1e3 * 4 * (read + kv_mean) / HBM_BYTES_PER_S
    body = n_params - emb * (1 if cfg.tie_embeddings else 2)
    flops = (2 * body * b * prompt + 2 * emb * b
             + 2 * cfg.num_layers * b * cfg.num_heads * cfg.hd * prompt ** 2)
    prefill_ms = 1e3 * max(flops / F32_FLOPS_PER_S,
                           4 * n_params / HBM_BYTES_PER_S)
    return {"decode_bound_ms": decode_ms, "decode_bytes": 4 * read,
            "prefill_bound_ms": prefill_ms, "prefill_flops": flops}


def lm_phase() -> dict:
    """``serve --mode lm`` on the card: tinyllama-1.1b at full depth and
    width through the CLI (no K1-K5 launch), held against the port's CPU
    run on the same weights and timed; the other nine architectures at
    published width with the depth cut (``lm_cut``); every smoke config
    on the card against the CPU."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import count_params

    dev = torch.device(LM_DEVICE)
    t_phase = time.perf_counter()
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        fail(f"float32 matmul precision is {precision!r}, not 'highest'")
    # -- the main path: the serve CLI at its defaults --------------------
    S.reset_launch_counts()
    P.reset_launch_counts()
    ST.reset_launch_counts()
    t0 = time.perf_counter()
    served = serve.main(["--mode", "lm", "--arch", LM_ARCH,
                         "--device", LM_DEVICE])
    serve_s = time.perf_counter() - t0
    kernel_launches = (S.LAUNCHES + sum(P.OP_LAUNCHES.values())
                       + sum(P.TAIL_OP_LAUNCHES.values()) + ST.LAUNCHES)
    if kernel_launches:
        fail(f"the LM path launched {kernel_launches} of K1-K5")
    if tuple(served.shape) != (LM_BATCH, LM_GEN):
        fail(f"serve --mode lm returned {tuple(served.shape)}")
    cfg = get_config(LM_ARCH)
    if not bool(((served >= 0) & (served < cfg.vocab_size)).all()):
        fail("serve --mode lm returned tokens outside the vocabulary")
    log(f"lm: serve --mode lm --arch {LM_ARCH} (batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {LM_GEN} generated) in {serve_s:.2f} s, K1-K5 "
        f"launches 0")

    # -- tinyllama at full size: checks, timing, profile -----------------
    model = lm_model(cfg, dev)
    n_params = count_params(model.specs())
    batch = serve.lm_batch(cfg, LM_BATCH, LM_PROMPT, dev)
    tf = lm_teacher_forcing(LM_ARCH, model, LM_CHECK_S)
    cpu_model = lm_model(cfg, "cpu", init_device=dev)
    cpu_check = lm_check_card_vs_cpu(LM_ARCH, model, cpu_model, batch,
                                     LM_GEN, card_tokens=served)
    del cpu_model
    log(f"lm: {LM_ARCH} ({n_params} parameters): prefill / decode "
        f"{tf[0]:.2e} / {tf[1]:.2e} off forward(S+1); card vs CPU "
        f"{json.dumps(cpu_check)}")
    timings = []
    for prompt, gen in LM_TIMING:
        tb = serve.lm_batch(cfg, LM_BATCH, prompt, dev)
        torch.cuda.reset_peak_memory_stats()
        pre_ms, dec_ms = lm_time(model, tb, gen)
        peak = torch.cuda.max_memory_allocated()
        total_s = (pre_ms + (gen - 1) * dec_ms) / 1e3
        row = {"batch": LM_BATCH, "prompt": prompt, "gen": gen,
               "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
               "tokens_per_s": LM_BATCH * gen / total_s,
               "decode_tokens_per_s": LM_BATCH / (dec_ms / 1e3),
               "peak_mem_bytes": peak}
        row.update(lm_bounds(cfg, n_params, LM_BATCH, prompt, gen))
        timings.append(row)
        log(f"lm: {LM_ARCH} b={LM_BATCH} prompt={prompt} gen={gen}: "
            f"prefill {pre_ms:.3f} ms (bound {row['prefill_bound_ms']:.3f})"
            f", decode {dec_ms:.3f} ms/step (weight-read bound "
            f"{row['decode_bound_ms']:.3f}), {row['tokens_per_s']:.1f} "
            f"tok/s, peak {peak / 2 ** 30:.2f} GiB")
    profile_row = lm_profile_decode(model, batch)
    log(f"lm: decode step profile {json.dumps(profile_row)}")
    del model
    torch.cuda.empty_cache()

    # -- the other nine at published width, depth cut --------------------
    archs = {}
    for arch in ARCH_IDS:
        if arch == LM_ARCH:
            continue
        t1 = time.perf_counter()
        cut = lm_no_drops(lm_cut(get_config(arch)))
        m = lm_model(cut, dev)
        s = LM_CHECK_S + (cut.prefix_len if cut.frontend == "patch_stub"
                          else 0)
        err_pre, err_dec = lm_teacher_forcing(arch, m, s)
        tb = lm_inputs(cut, LM_CHECK_B, s, dev, seed=8)
        pre_ms, dec_ms = lm_time(m, tb, 8)
        archs[arch] = {"layers": cut.num_layers,
                       "encoder_layers": cut.encoder_layers,
                       "params": count_params(m.specs()),
                       "prefill_rel": err_pre, "decode_rel": err_dec,
                       "batch": LM_CHECK_B, "prompt": s,
                       "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms}
        del m
        torch.cuda.empty_cache()
        log(f"lm: {arch} cut to {cut.num_layers} layers at d_model "
            f"{cut.d_model}: prefill / decode {err_pre:.2e} / "
            f"{err_dec:.2e} off forward(S+1); b={LM_CHECK_B} S={s}: "
            f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms/step "
            f"({time.perf_counter() - t1:.1f} s)")

    # -- every smoke config: the card against the CPU --------------------
    smoke = {}
    for arch in ARCH_IDS:
        scfg = get_smoke_config(arch)
        card = lm_model(scfg, dev, init_device="cpu")
        cpu = lm_model(scfg, "cpu")
        sb = serve.lm_batch(scfg, LM_BATCH, LM_PROMPT, dev)
        smoke[arch] = lm_check_card_vs_cpu(f"{arch} smoke", card, cpu, sb,
                                           LM_GEN)
        lm_teacher_forcing(f"{arch} smoke", lm_model(
            lm_no_drops(scfg), dev, init_device="cpu"), LM_CHECK_S)
    log(f"lm: smoke configs, card vs CPU: {json.dumps(smoke)}")
    return {"arch": LM_ARCH, "params": n_params, "float32_precision":
            precision, "serve_s": serve_s, "teacher_forcing": tf,
            "card_vs_cpu": cpu_check, "timing": timings,
            "decode_profile": profile_row, "archs": archs,
            "smoke_card_vs_cpu": smoke, "card": nvidia_smi_line(),
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the LM substrate's training path (plain PyTorch: no hand-written kernel)
# ---------------------------------------------------------------------------
TRAIN_DEVICE = "cuda"
#: ``python -m repro_torch.launch.train`` at full width: 4 steps of batch
#: 8 x 128 tokens, one final checkpoint (float32 params, mu and nu)
TRAIN_CLI_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 128
TRAIN_TIMING_REPS = 5
#: the depth-cut checks (card vs CPU, restart, bf16): batch and sequence
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 64
#: card vs CPU after one step: the loss (relative), the grad norm
#: (relative), the moments (of each leaf's peak)
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_MOMENT_REL = 1e-5, 1e-4, 1e-4
#: Adam's first step moves each element by lr x g / (|g| + 1e-8) (plus
#: the decay): an update within 1e-3 lr of the CPU's, except for at most
#: this share of a leaf's elements, whose gradient lies within ~1e-8 of
#: zero where that step is steep in g (those within 2.2 lr)
TRAIN_FLIP_SHARE = 1e-2


def reset_dprt_kernel_launches() -> None:
    """Set the K1-K5 launch counts to 0."""
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    S.reset_launch_counts()
    P.reset_launch_counts()
    ST.reset_launch_counts()


def dprt_kernel_launches() -> int:
    """K1-K5 launches counted since the last reset."""
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    return (S.LAUNCHES + sum(P.OP_LAUNCHES.values())
            + sum(P.TAIL_OP_LAUNCHES.values()) + ST.LAUNCHES)


def train_like(model, dtype) -> dict:
    """A checkpoint's tree (params, AdamW state) as meta tensors."""
    from repro_torch.optim import adamw_abstract
    from repro_torch.parallel.sharding import abstract_params
    params = abstract_params(model.specs(), dtype)
    return {"params": params, "opt": adamw_abstract(params)}


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def tree_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import tree_items
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def train_bounds(n_params: int, tokens: int, bf16: bool) -> dict:
    """The step's least time: 8 flops per parameter per token (forward
    2, backward 4, the full remat's second forward 2) at the float32
    (or bf16 tensor-core) peak, plus AdamW's bytes at HBM rate --
    float32: params read + written, grads read, mu and nu read +
    written (28 B per parameter); bf16: 2 + 2 + 2 + 8 + 8 = 22 B."""
    flops = 8 * n_params * tokens
    flops_ms = 1e3 * flops / (BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
    adam_bytes = (22 if bf16 else 28) * n_params
    adam_ms = 1e3 * adam_bytes / HBM_BYTES_PER_S
    return {"flops": flops, "flops_ms": flops_ms, "adam_bytes": adam_bytes,
            "adam_ms": adam_ms, "bound_ms": flops_ms + adam_ms}


def train_profile_step(step) -> dict:
    """Kernels launched and the device's busy share of the host wall in
    one training step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy_us, device, host = 0, 0.0, [], []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            busy_us += us
            device.append((us / 1e3, e.key[:60], e.count))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.self_cpu_time_total / 1e3, e.key[:60], e.count))
    if not kernels:
        log("train: the profiler saw no device time (not measured)")
        return {"kernels": None, "busy_share": None, "wall_ms": wall_ms}
    return {"kernels": kernels, "busy_share": busy_us / 1e3 / wall_ms,
            "wall_ms": wall_ms,
            "device_top_ms": sorted(device, reverse=True)[:6],
            "host_self_top_ms": sorted(host, reverse=True)[:8]}


def train_cli_run(cfg, n_params: int) -> dict:
    """``launch.train.main`` at full width; its checkpoint's size, save
    and restore times, restored equal to the run's state, then deleted.
    Where the disk cannot hold the checkpoint, the depth (never the
    width) of this one run is cut to fit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import count_params
    ckdir = tempfile.mkdtemp(prefix="repro_train_")
    free = shutil.disk_usage(ckdir).free
    run_cfg = cfg
    while 12 * count_params(Model(run_cfg).specs()) * 1.2 > free:
        if run_cfg.num_layers == 1:
            fail(f"train: {free} bytes free cannot hold a one-layer "
                 f"checkpoint")
        run_cfg = run_cfg.replace(num_layers=run_cfg.num_layers - 1)
    get_config = train.get_config
    if run_cfg is not cfg:
        log(f"train: {free} bytes free cannot hold the full checkpoint "
            f"({12 * n_params} bytes): the CLI run is cut to "
            f"{run_cfg.num_layers} layers at d_model {run_cfg.d_model}")
        train.get_config = lambda arch: run_cfg
    try:
        t0 = time.perf_counter()
        out = train.main(["--arch", cfg.name, "--steps",
                          str(TRAIN_CLI_STEPS), "--batch", str(TRAIN_BATCH),
                          "--seq", str(TRAIN_SEQ), "--ckpt-every", "100",
                          "--ckpt-dir", ckdir, "--device", TRAIN_DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        train.get_config = get_config
    losses = [m["loss"] for m in out["log"]] + [out["last_loss"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in the CLI run: {losses}")
    ck = Path(ckdir) / f"step_{TRAIN_CLI_STEPS:08d}"
    size = dir_bytes(ck)
    like = train_like(Model(run_cfg), torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, step, _ = restore_checkpoint(ckdir, like, device=TRAIN_DEVICE)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != TRAIN_CLI_STEPS or not tree_equal(
            tree, {"params": out["params"], "opt": out["opt"]}):
        fail("train: the restored checkpoint differs from the run's state")
    shutil.rmtree(ckdir)
    row = {"arch": run_cfg.name, "layers": run_cfg.num_layers,
           "params": count_params(Model(run_cfg).specs()),
           "cut": run_cfg is not cfg, "cli_s": cli_s,
           "losses": [m["loss"] for m in out["log"]],
           "last_loss": out["last_loss"], "disk_free_bytes": free,
           "ckpt_bytes": size, "ckpt_copy_s": out["checkpoint"]["copy_s"],
           "ckpt_write_s": out["checkpoint"]["write_s"],
           "ckpt_restore_s": restore_s}
    log(f"train: launch.train --arch {cfg.name} ({row['layers']} layers, "
        f"{row['params']} parameters) {TRAIN_CLI_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {cli_s:.1f} s, losses "
        f"{row['losses']} last {out['last_loss']:.4f}; checkpoint "
        f"{size} bytes ({free} free): host copy {row['ckpt_copy_s']:.2f} s, "
        f"write {row['ckpt_write_s']:.2f} s, restore {restore_s:.2f} s, "
        f"equal to the run's state")
    del out, tree
    torch.cuda.empty_cache()
    return row


def train_timing(cfg, dtype, dev) -> dict:
    """``launch.steps.make_train_step`` at full width, batch 8 x 128: the
    median step (CUDA events), tokens/s, peak memory, its bound, and one
    profiled step."""
    import torch
    from repro_torch.data import TokenStream, shard_batch
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import count_params, init_params
    model = Model(cfg)
    n_params = count_params(model.specs())
    fn, _ = steps.make_train_step(model, None, "train_4k",
                                  param_dtype=dtype)
    params = init_params(model.specs(), 0, dtype, dev)
    state = [params, adamw_init(params)]
    batch = shard_batch(TokenStream(cfg.vocab_size, TRAIN_SEQ,
                                    TRAIN_BATCH).batch(0), None, dev)
    losses = []

    def step():
        state[0], state[1], m = fn(state[0], state[1], batch)
        losses.append(m["loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps=TRAIN_TIMING_REPS, warm=2)
    peak = torch.cuda.max_memory_allocated()
    prof = train_profile_step(step)
    if not all(bool(torch.isfinite(x)) for x in losses):
        fail(f"train: non-finite loss timing {dtype}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = {"dtype": str(dtype).split(".")[-1], "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "step_ms": ms,
           "tokens_per_s": tokens / (ms / 1e3), "peak_mem_bytes": peak,
           "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
           "profile": prof}
    row.update(train_bounds(n_params, tokens, dtype == torch.bfloat16))
    log(f"train: step {row['dtype']} b={TRAIN_BATCH} s={TRAIN_SEQ}: "
        f"{ms:.3f} ms (bound {row['bound_ms']:.3f}: flops "
        f"{row['flops_ms']:.3f} + AdamW {row['adam_ms']:.3f}), "
        f"{row['tokens_per_s']:.1f} tok/s, peak {peak / 2 ** 30:.2f} GiB, "
        f"profiled step {json.dumps(prof)}")
    del state, params, fn
    torch.cuda.empty_cache()
    return row


def train_remat(cut, dev) -> dict:
    """none / full / dots at the cut depth: the same loss and gradients;
    the bytes the forward keeps for the backward (what remat trades) and
    the peak of one loss + backward (above the parameters, the gradients
    held at the end included)."""
    import torch
    from repro_torch.data import TokenStream, shard_batch
    from repro_torch.models import Model
    from repro_torch.optim import global_norm
    from repro_torch.parallel.sharding import init_params
    from repro_torch.tree import tree_leaves, tree_unflatten
    params = init_params(Model(cut).specs(), 0, torch.float32, dev)
    batch = shard_batch(TokenStream(cut.vocab_size, TRAIN_SEQ,
                                    TRAIN_BATCH).batch(0), None, dev)
    rows = {}
    for mode in ("none", "full", "dots"):
        model = Model(cut.replace(remat=mode))
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(batch, params=tree_unflatten(params, leaves))[0]
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, leaves)
        gnorm = float(global_norm(grads))
        rows[mode] = {"loss": float(loss.detach()), "grad_norm": gnorm,
                      "saved_bytes": saved,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()
                      - base}
        del loss, grads, leaves
    for mode in ("full", "dots"):
        if rows[mode]["loss"] != rows["none"]["loss"] or abs(
                rows[mode]["grad_norm"] - rows["none"]["grad_norm"]) > \
                1e-6 * rows["none"]["grad_norm"]:
            fail(f"train: remat {mode} changed the loss or gradients: "
                 f"{json.dumps(rows)}")
    log(f"train: remat at {cut.num_layers} layers, b={TRAIN_BATCH} "
        f"s={TRAIN_SEQ}: {json.dumps(rows)}")
    return rows


def train_update_check(label: str, got: dict, want: dict, lr: float
                       ) -> dict:
    """Parameters after Adam's first step on two devices: each update
    within 1e-3 lr, but for at most TRAIN_FLIP_SHARE of a leaf's
    elements (a gradient near zero), which stay within 2.2 lr; returns
    the largest share and difference."""
    from repro_torch.tree import tree_items
    worst_share, worst = 0.0, 0.0
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        d = (g.detach().double().cpu() - w.double()).abs()
        share = float((d > 1e-3 * lr).double().mean())
        worst_share = max(worst_share, share)
        worst = max(worst, float(d.max()))
        if share > TRAIN_FLIP_SHARE or float(d.max()) > 2.2 * lr:
            fail(f"{label}: {'/'.join(path)}: {share:.2e} of the updates "
                 f"differ, max {float(d.max()):.3e} (lr {lr})")
    return {"update_diff_share": worst_share, "update_max_diff": worst}


def train_card_vs_cpu(cut) -> dict:
    """One ``Trainer`` step at the cut depth on the card and on the CPU,
    both resuming a step-0 checkpoint of one CPU initialisation."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_items
    root = Path(tempfile.mkdtemp(prefix="repro_train_cmp_"))
    params = init_params(Model(cut).specs(), 0, torch.float32, "cpu")
    save_checkpoint(str(root / "card"), 0,
                    {"params": params, "opt": adamw_init(params)})
    shutil.copytree(root / "card", root / "cpu")
    outs = {}
    for name, dev in (("card", TRAIN_DEVICE), ("cpu", "cpu")):
        tcfg = TrainerConfig(batch_size=TRAIN_CHECK_B, seq_len=TRAIN_CHECK_S,
                             steps=1, ckpt_every=100, log_every=1,
                             ckpt_dir=str(root / name), device=dev)
        outs[name] = Trainer(cut, tcfg).run()
    card, cpu = outs["card"], outs["cpu"]
    lc, lp = card["log"][0], cpu["log"][0]
    loss_rel = abs(lc["loss"] - lp["loss"]) / abs(lp["loss"])
    gn_rel = abs(lc["grad_norm"] - lp["grad_norm"]) / lp["grad_norm"]
    if loss_rel > TRAIN_LOSS_REL or gn_rel > TRAIN_GNORM_REL:
        fail(f"train: card vs CPU loss {loss_rel:.2e} / grad norm "
             f"{gn_rel:.2e} apart (bounds {TRAIN_LOSS_REL} / "
             f"{TRAIN_GNORM_REL})")
    moment_rel = 0.0
    for name in ("mu", "nu"):
        for (path, g), (_, w) in zip(tree_items(card["opt"][name]),
                                     tree_items(cpu["opt"][name])):
            scale = float(w.abs().max()) + 1e-30
            rel = float((g.cpu() - w).abs().max()) / scale
            moment_rel = max(moment_rel, rel)
            if rel > TRAIN_MOMENT_REL:
                fail(f"train: card vs CPU {name} {'/'.join(path)} {rel:.2e}"
                     f" of its peak apart (bound {TRAIN_MOMENT_REL})")
    lr = TrainerConfig().lr / TrainerConfig().warmup   # step 1 of warmup
    row = {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
           "moment_rel": moment_rel, "loss": lc["loss"],
           "grad_norm": lc["grad_norm"]}
    row.update(train_update_check("train: card vs CPU", card["params"],
                                  cpu["params"], lr))
    shutil.rmtree(root)
    log(f"train: one Trainer step at {cut.num_layers} layers, card vs CPU "
        f"{json.dumps(row)}")
    return row


def train_restart(cut) -> dict:
    """``fail_at_step`` then a resumed run, against an uninterrupted run
    (the cut depth, on the card); and a bf16 run's checkpoint restored."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.models import Model
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig
    from repro_torch.tree import tree_items
    root = Path(tempfile.mkdtemp(prefix="repro_train_restart_"))

    def cfg(name, **kw):
        return TrainerConfig(batch_size=TRAIN_CHECK_B, seq_len=TRAIN_CHECK_S,
                             steps=4, ckpt_every=2, log_every=1,
                             ckpt_dir=str(root / name), device=TRAIN_DEVICE,
                             **kw)

    failing = Trainer(cut, cfg("a", fail_at_step=3))
    try:
        failing.run()
        fail("train: fail_at_step did not raise")
    except SimulatedFailure:
        failing.checkpointer.wait()        # the step-2 save in flight
    survived = latest_step(str(root / "a"))
    resumed = Trainer(cut, cfg("a")).run()
    clean = Trainer(cut, cfg("b")).run()
    exact = tree_equal(resumed["params"], clean["params"])
    worst = 0.0
    for (path, g), (_, w) in zip(tree_items(resumed["params"]),
                                 tree_items(clean["params"])):
        worst = max(worst, float((g - w).abs().max())
                    / (float(w.abs().max()) + 1e-30))
    if resumed["log"][0]["step"] != survived or worst > 1e-4:
        fail(f"train: the resumed run (from step {survived}) is "
             f"{worst:.2e} of a leaf's peak off the uninterrupted one")
    bf16 = Trainer(cut, cfg("bf16", param_dtype=torch.bfloat16)).run()
    tree, step, _ = restore_checkpoint(
        str(root / "bf16"), train_like(Model(cut), torch.bfloat16),
        device=TRAIN_DEVICE)
    manifest = json.loads((root / "bf16" / "step_00000004" /
                           "manifest.json").read_text())
    dtypes = {v["dtype"] for k, v in manifest["keys"].items()
              if k.startswith("params::")}
    if step != 4 or dtypes != {"bfloat16"} or not tree_equal(
            tree, {"params": bf16["params"], "opt": bf16["opt"]}):
        fail(f"train: the bf16 checkpoint (dtypes {dtypes}) did not "
             f"restore equal")
    shutil.rmtree(root)
    row = {"survived_step": survived, "exact": exact, "max_rel": worst,
           "bf16_restored": True, "bf16_last_loss": bf16["last_loss"]}
    log(f"train: restart at {cut.num_layers} layers {json.dumps(row)}")
    return row


def train_phase() -> dict:
    """``python -m repro_torch.launch.train`` on the card: tinyllama-1.1b
    at full width through the CLI with its checkpoint; the full-width
    step timed in float32 and bf16; remat modes, card vs CPU, restart
    and a bf16 restore at the cut depth (``lm_cut``); no K1-K5 launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import pipeline as P
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels import stream as ST
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import count_params

    dev = torch.device(TRAIN_DEVICE)
    t_phase = time.perf_counter()
    S.reset_launch_counts()
    P.reset_launch_counts()
    ST.reset_launch_counts()
    cfg = get_config(LM_ARCH)
    n_params = count_params(Model(cfg).specs())
    cli = train_cli_run(cfg, n_params)
    timing = [train_timing(cfg, dt, dev)
              for dt in (torch.float32, torch.bfloat16)]
    cut = lm_cut(cfg)
    remat = train_remat(cut, dev)
    card_vs_cpu = train_card_vs_cpu(cut)
    restart = train_restart(cut)
    launches = dprt_kernel_launches()
    if launches:
        fail(f"the training path launched {launches} of K1-K5")
    log("train: K1-K5 launches 0")
    return {"arch": LM_ARCH, "params": n_params, "cli": cli,
            "timing": timing, "cut_layers": cut.num_layers,
            "remat": remat, "card_vs_cpu": card_vs_cpu,
            "restart": restart, "dprt_launches": launches,
            "card": nvidia_smi_line(),
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# slice 12: the cost models beside this run's measurements
# ---------------------------------------------------------------------------
def cost_phase(lm: dict, trained: dict, k1_forward: dict) -> dict:
    """The counted cost models beside what this run measured:
    ``launch.hlo_cost.analyze_step`` over tinyllama-1.1b at full width on
    meta structs -- the float32 train step at TRAIN_BATCH x TRAIN_SEQ
    (remat full), and at LM_BATCH each LM_TIMING prefill and a decode
    step into a cache of prompt + gen at position ``prompt`` -- with
    ``roofline_terms`` at the float32 peak, beside ``lm_bounds`` /
    ``train_bounds`` and the step ms of the LM and training phases; and
    ``core.pareto.h100_strip_cost`` for K1's forward at radon_251 at each
    directions-per-block value of the timing phase's sweep, beside its
    measured ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.radon_251 import config as radon_config
    from repro_torch.core.pareto import h100_strip_cost
    from repro_torch.launch import shapes
    from repro_torch.launch.hlo_cost import analyze_step
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import Model
    from repro_torch.optim import adamw_abstract
    from repro_torch.parallel.sharding import abstract_params

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def row(label, counts, measured_ms, hand_ms):
        terms = roofline_terms(counts["flops"], counts["bytes"],
                               counts["coll_bytes"], 1,
                               peak_flops=HW["f32_flops"])
        r = {"flops": counts["flops"], "dot_flops": counts["dot_flops"],
             "bytes": counts["bytes"], "ops": counts["ops"],
             "compute_ms": 1e3 * terms["compute_s"],
             "memory_ms": 1e3 * terms["memory_s"],
             "bound_ms": 1e3 * terms["step_s_lower_bound"],
             "dominant": terms["dominant"], "hand_bound_ms": hand_ms,
             "measured_ms": measured_ms,
             "top_flops": counts["flops_by_op"],
             "top_bytes": counts["bytes_by_op_unscaled"]}
        log(f"cost {label}: counted {r['flops']:.4e} flop ({r['dot_flops']:.4e} "
            f"in products), {r['bytes']:.4e} B, {r['ops']} ops -> float32 "
            f"roofline {r['bound_ms']:.3f} ms ({r['dominant']}; compute "
            f"{r['compute_ms']:.3f}, memory {r['memory_ms']:.3f}); hand "
            f"bound {hand_ms:.3f} ms; measured {measured_ms:.3f} ms")
        return r

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = Model(cfg)
    params = abstract_params(model.specs(), torch.float32)
    out = {}
    step, _ = make_train_step(model, None, "train_4k",
                              param_dtype=torch.float32)
    f32 = next(r for r in trained["timing"] if r["dtype"] == "float32")
    out["train_float32"] = row(
        f"train step float32 {TRAIN_BATCH}x{TRAIN_SEQ} remat "
        f"{cfg.remat}", analyze_step(
            step, params, adamw_abstract(params),
            {"tokens": meta(TRAIN_BATCH, TRAIN_SEQ),
             "labels": meta(TRAIN_BATCH, TRAIN_SEQ)}),
        f32["step_ms"], f32["bound_ms"])
    prefill, _ = make_prefill_step(model, None, "prefill_32k",
                                   param_dtype=torch.float32)
    decode, _ = make_decode_step(model, None, "decode_32k",
                                 param_dtype=torch.float32)
    for t in lm["timing"]:
        p, g = t["prompt"], t["gen"]
        with torch.inference_mode():
            pre = analyze_step(prefill, params,
                               {"tokens": meta(LM_BATCH, p)})
            dec = analyze_step(decode, params,
                               shapes.cache_structs(model, LM_BATCH, p + g),
                               meta(LM_BATCH, 1), p)
        out[f"prefill_{p}"] = row(f"prefill b={LM_BATCH} prompt={p}", pre,
                                  t["prefill_ms"], t["prefill_bound_ms"])
        out[f"decode_{p}_{g}"] = row(
            f"decode step b={LM_BATCH} at {p} of {p + g}", dec,
            t["decode_ms_per_step"], t["decode_bound_ms"])
    rcfg = radon_config()
    design = k1_forward["design"]
    k1 = {}
    for d, m in sorted(k1_forward["by_directions_per_block"].items()):
        c = h100_strip_cost(rcfg.n, rcfg.batch, 4, d, design["stage_rows"],
                            design["ring_slots"])
        k1[d] = {"predicted_ms": c.ms, "bound_by": c.bound_by,
                 "hbm_ms": c.hbm_ms, "add_ms": c.add_ms,
                 "load_ms": c.load_ms, "tail": c.tail, "waves": c.waves,
                 "blocks": c.blocks, "per_sm": c.per_sm,
                 "smem_bytes": c.smem_bytes, "measured_ms": m["ms"]}
        log(f"cost K1 forward strip model at N={rcfg.n} B={rcfg.batch} "
            f"D={d}: predicted {c.ms:.4f} ms ({c.bound_by}; HBM "
            f"{c.hbm_ms:.4f}, adds {c.add_ms:.4f}, shared loads "
            f"{c.load_ms:.4f}; {c.blocks} blocks, {c.per_sm} per SM, "
            f"{c.waves:.2f} waves, tail x{c.tail:.3f}); measured "
            f"{m['ms']:.4f} ms")
    out["k1_strip_model"] = k1
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# slice 13: tensor parallelism and the production-mesh dry run
# ---------------------------------------------------------------------------
TP_DEVICE = "cuda"
TP_TIMING_REPS = 3
#: the (1, 1) and (1, 2) steps against the one-process step: the loss
#: (relative), every first and second moment (of its leaf's peak), and
#: every parameter against the plain AdamW update from the step's own
#: moments (of its leaf's peak) -- ``tests/test_torch_lm_train.py``'s
#: LOSS_REL and GRAD_REL.  The parameters are not held against the
#: one-process step's: AdamW's first update, g / (|g| + eps), turns the
#: float32 noise of a gradient near eps (1e-8) into an O(1) difference.
TP_LOSS_REL, TP_GRAD_REL = 1e-5, 1e-4
#: the steps' base rate: ``make_train_step`` warms up over 100 steps, so
#: the first runs at TP_FIRST_LR = 1e-2, which moves every leaf of
#: tinyllama by more than TP_MOVED of its peak: the parameter check
#: separates an unchanged state from the update
TP_LR = 1.0
TP_FIRST_LR = TP_LR / 100
TP_MOVED = 10 * TP_GRAD_REL
#: the Trainer check's rate and warmup: 1e-2 and 2e-2 at its two steps
TP_TRAINER_LR, TP_TRAINER_WARMUP = 0.1, 10
#: the wall-clock limit of the (1, 2) step's two processes
TP_CHILD_TIMEOUT_S = 300
#: dry-run cells counted on the 16 x 16 production mesh (256 fake ranks)
TP_DRYRUN_CELLS = (("qwen3_0_6b", "decode_32k"),
                   ("tinyllama_1_1b", "train_4k"))


def tp_step_inputs(cfg, dev):
    """The model, its float32 parameters from seed 0 drawn on ``dev``, and
    batch 0 of the token stream (TRAIN_BATCH x TRAIN_SEQ) on ``dev``."""
    import torch
    from repro_torch.data import TokenStream, shard_batch
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import init_params
    model = Model(cfg)
    params = init_params(model.specs(), 0, torch.float32, dev)
    batch = shard_batch(TokenStream(cfg.vocab_size, TRAIN_SEQ,
                                    TRAIN_BATCH).batch(0), None, dev)
    return model, params, batch


def tp_clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def tp_rels(got: dict, want: dict) -> list:
    """Each leaf's largest difference over that leaf's peak in ``want``,
    of two trees of the same leaves (or of shards against their wholes'
    slices, ``want`` already sliced)."""
    from repro_torch.tree import tree_items
    rels = []
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        if tuple(g.shape) != tuple(w.shape):
            raise ValueError(f"{'/'.join(path)}: {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
        scale = float(w.detach().abs().max()) + 1e-30
        rels.append(float((g.detach() - w.detach()).abs().max()) / scale)
    return rels


def tp_worst(got: dict, want: dict) -> float:
    return max(tp_rels(got, want))


def tp_moved(before: dict, after: dict, label: str) -> float:
    """The least change of a leaf in a step, over its peak: each must be
    at least TP_MOVED, so that a check within TP_GRAD_REL fails for a
    state the step left unchanged."""
    least = min(tp_rels(before, after))
    if least < TP_MOVED:
        fail(f"tp: {label}: a leaf moved only {least:.2e} of its peak, "
             f"under {TP_MOVED}: the parameter check could not tell an "
             f"unchanged state")
    return least


def tp_plain_update(before, mu, nu, lr: float):
    """The parameters after AdamW's first step from ``before`` with the
    step's moments ``mu`` and ``nu`` at rate ``lr``: plain float32, the
    bias corrections of step 1 and ``AdamWConfig``'s b1, b2, eps and
    decay."""
    import torch
    from repro_torch.tree import tree_map
    b1, b2, eps, decay = 0.9, 0.95, 1e-8, 0.1
    return tree_map(
        lambda p, m, v: p - lr * ((m / (1 - b1))
                                  / (torch.sqrt(v / (1 - b2)) + eps)
                                  + decay * p), before, mu, nu)


def tp_step_rels(loss: float, before, params, opt, want: dict) -> dict:
    """A step's loss against the one-process step's (relative), its
    moments against the one-process step's and its parameters against
    the plain update from ``before`` with its own moments (of each
    leaf's peak)."""
    return {"loss": loss,
            "loss_rel": abs(loss - want["loss"]) / abs(want["loss"]),
            "mu_rel": tp_worst(opt["mu"], want["mu"]),
            "nu_rel": tp_worst(opt["nu"], want["nu"]),
            "update_rel": tp_worst(params, tp_plain_update(
                before, opt["mu"], opt["nu"], TP_FIRST_LR))}


def tp_gate(label: str, rels: dict) -> dict:
    if rels["loss_rel"] > TP_LOSS_REL or max(
            rels["mu_rel"], rels["nu_rel"], rels["update_rel"]) > TP_GRAD_REL:
        fail(f"tp: {label}: {json.dumps(rels)} (bounds {TP_LOSS_REL} "
             f"for the loss, {TP_GRAD_REL} for the moments and the "
             f"update)")
    return rels


def tp_timed(fn, params, opt, batch, dev) -> float:
    """Median ms of TP_TIMING_REPS steps after one warm step (CUDA
    events on the card); each step updates ``params`` / ``opt`` in
    place."""
    import torch

    def step():
        fn(params, opt, batch)

    if torch.device(dev).type == "cuda":
        return cuda_ms(step, reps=TP_TIMING_REPS, warm=1)
    step()
    times = []
    for _ in range(TP_TIMING_REPS):
        t0 = time.perf_counter()
        step()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def tp_child(rank: int, world: int, port: int, cfg, dev: str,
             out_dir: str) -> None:
    """One of the (1, 2) step's two processes on the one card, over gloo
    with CUDA tensors: the one-process step on the same weights and batch
    first (its want), then the tensor-parallel step on this rank's
    shards, checked against the slices of the want; then the step timed.
    Any error fails the rank, and so the run; the rank reports its K1-K5
    launches since its start."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import param_shardings, shard_params
    from repro_torch.tree import tree_map
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(0)
    reset_dprt_kernel_launches()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        model, params, batch = tp_step_inputs(cfg, dev)
        one, _ = make_train_step(model, None, "train_4k", lr=TP_LR,
                                 param_dtype=torch.float32)
        p = tp_clone(params)
        opt = adamw_init(p)
        p, opt, m = one(p, opt, batch)
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        spec = param_shardings(model.specs(), mesh)
        want = {"loss": float(m["loss"]),
                "mu": tree_map(lambda t: t.clone(),
                               shard_params(opt["mu"], spec, mesh)),
                "nu": tree_map(lambda t: t.clone(),
                               shard_params(opt["nu"], spec, mesh))}
        del p, opt, m, one
        local = tree_map(lambda t: t.clone(),
                         shard_params(params, spec, mesh))
        del params
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        fn, _ = make_train_step(model, mesh, "train_4k", lr=TP_LR,
                                param_dtype=torch.float32)
        lopt = adamw_init(local)
        before = tp_clone(local)
        local, lopt, m = fn(local, lopt, batch)
        out["check"] = tp_step_rels(float(m["loss"]), before, local, lopt,
                                    want)
        del before, want
        out["step_ms"] = tp_timed(fn, local, lopt, batch, dev)
        if torch.device(dev).type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["dprt_launches"] = dprt_kernel_launches()
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def tp_two_ranks(cfg, dev) -> dict:
    """Spawn the (1, 2) step's two processes (``tp_child``) under
    TP_CHILD_TIMEOUT_S and read their reports."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="repro_tp_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.spawn(tp_child, args=(2, port, cfg, dev, out_dir), nprocs=2,
                   join=False)
    deadline = time.monotonic() + TP_CHILD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                fail(f"tp: the (1, 2) step's two processes did not finish "
                     f"within {TP_CHILD_TIMEOUT_S} s")
    except Exception as e:                 # a rank raised
        fail(f"tp: a (1, 2) rank failed: {type(e).__name__}: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    reports = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
               for r in range(2)]
    return {"ranks": reports, "wall_s": time.perf_counter() - t0}


def tp_trainer_check(cut, dev) -> dict:
    """Two ``Trainer`` steps at the cut depth on a (1, 1) mesh against no
    mesh: the same losses and parameters, at a rate that moves every
    leaf by at least TP_MOVED of its peak."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import Trainer, TrainerConfig
    root = Path(tempfile.mkdtemp(prefix="repro_tp_trainer_"))
    outs = {}
    for name, mesh in (("none", None), ("mesh", make_local_mesh(1, 1))):
        tcfg = TrainerConfig(batch_size=TRAIN_CHECK_B, seq_len=TRAIN_CHECK_S,
                             steps=2, ckpt_every=100, log_every=1,
                             lr=TP_TRAINER_LR, warmup=TP_TRAINER_WARMUP,
                             ckpt_dir=str(root / name), device=dev)
        trainer = Trainer(cut, tcfg, mesh=mesh)
        if mesh is None:
            before = trainer.init_state()[0]
        outs[name] = trainer.run()
    shutil.rmtree(root)
    moved = tp_moved(before, outs["none"]["params"], "Trainer, no mesh")
    losses = {k: [m["loss"] for m in v["log"]] for k, v in outs.items()}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                         losses["none"]))
    p_rel = tp_worst(outs["mesh"]["params"], outs["none"]["params"])
    if loss_rel > TP_LOSS_REL or p_rel > TP_GRAD_REL:
        fail(f"tp: Trainer on a (1, 1) mesh: losses {loss_rel:.2e} / "
             f"parameters {p_rel:.2e} from no mesh")
    return {"layers": cut.num_layers, "losses": losses["mesh"],
            "loss_rel": loss_rel, "param_rel": p_rel, "moved_min": moved}


def tp_phase() -> dict:
    """Tensor parallelism on the card, tinyllama-1.1b at full width: the
    float32 train step (TRAIN_BATCH x TRAIN_SEQ) through
    ``make_train_step`` on a (1, 1) NCCL mesh equal to the step with no
    mesh on the same weights and batch, both timed; two ``Trainer``
    steps at the cut depth on the (1, 1) mesh against no mesh; then the
    (1, 2) step as two processes on the one card over gloo with CUDA
    tensors against the one-process step; no K1-K5 launch here or in
    either rank."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (close_world, init_world,
                                         mesh_device_type)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    dev = torch.device(TP_DEVICE)
    t_phase = time.perf_counter()
    reset_dprt_kernel_launches()
    cfg = get_config(LM_ARCH)
    model, params, batch = tp_step_inputs(cfg, dev)
    one, _ = make_train_step(model, None, "train_4k", lr=TP_LR,
                             param_dtype=torch.float32)
    p = tp_clone(params)
    opt = adamw_init(p)
    p, opt, m = one(p, opt, batch)
    want = {"loss": float(m["loss"]), "mu": opt["mu"], "nu": opt["nu"]}
    moved = tp_moved(params, p, "the one-process step")
    one_rel = tp_worst(p, tp_plain_update(params, opt["mu"], opt["nu"],
                                          TP_FIRST_LR))
    if one_rel > TP_GRAD_REL:
        fail(f"tp: the one-process step is {one_rel:.2e} from the plain "
             f"update of its own moments")
    init_world(TP_DEVICE)
    try:
        mesh = init_device_mesh(mesh_device_type(), (1, 1),
                                mesh_dim_names=("data", "model"))
        fn, _ = make_train_step(model, mesh, "train_4k", lr=TP_LR,
                                param_dtype=torch.float32)
        q = tp_clone(params)
        qopt = adamw_init(q)
        q, qopt, qm = fn(q, qopt, batch)
        mesh11 = tp_gate("(1, 1) NCCL mesh", tp_step_rels(
            float(qm["loss"]), params, q, qopt, want))
        mesh11["backend"] = torch.distributed.get_backend()
        mesh11.update(moved_min=moved, one_process_update_rel=one_rel)
        mesh11["step_ms"] = tp_timed(fn, q, qopt, batch, dev)
        del q, qopt, qm
        none_ms = tp_timed(one, p, opt, batch, dev)
        trainer = tp_trainer_check(lm_cut(cfg), dev)
    finally:
        close_world()
    del params, p, opt, m, want, one, fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"tp: {cfg.name} float32 step {TRAIN_BATCH}x{TRAIN_SEQ}: no mesh "
        f"{none_ms:.3f} ms, (1, 1) {mesh11['backend']} mesh "
        f"{mesh11['step_ms']:.3f} ms, equal within {json.dumps(mesh11)}; "
        f"Trainer (1, 1) vs none at {trainer['layers']} layers "
        f"{json.dumps(trainer)}")
    two = tp_two_ranks(cfg, TP_DEVICE)
    checks = [r["check"] for r in two["ranks"]]
    worst = tp_gate("the (1, 2) step", {
        k: max(c[k] for c in checks)
        for k in ("loss_rel", "mu_rel", "nu_rel", "update_rel")})
    mesh12 = dict(worst, step_ms=[r["step_ms"] for r in two["ranks"]],
                  peak_mem_bytes=[r.get("peak_mem_bytes")
                                  for r in two["ranks"]],
                  dprt_launches=[r["dprt_launches"] for r in two["ranks"]],
                  wall_s=two["wall_s"])
    log(f"tp: (1, 2) over gloo, two processes on the one card: step "
        f"{mesh12['step_ms']} ms by rank, equal to the one-process step "
        f"within {json.dumps(worst)}")
    launches = dprt_kernel_launches() + sum(mesh12["dprt_launches"])
    if launches:
        fail(f"the tensor-parallel path launched {launches} of K1-K5 "
             f"(this process and the ranks {mesh12['dprt_launches']})")
    log("tp: K1-K5 launches 0 (this process and both ranks)")
    return {"arch": LM_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "none_step_ms": none_ms, "mesh_1x1": mesh11,
            "trainer_1x1": trainer, "mesh_1x2": mesh12,
            "dprt_launches": launches, "card": nvidia_smi_line(),
            "phase_s": time.perf_counter() - t_phase}


def dryrun_phase(tp: dict) -> dict:
    """``launch.dryrun.run_cell`` for TP_DRYRUN_CELLS on the 16 x 16
    production mesh (256 fake ranks, rank 0's structs): counts and
    roofline predictions for a hypothetical mesh of 256 H100s, printed
    beside this run's measured one-card step (a different size: not a
    comparison)."""
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    out = {}
    for arch, shape in TP_DRYRUN_CELLS:
        r = run_cell(arch, shape, multi_pod=False, outdir="")
        if r["status"] != "ok":
            fail(f"dryrun {arch} {shape}: {r['status']} "
                 f"{r.get('error', r.get('reason'))}")
        t = r["roofline"]
        row = {"mesh": r["mesh"], "chips": r["chips"],
               "flops_per_dev": r["flops_per_dev"],
               "bytes_per_dev": r["bytes_per_dev"],
               "coll_bytes_per_dev": r["collectives"]["total"],
               "collectives": r["collectives"]["by_class"],
               "compute_s": t["compute_s"], "memory_s": t["memory_s"],
               "collective_s": t["collective_s"], "dominant": t["dominant"],
               "step_s_lower_bound": t["step_s_lower_bound"],
               "count_s": r["compile_s"]}
        out[f"{arch}:{shape}"] = row
        log(f"dryrun {arch} {shape} on {r['mesh']} (counted, predicted for "
            f"{r['chips']} H100s, not measured): {row['flops_per_dev']:.4e} "
            f"flop, {row['bytes_per_dev']:.4e} B, "
            f"{row['coll_bytes_per_dev']:.4e} B all-reduced per device -> "
            f"{row['step_s_lower_bound']:.4e} s ({row['dominant']}); this "
            f"run's measured {LM_ARCH} float32 step at {TRAIN_BATCH}x"
            f"{TRAIN_SEQ} on one card: {tp['none_step_ms']:.3f} ms")
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir() or not HW:
        fail(f"no port sources under {SRC}: run from a checkout")
    if sys.argv[1:2] == ["--serve-restart-child"]:
        return restart_child(sys.argv[2], sys.argv[3])
    from repro_torch.launch.mesh import close_world
    card = nvidia_smi_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_phase()
    worst = kernel_phase()
    pipe_worst = pipeline_kernel_phase()
    stream_worst = stream_kernel_phase()
    tail_worst = tail_kernel_phase()
    launches = main_path_phase()
    pipe_launches = pipeline_main_path_phase()
    giant_launches = giant_main_path_phase()
    mesh_launches = mesh_main_path_phase()
    four_shards_phase()
    solve_info = solve_main_path_phase()
    serving = {"service": serving_phase(), "restart": warm_restart_phase(),
               "router_chaos": router_chaos_phase(), "pool": pool_phase(),
               "mesh_service": mesh_service_phase()}
    kernels = timing_phase(launches, worst,
                           pipe_launches["k1"]["forward"])
    kernels += pipeline_timing_phase(pipe_launches, pipe_worst)
    kernels += stream_timing_phase(giant_launches, stream_worst)
    kernels += narrow_inverse_phase(giant_launches)
    kernels += tail_timing_phase(mesh_launches, tail_worst)
    kernels += solve_timing_phase(solve_info)
    mark_mesh_service_launches(kernels, serving["mesh_service"])
    pipeline_profile_phase()
    pipeline_profile_phase(mesh=True)
    close_world()
    lm = lm_phase()
    trained = train_phase()
    cost = cost_phase(lm, trained, kernels[0])
    tp = tp_phase()
    tp["dryrun"] = dryrun_phase(tp)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"cost": cost}), flush=True)
    print(json.dumps({"tp": tp}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
