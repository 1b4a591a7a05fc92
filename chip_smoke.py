#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # on a machine with one CUDA card

Builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` with nvcc, holds every kernel of the main path against its plain
PyTorch version on the card, drives the main path (the exact forward
and inverse DPRT of the ``radon_251`` configuration: 256 phantom images
of 251 x 251, int32) through ``repro_torch.radon.DPRT`` and through
``python -m repro_torch.launch.serve --mode radon``, checks that it ran
through the kernel (launch counts) without rebuilding anything in the
timed loop, and times each kernel mode against its bound.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a machine without a CUDA card, or a directory that
holds this script without the port's sources.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32 adds/s --
#: 132 SMs x 64 INT32 lanes x 1.98 GHz, half the 33.5e12 lane-ops/s
#: behind the 67 TFLOP/s float32 figure (which counts an FMA as two).
HBM_BYTES_PER_S = 3.35e12
INT32_ADDS_PER_S = 16.75e12

SERVE_ITERS = 5
TIMING_REPS = 20
F32_RTOL = 1e-5


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


def check_close(name: str, got, want, n: int) -> float:
    """Bit-exact for integers; float32 within rtol 1e-5, atol 1e-4*N
    (summation order differs); float64 within 1e-12 relative."""
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


def kernel_phase() -> dict:
    """K1 against its plain version: every mode, sign +-1, awkward blocks,
    batch 1 and 3, int32/int64 bit-exact, float32/float64 within
    tolerance, a nonzero row_offset, and the inverse on non-transform
    inputs with negatives."""
    import numpy as np
    import torch
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels.tuning import pallas_block_spec

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
    log(f"kernel phase: {cases} cases agree with the plain version "
        f"(max |err| by mode: {worst})")
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


def timing_phase(launches: dict, worst: dict) -> list:
    """Kernel vs plain version at the main path's shapes, per mode."""
    import numpy as np
    import torch
    from repro_torch.configs.radon_251 import config
    from repro_torch.data.synthetic import radon_images
    from repro_torch.kernels import sfdprt as S
    from repro_torch.kernels.tuning import pallas_block_spec

    cfg = config()
    n, b = cfg.n, cfg.batch
    h, mb = pallas_block_spec(n)
    dev = torch.device("cuda")
    f = torch.from_numpy(radon_images(n, b, kind="phantom")).to(dev)
    r = S.dprt_raw(f, strip_rows=h, m_block=mb)
    corr = (r[:, n, :] - r[:, 0, :].sum(1, keepdim=True,
                                        dtype=torch.int32)).contiguous()
    w = torch.from_numpy(np.random.default_rng(2).integers(
        -1000, 1000, (b, n, n)).astype(np.int32)).to(dev)
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
    }
    rows = []
    for mode, (x, kw, nbytes, ops) in cases.items():
        k_ms = cuda_ms(lambda: S.sfdprt(x, strip_rows=h, m_block=mb, **kw))
        p_ms = cuda_ms(lambda: S.sfdprt_plain(x, **kw), reps=5, warm=1)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / INT32_ADDS_PER_S
        rows.append({
            "name": f"sfdprt_kernel[{mode}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfdprt.cu",
            "replaces": "src/repro/kernels/sfdprt.py:210",
            "launches": launches[mode],
            "max_abs_err": worst.get(mode, 0.0),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
        log(f"timing {mode}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({rows[-1]['bound_by']}; N={n} B={b} int32 H={h} M={mb})")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no port sources under {SRC}: run from a checkout")
    sys.path.insert(0, str(SRC))
    card = nvidia_smi_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_phase()
    worst = kernel_phase()
    launches = main_path_phase()
    kernels = timing_phase(launches, worst)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
