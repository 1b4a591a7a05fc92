#!/usr/bin/env python3
"""Where a served request's time goes on the card.

    python3 scripts/chip_serve_profile.py [--n 251] [--requests 64]

For ``DPRTService`` (int32, max_batch 8: warm sizes 1, 2, 4, 8) on the
card, at radon_251's N by default:

* the host-clock stages of one ``execute()`` of a full batch of 8 on the
  ``forward`` datapath -- ``np.stack`` of the requests, the copy to the
  card, the executable, the copy back -- each the median of REPS runs
  ending in a synchronise; beside them the same copies from and to
  pinned host memory, K1's time by CUDA events, and ``execute()``
  whole;
* for each datapath, a coalesced pass of ``--requests`` requests
  (``run_requests``, best of PASSES) and a sequential pass (best of 3),
  then
  ``torch.profiler`` over one more coalesced pass: the device's busy
  share of the pass's wall, and device ms by kernel and copy;
* the pool's wire cost: the JSON encode and decode of one request frame
  and one response frame at this N, on the host.

Prints one ``PROFILE {json}`` line, then the card's name and power
limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
PASSES = 5
DATAPATHS = ("forward", "inverse", "roundtrip", "conv", "solve")


def host_ms(fn, reps: int = REPS) -> float:
    """Median host milliseconds of ``fn()`` followed by a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def service(datapath: str, n: int, dev):
    import numpy as np
    import torch
    from repro_torch import radon
    from repro_torch.launch.service import DPRTService
    kw = {}
    if datapath == "conv":
        kw["conv_kernel"] = torch.ones((3, 3), dtype=torch.int32)
    if datapath == "solve":
        missing = np.random.default_rng(0).choice(n + 1, 4, replace=False)
        kw.update(solve_mask=radon.direction_mask(n, missing, device=dev),
                  solver="cg", solve_tol=1e-6, solve_maxiter=100)
    return DPRTService((n, n), torch.int32, max_batch=8, datapath=datapath,
                       device=dev, **kw)


def requests(svc, datapath: str, n: int, count: int, dev) -> list:
    import torch
    from repro_torch import radon
    from repro_torch.data.synthetic import radon_images
    imgs = radon_images(n, count, kind="phantom")
    if datapath not in ("inverse", "solve"):
        return list(imgs)
    op = radon.DPRT((count, n, n), torch.int32, method="gather")
    x = torch.from_numpy(imgs).to(dev)
    if datapath == "inverse":
        return list(op(x).cpu().numpy())
    m = radon.MaskedDPRT(op, mask=svc._ops[1][0].masked.d)
    return list(m(x).cpu().numpy())


def device_profile(fn) -> dict:
    """Busy share of the wall and device ms by name over one ``fn()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (end - start)
    spans.sort()
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us if wall_us else None,
            "device_ms_by_name": {k[:60]: v / 1e3 for k, v in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=251)
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda")
    n, count = args.n, args.requests
    out = {"n": n, "requests": count, "max_batch": 8}

    # -- the stages of one execute() of a full forward batch -------------
    svc = service("forward", n, dev)
    svc.warmup()
    reqs = requests(svc, "forward", n, 8, dev)
    exe = svc._exes[8][0]
    stack = np.stack(reqs)
    x = torch.from_numpy(stack).to(dev)
    y = exe(x)
    pin_in = torch.empty(x.shape, dtype=x.dtype).pin_memory()
    pin_out = torch.empty(y.shape, dtype=y.dtype).pin_memory()
    pin_in.copy_(torch.from_numpy(stack))
    out["stages_ms"] = {
        "np_stack": host_ms(lambda: np.stack(reqs)),
        "h2d": host_ms(lambda: torch.from_numpy(stack).to(dev)),
        "h2d_pinned": host_ms(lambda: x.copy_(pin_in, non_blocking=True)),
        "executable": host_ms(lambda: exe(x)),
        "kernel_events": cuda_ms(lambda: exe(x)),
        "d2h": host_ms(lambda: y.cpu()),
        "d2h_pinned": host_ms(lambda: pin_out.copy_(y, non_blocking=True)),
        "execute": host_ms(lambda: svc.execute(stack)),
        "bytes_each_way": [stack.nbytes, int(y.numel() * y.element_size())],
    }

    # -- each datapath: coalesced vs sequential, and the device profile --
    out["datapaths"] = {}
    for dp in DATAPATHS:
        svc = service(dp, n, dev)
        svc.warmup()
        reqs = requests(svc, dp, n, count, dev)
        svc.run_sequential(reqs)
        seq = []
        for _ in range(3):
            t0 = time.perf_counter()
            svc.run_sequential(reqs)
            seq.append(time.perf_counter() - t0)
        svc.reset_metrics()
        svc.run_requests(reqs, repeats=PASSES)
        coal = min(svc.last_pass_walls)
        batches = svc.stats()["batches"] // PASSES
        prof = device_profile(lambda: svc.run_requests(reqs))
        out["datapaths"][dp] = {
            "sequential_imgs_per_s": count / min(seq),
            "coalesced_imgs_per_s": count / coal,
            "coalesced_pass_ms": 1e3 * coal,
            "batches_per_pass": batches,
            "profiled_pass": prof}
        print(f"{dp}: sequential {count / min(seq):.1f} img/s, coalesced "
              f"{count / coal:.1f} img/s ({batches} batches), profiled "
              f"pass {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['busy_share']:.3f}", flush=True)

    # -- the pool's frames: JSON of one request and one response ---------
    from repro_torch.launch.pool import read_frame, write_frame
    img = np.full((n, n), 200, np.int32)
    resp = np.full((n + 1, n), 50000, np.int32)

    def roundtrip(arr):
        buf = io.StringIO()
        write_frame(buf, {"op": "submit", "id": "r1", "n": n,
                          "data": arr.tolist()})
        buf.seek(0)
        return np.asarray(read_frame(buf)["data"], dtype=np.int32)
    out["frame_ms"] = {
        "request_encode_decode": host_ms(lambda: roundtrip(img), 5),
        "response_encode_decode": host_ms(lambda: roundtrip(resp), 5)}
    print("PROFILE " + json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
