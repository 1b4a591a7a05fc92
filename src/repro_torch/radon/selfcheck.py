"""API health smoke of the port: ``python -m repro_torch.radon.selfcheck``.

The port of :mod:`repro.radon.selfcheck`.  One plan per registered
non-mesh backend is round-tripped bit-exactly and its gradient checked
against the explicit adjoint; the mesh-aware ``sharded_cuda`` backend
(the reference's ``sharded_pallas``) is round-tripped on a one-rank
``("model",)`` mesh; the fused conv pipeline must equal the staged one
and be the identity for a delta kernel; the reconstruction gate holds
the Sherman-Morrison solve to the exact inverse and masked-direction CG
to a dense least-squares oracle; a retrace guard verifies that a warm
geometry builds nothing; and one operator is compiled (``op.compile``)
and must serve the same bits.

Runs on ``--device`` (default ``cuda``, which raises without a card;
``cpu`` runs the kernels' plain versions and the mesh over gloo).  A
process group it had to open is closed again.  The reference's
``--bench`` perf guard has no counterpart in the port.  Exit code 0 ==
healthy.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["run", "main"]

_N = 13  # small prime: quick on the CPU, still exercises blocks


def _check(label: str, ok: bool, detail: str = "") -> bool:
    print(f"[selfcheck] {'ok  ' if ok else 'FAIL'} {label}"
          + (f" ({detail})" if detail else ""))
    return ok


def _grad_matches_adjoint(op, x: torch.Tensor) -> bool:
    x = x.clone().requires_grad_(True)
    op(x).sum().backward()
    want = op.T(torch.ones(op.shape_out, dtype=x.dtype, device=x.device))
    return bool(torch.equal(x.grad, want))


def _mesh_checks(img_i, img_f, kern, device) -> bool:
    """``sharded_cuda`` on a one-rank mesh: ``auto`` resolves to it, the
    round trip is exact, the gradient is the adjoint, and the fused conv
    pipeline equals the staged one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.conv import circ_conv2d_dprt
    from ..launch.mesh import close_world, init_world, mesh_device_type
    from . import DPRT, config
    opened = not dist.is_initialized()
    init_world(device.type)
    try:
        if dist.get_world_size() != 1:
            print("[selfcheck] skip sharded_cuda (a process group of "
                  f"{dist.get_world_size()} ranks is open)")
            return True
        mesh = init_device_mesh(mesh_device_type(), (1,),
                                mesh_dim_names=("model",))
        ops = DPRT(img_i.shape, img_i.dtype, method="auto", mesh=mesh)
        ok = _check("sharded_cuda: auto resolves under a mesh",
                    ops.plan.method == "sharded_cuda",
                    f"plan method={ops.plan.method}")
        ok &= _check("sharded_cuda: round trip bit-exact",
                     bool(torch.equal(ops.inverse(ops(img_i)), img_i)),
                     "world size 1")
        opf = DPRT(img_f.shape, img_f.dtype, method="auto", mesh=mesh)
        ok &= _check("sharded_cuda: grad == explicit adjoint",
                     _grad_matches_adjoint(opf, img_f))
        with config(mesh=mesh):
            fused = circ_conv2d_dprt(img_i, kern, method="sharded_cuda")
            staged = circ_conv2d_dprt(img_i, kern, method="sharded_cuda",
                                      fuse=False)
        ok &= _check("sharded_cuda: fused conv pipeline == staged",
                     bool(torch.equal(fused, staged)))
        return ok
    finally:
        if opened:
            close_world()


def run(device="cuda") -> int:
    """Run the API health checks on ``device``; returns an exit code."""
    from ..core.conv import circ_conv2d_dprt
    from ..core.plan import available_backends, get_backend
    from ..launch.service import resolve_device
    from . import (DPRT, MaskedDPRT, config, direction_mask, retrace_guard,
                   solve)

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    img_i = torch.from_numpy(
        rng.integers(0, 256, (_N, _N)).astype(np.int32)).to(device)
    img_f = img_i.to(torch.float32)
    kern = torch.from_numpy(
        rng.integers(0, 16, (_N, _N)).astype(np.int32)).to(device)
    ok = _mesh_checks(img_i, img_f, kern, device)

    for name in available_backends():
        be = get_backend(name)
        if be.mesh_aware:
            continue  # needs a mesh; handled above
        op = DPRT(img_i.shape, img_i.dtype, method=name)
        ok &= _check(f"{name}: round trip bit-exact",
                     bool(torch.equal(op.inverse(op(img_i)), img_i)),
                     f"plan method={op.plan.method}")
        if be.supports_dtype(torch.float32):
            opf = DPRT(img_f.shape, img_f.dtype, method=name)
            ok &= _check(f"{name}: grad == explicit adjoint",
                         _grad_matches_adjoint(opf, img_f))

    # fused projection pipeline: fused == staged bit-exactly, and the
    # delta kernel's convolution pipeline is the identity
    delta = torch.zeros((_N, _N), dtype=torch.int32, device=device)
    delta[0, 0] = 1
    for name in available_backends():
        be = get_backend(name)
        if be.pipeline is None or be.mesh_aware:
            continue
        fused = circ_conv2d_dprt(img_i, kern, method=name)
        staged = circ_conv2d_dprt(img_i, kern, method=name, fuse=False)
        ok &= _check(f"{name}: fused conv pipeline == staged (bit-exact)",
                     bool(torch.equal(fused, staged)))
        ok &= _check(f"{name}: delta-kernel conv pipeline is identity",
                     bool(torch.equal(circ_conv2d_dprt(img_i, delta,
                                                       method=name), img_i)))

    # reconstruction gate: the Sherman-Morrison fast path must match the
    # exact inverse (non-iteratively), and masked-direction CG must
    # recover the dense-oracle least-squares solution
    op = DPRT(img_i.shape, img_i.dtype)
    res = solve(op, op(img_i))
    ok &= _check("solve: unmasked Sherman-Morrison == exact inverse",
                 int(res.iterations) == 0
                 and np.allclose(res.image.cpu().numpy(),
                                 img_i.cpu().numpy(), atol=1e-3),
                 f"iterations={int(res.iterations)}")
    m = MaskedDPRT(op, mask=direction_mask(_N, [2, _N - 1], device=device))
    b = m(img_f)
    dense = m.as_matrix().double().cpu().numpy()
    oracle, *_ = np.linalg.lstsq(dense, b.double().cpu().numpy().ravel(),
                                 rcond=None)
    rec = solve(m, b, "cg", tol=1e-7, maxiter=200)
    scale = max(1.0, float(np.abs(oracle).max()))
    err = float(np.abs(rec.image.double().cpu().numpy().ravel()
                       - oracle).max())
    ok &= _check("solve: masked-direction CG == dense LS oracle",
                 err <= 1e-3 * scale,
                 f"max err={err:.2e}, iters={int(rec.iterations)}")

    # a warm geometry builds nothing, enforced
    op = DPRT(img_i.shape, img_i.dtype)
    op(img_i)  # first build happens outside the guard
    try:
        with retrace_guard(max_traces=0):
            for _ in range(3):
                op(img_i + 1)
        ok &= _check("steady state: zero rebuilds across repeated calls",
                     True)
    except Exception as e:  # RetraceError or anything a build raised
        ok &= _check("steady state: zero rebuilds across repeated calls",
                     False, repr(e))

    # the compiled executable serves the same bits
    exe = op.compile(device)
    ok &= _check("AOT compile serves the same bits",
                 bool(torch.equal(exe(img_i), op(img_i))))

    # ambient config reaches plan resolution
    with config(method="gather"):
        ok &= _check("ambient config resolves method",
                     DPRT((7, 7), torch.int32).plan.method == "gather")

    print(f"[selfcheck] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device to check on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    sys.exit(main())
