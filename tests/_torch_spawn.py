"""Spawned ranks under a wall-clock limit, for the port's tests.

``spawn_with_deadline`` is ``torch.multiprocessing.spawn`` with
``join=False``, joined until a deadline: a rank's exception re-raises in
the test, a rank still running at the deadline fails it, and every
process still alive at the end is killed and joined, so no test leaves
ranks behind.
"""
import time

import pytest


def spawn_with_deadline(fn, nprocs: int, args: tuple, timeout: float):
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait at
    most ``timeout`` seconds for all of them; returns the processes."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{nprocs} ranks did not finish within "
                            f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return ctx.processes
