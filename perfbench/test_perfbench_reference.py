"""The benchmark's plain reference against a NumPy loop over the DPRT's
definition, and its narrower control against the exact sums."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent


def _module(kind, name):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_test_{kind}_{name}", HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _module("reference", "dprt")


def loop_forward(f):
    n = f.shape[0]
    r = np.zeros((n + 1, n), dtype=np.int64)
    for m in range(n):
        for d in range(n):
            r[m, d] = sum(int(f[i, (d + m * i) % n]) for i in range(n))
    for d in range(n):
        r[n, d] = sum(int(f[d, j]) for j in range(n))
    return r


def loop_inverse(r):
    n = r.shape[1]
    s = sum(int(v) for v in r[0])
    f = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            z = sum(int(r[m, (j - m * i) % n]) for m in range(n))
            num = z - s + int(r[n, i])
            assert num % n == 0
            f[i, j] = num // n
    return f


@pytest.mark.parametrize("acc", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [2, 3, 5, 7, 13, 31])
def test_reference_matches_the_definition(n, acc):
    g = torch.Generator().manual_seed(1000 + n)
    f = torch.randint(0, 256, (2, n, n), dtype=torch.uint8, generator=g)
    r = ref.forward(f, acc)
    back = ref.inverse(r, acc)
    assert r.dtype == acc and back.dtype == acc
    for b in range(2):
        want = loop_forward(f[b].numpy())
        np.testing.assert_array_equal(r[b].numpy(), want)
        np.testing.assert_array_equal(back[b].numpy(), loop_inverse(want))
        np.testing.assert_array_equal(back[b].numpy(), f[b].numpy())


def test_wrapped_sums_are_exact_while_the_outputs_fit():
    # pixels <= 9 at N = 13: every output fits in int8 (<= 117), while the
    # inverse's sums over 13 projections (<= 1521) wrap; modulo 2**8 they
    # still give every output exactly
    g = torch.Generator().manual_seed(7)
    f = torch.randint(0, 10, (2, 13, 13), dtype=torch.uint8, generator=g)
    r = ref.forward(f, torch.int8)
    assert torch.equal(r.to(torch.int64), ref.forward(f))
    assert torch.equal(ref.inverse(r, torch.int8).to(torch.int64),
                       f.to(torch.int64))


def test_the_control_breaks_exactness():
    # N = 131: a projection of 255s is 33405 > 32767, so int16 sums wrap
    cfg = {"control_accumulator": "int16"}
    f = torch.full((2, 131, 131), 255, dtype=torch.uint8)
    exact, control = ref.stages(cfg), ref.stages(cfg, control=True)
    rc = control["forward"](f)
    assert rc.dtype == torch.int16
    assert not torch.equal(rc.to(torch.int64), exact["forward"](f))
