"""The port answers to the reference's legacy and kernel names.

* The per-call-kwarg shims ``dprt`` / ``idprt`` / ``dprt_batched`` /
  ``idprt_batched`` of ``repro_torch.core`` against ``repro.core``'s on
  the same numpy inputs (integers bit for bit), with the one
  ``DeprecationWarning`` per process pointed at the caller, as the
  reference does.  The warning names the port's modules where the
  reference names its own.
* Every name in ``repro.kernels.__all__`` is in ``repro_torch.kernels``
  or on ROADMAP.md's "What does not carry over" list, and the
  reference's ``*_pallas`` / ``*_pallas_raw`` names give the ``*_cuda``
  / ``*_raw`` results (the TPU-only ``interpret`` / ``step_impl``
  arguments change nothing).
"""
import importlib
import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as RC
import repro.kernels as RK
import repro_torch.core as TC
import repro_torch.kernels as TK
from repro_torch.kernels import sfdprt as TS

# each package's core re-exports a callable named dprt over its submodule
RD = importlib.import_module("repro.core.dprt")
TD = importlib.import_module("repro_torch.core.dprt")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: reference kernel names that are TPU layout devices, listed in
#: ROADMAP.md under "What does not carry over"
NOT_CARRIED = ("roll_rows_ladder_spec",)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-50, 200, shape).astype(
        np.int32)


# (shim, input shape, knobs): the legacy default (horner), explicit
# methods, the block knobs and a batched stack
SHIM_CASES = [
    ("dprt", (7, 7), {}),
    ("dprt", (5, 7), {"method": "gather"}),
    ("dprt", (3, 11, 11), {"method": "horner", "batch_impl": "map"}),
    ("dprt", (13, 13), {"method": "strips", "strip_rows": 4}),
    ("idprt", (8, 7), {}),
    ("idprt", (2, 12, 11), {"method": "gather"}),
    ("dprt_batched", (3, 7, 7), {"block_batch": 2}),
    ("idprt_batched", (3, 8, 7), {"method": "horner"}),
]


@pytest.mark.parametrize("name,shape,knobs", SHIM_CASES,
                         ids=lambda v: str(v))
def test_legacy_shims_match_the_reference(name, shape, knobs):
    x = _ints(shape, sum(shape))
    if name.startswith("idprt"):
        n = shape[-1]
        f = _ints(shape[:-2] + (n, n), n)
        x = np.array(RC.dprt(jnp.asarray(f), method="gather"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(getattr(RC, name)(jnp.asarray(x), **knobs))
        got = getattr(TC, name)(torch.from_numpy(x), **knobs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_legacy_shims_warn_once_at_the_caller():
    x = _ints((7, 7), 1)
    seen = {}
    for mod, pkg, arr in ((RD, RC, jnp.asarray(x)),
                          (TD, TC, torch.from_numpy(x))):
        mod._LEGACY_KNOB_WARNED = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pkg.dprt(arr)                        # no knob: no warning
            r = pkg.dprt_batched(arr[None], method="gather")
            pkg.idprt(r[0], method="gather")
        dep = [w for w in caught if w.category is DeprecationWarning]
        assert len(dep) == 1
        assert dep[0].filename == __file__
        seen[mod.__name__] = str(dep[0].message)
    assert seen["repro_torch.core.dprt"].replace("repro_torch.", "repro.") \
        == seen["repro.core.dprt"]
    # the port's core.dprt is still the module, and calls as the shim
    assert TC.dprt is TD and TD.accum_dtype_for is not None
    np.testing.assert_array_equal(TC.dprt(torch.from_numpy(x)).numpy(),
                                  np.asarray(RC.dprt(jnp.asarray(x))))
    with pytest.raises(ValueError, match="prime"):
        TC.idprt(torch.zeros((9, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        TC.dprt_batched(torch.zeros((7, 7), dtype=torch.int32))


def _roadmap_not_carried() -> str:
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    start = text.index("**What does not carry over.**")
    return text[start:text.index("\n\n", start + 40)]


@pytest.mark.parametrize("name", RK.__all__)
def test_reference_kernel_names_carry_over(name):
    if name in NOT_CARRIED:
        assert f"`{name}`" in _roadmap_not_carried()
        assert not hasattr(TK, name)
    else:
        assert name in TK.__all__ and hasattr(TK, name)


@pytest.mark.parametrize("name,args,kwargs,cuda", [
    ("dprt_pallas", ((5, 5),), {"interpret": True}, "dprt_cuda"),
    ("idprt_pallas", ((6, 5),), {"interpret": True}, "idprt_cuda"),
    ("skew_sum_pallas", ((2, 7, 7), -1), {"interpret": None},
     "skew_sum_cuda"),
    ("skew_sum_pallas_strip", ((3, 7),), {"row_offset": 2},
     "skew_sum_cuda_strip"),
    ("dprt_pallas_strip", ((3, 7),), {"row_offset": 4}, "dprt_cuda_strip"),
    ("projection_pipeline_pallas", ((2, 7, 7), "mul", (8, 7)),
     {"interpret": True}, "projection_pipeline_cuda"),
    ("pipeline_tail_pallas", ((2, 4, 7), "mul", (8, 7)),
     {"row_offset": 3}, "pipeline_tail_cuda"),
])
def test_pallas_names_give_the_cuda_results(name, args, kwargs, cuda):
    ts = [torch.from_numpy(_ints(a, len(a))) if isinstance(a, tuple) else a
          for a in args]
    got = getattr(TK.ops, name)(*ts, **kwargs)
    kw = {k: v for k, v in kwargs.items() if k != "interpret"}
    want = getattr(TK.ops, cuda)(*ts, **kw)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert torch.equal(g, w)


def test_pallas_raw_names_give_the_raw_results():
    f = torch.from_numpy(_ints((2, 7, 7), 3))
    r = TS.dprt_raw(f)
    assert torch.equal(TS.dprt_pallas_raw(f, interpret=False,
                                          step_impl="permute"), r)
    assert torch.equal(TS.idprt_pallas_raw(r, interpret=True),
                       TS.idprt_raw(r))
    assert torch.equal(TS.skew_sum_pallas_raw(f, -1, row_offset=2),
                       TS.skew_sum_raw(f, -1, row_offset=2))
    from repro_torch.kernels import pipeline as P
    w = torch.from_numpy(_ints((1, 8, 7), 4))
    for got, want in zip(TS.pipeline_pallas_raw(f, w, op="mul"),
                         P.pipeline_raw(f, w, op="mul")):
        assert torch.equal(got, want)
    rows = r[:, 2:5].contiguous()
    for got, want in zip(TS.pipeline_pallas_raw(rows, w, op="mul",
                                                source="proj", defer=True,
                                                row_offset=2, n_rows=7),
                         P.pipeline_tail_raw(rows, w, op="mul",
                                             row_offset=2)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="source"):
        TS.pipeline_pallas_raw(f, op="none", defer=True)
