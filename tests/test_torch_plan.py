"""The port's plan layer (``repro_torch.core.plan``) against the JAX
reference plans (``repro.core.plan``).

All four datapaths -- forward, inverse, adjoint, inverse_adjoint -- on
the same integer arrays through both packages, for square prime images,
a (3, N, N) stack and a non-prime (12, 10) geometry (embed and crop);
the reference runs ``method="horner"``, the port its ``cuda`` backend
(the kernel's plain version on these CPU tensors) and its ``horner``.
Integer results are bit-exact, including the floor division of the
inverse and inverse-adjoint on non-transform inputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as RP
from repro_torch.core import plan as TP

GEOMETRIES = [(5, 5), (13, 13), (3, 13, 13), (12, 10)]
KINDS = ("forward", "inverse", "adjoint", "inverse_adjoint")


def _input(plan, kind, seed):
    g = plan.geometry
    image_side = kind in ("forward", "inverse_adjoint")
    shape = g.image_shape if image_side else g.transform_shape
    lo = 0 if kind == "forward" else -500
    return np.random.default_rng(seed).integers(lo, 500, shape).astype(
        np.int32)


def _reference(shape, kind, x):
    plan = RP.get_plan(shape, jnp.int32, "horner")
    return np.asarray(getattr(plan, kind)(jnp.asarray(x)))


@pytest.mark.parametrize("shape", GEOMETRIES, ids=str)
def test_four_datapaths_match_reference(shape):
    port_plans = [TP.get_plan(shape, torch.int32),             # cuda
                  TP.get_plan(shape, torch.int32, "horner")]
    assert port_plans[0].method == "cuda"
    for k, kind in enumerate(KINDS):
        x = _input(port_plans[0], kind, seed=hash((shape, kind)) % 997)
        want = _reference(shape, kind, x)
        for plan in port_plans:
            got = getattr(plan, kind)(torch.from_numpy(x))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{plan.method} {kind}")


@pytest.mark.parametrize("shape", [(12, 10), (3, 13, 13)], ids=str)
def test_round_trip_and_adjoint_identity(shape):
    plan = TP.get_plan(shape, torch.int32)
    f = torch.from_numpy(_input(plan, "forward", seed=2))
    assert torch.equal(plan.inverse(plan.forward(f)), f)
    # <A f, r> == <f, A^T r> (float64: exact here)
    r = torch.from_numpy(_input(plan, "adjoint", seed=3)).double()
    fp = TP.get_plan(shape, torch.float64)
    lhs = (fp.forward(f.double()) * r).sum()
    rhs = (f.double() * fp.adjoint(r)).sum()
    assert float(lhs) == float(rhs)


@pytest.mark.parametrize("method", ["cuda", "horner", "strips"])
def test_block_rows_and_block_batch(method):
    shape = (3, 13, 13)
    base = TP.get_plan(shape, torch.int32, method)
    for knobs in (dict(block_rows=4), dict(block_batch=2),
                  dict(block_rows=5, block_batch=1)):
        plan = TP.get_plan(shape, torch.int32, method, **knobs)
        for kind in KINDS:
            x = torch.from_numpy(_input(plan, kind, seed=7))
            assert torch.equal(getattr(plan, kind)(x),
                               getattr(base, kind)(x)), (knobs, kind)
    bad = TP.get_plan(shape, torch.int32, method, block_rows=0)
    with pytest.raises(ValueError, match=">= 1"):
        bad.forward(torch.zeros(shape, dtype=torch.int32))


def test_map_batch_impl_matches_stacked():
    shape = (3, 7, 7)
    x = torch.from_numpy(_input(TP.get_plan(shape, torch.int32), "forward",
                                seed=1))
    outs = [TP.get_plan(shape, torch.int32, "gather", batch_impl=bi)
            .forward(x) for bi in ("map", "vmap", "auto")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="batch_impl"):
        TP.get_plan(shape, torch.int32, batch_impl="pmap")


def test_plan_cache_counters():
    TP.set_plan_cache_maxsize(2)
    try:
        TP.plan_cache_clear()
        info0 = TP.plan_cache_info()
        a = TP.get_plan((7, 7), torch.int32)
        assert TP.get_plan((7, 7), torch.int32) is a
        info = TP.plan_cache_info()
        assert info.hits == info0.hits + 1
        assert info.misses == info0.misses + 1
        TP.get_plan((11, 11), torch.int32)
        TP.get_plan((13, 13), torch.int32)     # evicts (7, 7)
        info = TP.plan_cache_info()
        assert info.currsize == 2 and info.maxsize == 2
        assert info.evictions == info0.evictions + 1
        assert [e["image_shape"] for e in TP.plan_cache_entries()] == \
            [(11, 11), (13, 13)]
        assert TP.plan_cache_discard([TP.get_plan((13, 13),
                                                  torch.int32)]) == 1
        assert TP.plan_cache_info().currsize == 1
    finally:
        TP.set_plan_cache_maxsize(512)


@pytest.mark.parametrize("shape,dtype,method,knobs", [
    ((251, 251), "int32", "auto", {}),
    ((3, 13, 13), "int32", "pallas", {"m_block": 16}),
    ((12, 10), "float32", "horner", {}),
    ((13, 13), "int64", "strips", {"strip_rows": 4}),
    ((2, 31, 31), "uint8", "auto", {"block_rows": 8, "block_batch": 1}),
], ids=str)
def test_plan_from_description_round_trip(shape, dtype, method, knobs):
    desc = RP.get_plan(shape, jnp.dtype(dtype), method, **knobs).describe()
    plan = TP.plan_from_description(desc)
    got = plan.describe()
    want = dict(desc)
    if want["method"] == "pallas":
        want["method"] = "cuda"
    assert got == want


def test_pallas_is_an_alias_of_cuda():
    plan = TP.get_plan((7, 7), torch.int32, "pallas")
    assert plan.method == "cuda" and plan.requested_method == "pallas"
    assert TP.get_backend("pallas") is TP.get_backend("cuda")
    caps = {row["name"]: row for row in TP.backend_capabilities()}
    assert caps["cuda"]["priority"] == 100 and caps["cuda"]["batched_native"]
    assert caps["cuda"]["stream"]


def test_stream_rows_mesh_and_pipeline_raise():
    # stream_rows is ported: a streamed plan on the cuda backend
    plan = TP.get_plan((13, 13), torch.int32, stream_rows=4)
    assert plan.stream_rows == 4 and plan.method == "cuda"
    # the mesh is ported (item 9): it must be a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        TP.get_plan((13, 13), torch.int32, mesh=object())
    # ... and so is the pipeline's mesh tail (K3)
    from repro_torch.kernels.ops import pipeline_tail_cuda
    with pytest.raises(ValueError, match="needs an operand"):
        pipeline_tail_cuda(torch.zeros(4, 13, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs an operand"):
        TP.get_plan((13, 13), torch.int32).pipeline(
            torch.zeros(13, 13, dtype=torch.int32))
    # sharded_pallas is the alias of the mesh backend, which needs a mesh
    plan = TP.get_plan((13, 13), torch.int32, "sharded_pallas")
    assert plan.method == "sharded_cuda"
    with pytest.raises(ValueError, match="need mesh="):
        plan.forward(torch.zeros(13, 13, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown method"):
        TP.get_plan((13, 13), torch.int32, "sharded_tpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        from repro_torch.kernels.tuning import resolve_blocks
        resolve_blocks(13, 4, block_rows=2, stream_rows=2)
