"""The mesh slice of the port (``core/distributed.py``, ``launch/mesh.py``,
the ``sharded`` / ``sharded_cuda`` backends, kernel K3) against the
reference's mesh path on the CPU.

* K3's plain version (what ``pipeline_tail_cuda`` runs on a CPU tensor)
  against the reference's ``pipeline_tail_pallas`` in interpret mode, on
  shards of a padded direction space at every offset, the padding-only
  shard included: int32 bit-exact, float32 within rtol 1e-5 / atol 1e-4
  (the summation order differs).
* World size 1 on both sides: the reference's sharded functions on
  ``jax.make_mesh((1,), ("model",))`` and the port's on a (1,) gloo mesh
  of this process, bit-exact; descriptions of mesh plans and operators
  carry across.
* One slow test spawns 4 gloo ranks and runs the port on a ``(4,)``
  ``model`` mesh and a ``(2, 2)`` ``data x model`` mesh against the
  reference's unsharded outputs and numpy oracles computed here.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` holds K3
against its plain version there and drives the mesh path over NCCL.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import radon as R
from repro.core import distributed as RD
from repro.core.conv import circ_conv2d_direct
from repro.core.dprt import dprt_oracle_np, skew_sum as r_skew_sum
from repro.core.plan import get_plan as r_get_plan
from repro.kernels.ops import pipeline_tail_pallas

N = 13
B = 5
F32_RTOL, F32_ATOL = 1e-5, 1e-4


def _ints(shape, seed, lo=-100, hi=100):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _floats(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K3's plain version against the reference's tail kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("op", ["none", "mul", "conv"])
def test_pipeline_tail_matches_reference(op, dtype):
    from repro_torch.kernels.ops import pipeline_tail_cuda
    make = (lambda s, seed: _ints(s, seed, -50, 50)) if dtype == "int32" \
        else _floats
    for devs, batched_w in ((2, False), (4, True)):
        dirs_loc = -(-(N + 1) // devs)
        rows = make((B, dirs_loc * devs, N), devs)
        rows[:, N + 1:] = 0                     # the padded directions
        w = make((B if batched_w else 1, N + 1, N), 10 + devs)
        # every shard, and one at offset 14 that holds only padding
        for off in list(range(0, dirs_loc * devs, dirs_loc)) + [N + 1]:
            shard = rows[:, off:off + dirs_loc] if off < rows.shape[1] \
                else rows[:, :dirs_loc] * 0
            opd = None if op == "none" else w
            z_r, aux_r = pipeline_tail_pallas(
                jnp.asarray(shard), op,
                None if opd is None else jnp.asarray(opd),
                row_offset=off, n=N)
            z_t, aux_t = pipeline_tail_cuda(
                _t(shard), op, None if opd is None else _t(opd),
                row_offset=off, n=N)
            _same(z_t.numpy(), z_r)
            _same(aux_t.numpy(), aux_r)


# ---------------------------------------------------------------------------
# world size 1 on both sides
# ---------------------------------------------------------------------------
def test_cuda_world_needs_a_card(monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch import mesh as TM
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TM.init_world("cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TM.make_local_mesh(1, 1)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        TM.init_world("meta")
@pytest.fixture(scope="module")
def mesh1():
    """A (1,) 'model' mesh over a world-size-1 gloo group of this
    process, closed after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import close_world, init_world
    opened = not dist.is_initialized()
    init_world("cpu")
    yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    if opened:
        close_world()


def test_world_size_one_matches_reference(mesh1):
    from repro_torch.core import distributed as TD
    rmesh = jax.make_mesh((1,), ("model",))
    f = _ints((B, N, N), 1)
    r_ref = RD.dprt_sharded_pallas(jnp.asarray(f), rmesh)
    for reduce in ("psum", "psum_scatter", "ring"):
        r_t = TD.dprt_sharded_pallas(_t(f), mesh1, reduce=reduce)
        _same(r_t.full_tensor().numpy(), r_ref)
        # the inverse consumes the forward's layout in place
        back = TD.idprt_sharded_pallas(r_t, mesh1, reduce=reduce)
        _same(back.full_tensor().numpy(),
              RD.idprt_sharded_pallas(r_ref, rmesh))
    w = _ints((N + 1, N), 2, -5, 6)
    g = _ints((N, N), 3, -5, 6)
    for op, opd in (("none", None), ("mul", w), ("conv", g)):
        z_r = RD.projection_pipeline_sharded(
            jnp.asarray(f), rmesh, op=op,
            operand=None if opd is None else jnp.asarray(opd))
        z_t = TD.projection_pipeline_sharded(
            _t(f), mesh1, op=op, operand=None if opd is None else _t(opd))
        _same(z_t.full_tensor().numpy(), z_r)


def test_local_meshes_follow_the_reference(mesh1):
    from repro.launch.mesh import make_local_mesh as r_make_local_mesh
    from repro_torch.launch import mesh as TM
    for data, model in ((2, 4), (1, 1), (3, 1)):
        want = r_make_local_mesh(data, model)
        got = TM.make_local_mesh(data, model)
        assert got.device_type == "cpu"
        assert (tuple(got.mesh_dim_names), tuple(got.mesh.shape)) == \
            (tuple(want.axis_names), tuple(want.devices.shape))
    with pytest.raises(RuntimeError, match="not one for cuda"):
        TM.init_world("cuda")
    with pytest.raises(RuntimeError, match="256"):
        TM.make_production_mesh()


def test_mesh_descriptions_carry_across(mesh1):
    from repro_torch import radon as T
    from repro_torch.core import plan as TP
    rmesh = jax.make_mesh((1,), ("model",))
    desc = r_get_plan((B, N, N), jnp.int32, mesh=rmesh).describe()
    plan = TP.plan_from_description(desc, mesh=mesh1)
    assert desc["method"] == "sharded_pallas"
    assert plan.method == "sharded_cuda" and plan.mesh is mesh1
    got = plan.describe()
    assert got["mesh"] == "DeviceMesh(axis_sizes=(1,), axis_names=('model',))"
    assert {k: v for k, v in got.items() if k not in ("method", "mesh")} \
        == {k: v for k, v in desc.items() if k not in ("method", "mesh")}
    with pytest.raises(ValueError, match="pass mesh="):
        TP.plan_from_description(desc)
    kernel = _ints((3, 3), 4, -3, 4)
    rconv = R.Conv2D((B, N, N), jnp.asarray(kernel), mesh=rmesh)
    tconv = T.conv2d_from_description(rconv.describe(), kernel, mesh=mesh1)
    f = _ints((B, N, N), 5)
    _same(tconv(_t(f)).numpy(), rconv(jnp.asarray(f)))
    # the plan cache tells meshes apart by their topology token
    assert TP.get_plan((N, N), torch.int32, mesh=mesh1) is \
        TP.get_plan((N, N), torch.int32, mesh=mesh1)
    assert TP.get_plan((N, N), torch.int32, mesh=mesh1).method \
        != TP.get_plan((N, N), torch.int32).method


def test_close_world_drops_mesh_plans():
    """A group opened after another is closed gets fresh mesh plans."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import plan as TP
    from repro_torch.launch.mesh import close_world, init_world
    if dist.is_initialized():       # the module's group
        close_world()
    meshes = []
    for _ in range(2):
        init_world("cpu")
        meshes.append(init_device_mesh("cpu", (1,),
                                       mesh_dim_names=("model",)))
        plan = TP.get_plan((N, N), torch.int32, mesh=meshes[-1])
        assert plan.mesh is meshes[-1]
        f = _ints((N, N), 6)
        assert np.array_equal(plan.inverse(plan.forward(_t(f))).numpy(), f)
        close_world()
    assert not any(p.mesh is not None for p in TP._PLAN_CACHE.values())


# ---------------------------------------------------------------------------
# 4 gloo ranks: (4,) model and (2, 2) data x model
# ---------------------------------------------------------------------------
MESHES = (((4,), ("model",)), ((2, 2), ("data", "model")))


def _mesh_worker(rank, world, port, want):
    """One rank of the spawned group: runs every mesh datapath of the
    port on both meshes and checks it against ``want`` (numpy arrays the
    parent computed with the reference)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import radon as T
    from repro_torch.core import distributed as TD
    from repro_torch.core.conv import circ_conv2d_dprt
    from repro_torch.launch import serve

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        f = _t(want["f"])
        for shape, names in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            tag = f"mesh {shape}"
            for reduce in TD.REDUCES:
                r = TD.dprt_sharded_pallas(f, mesh, reduce=reduce)
                _same(r.full_tensor().numpy(), want["r"])
                _same(TD.idprt_sharded_pallas(r, mesh, reduce=reduce)
                      .full_tensor().numpy(), want["f"])
                _same(TD.idprt_sharded_pallas(_t(want["r"]), mesh,
                                              reduce=reduce)
                      .full_tensor().numpy(), want["f"])
                r0 = TD.dprt_sharded_pallas(f[0], mesh, reduce=reduce)
                _same(r0.full_tensor().numpy(), want["r"][0])
                for sign in (1, -1):
                    _same(TD.skew_sum_sharded_pallas(
                        f, mesh, sign=sign, reduce=reduce)
                        .full_tensor().numpy(), want[f"skew{sign}"])
            for reduce in ("psum", "psum_scatter"):
                _same(TD.dprt_sharded(f[0], mesh, axis=names[-1],
                                      reduce=reduce).full_tensor().numpy(),
                      want["r"][0])
                _same(TD.idprt_sharded(_t(want["r"][0]), mesh,
                                       axis=names[-1], reduce=reduce)
                      .full_tensor().numpy(), want["f"][0])
            _same(TD.dprt_batch_sharded(f, mesh).full_tensor().numpy(),
                  want["r"])
            _same(TD.idprt_batch_sharded(_t(want["r"]), mesh)
                  .full_tensor().numpy(), want["f"])
            for key, op, opd in (("conv_shared", "conv", want["g"]),
                                 ("conv_batched", "conv", want["gb"]),
                                 ("conv_proj", "conv", want["rg"]),
                                 ("mul_shared", "mul", want["w"]),
                                 ("mul_batched", "mul", want["wb"]),
                                 ("none", "none", None)):
                z = TD.projection_pipeline_sharded(
                    f, mesh, op=op, operand=None if opd is None else _t(opd))
                _same(z.full_tensor().numpy(), want[key])
            f31 = _t(want["f31"])
            r31 = TD.dprt_sharded_pallas(f31, mesh)
            _same(r31.full_tensor().numpy(), want["r31"])
            _same(TD.idprt_sharded_pallas(r31, mesh).full_tensor().numpy(),
                  want["f31"])
            _same(TD.projection_pipeline_sharded(
                f31, mesh, op="conv", operand=_t(want["g31"]))
                .full_tensor().numpy(), want["conv31"])
            big = TD.dprt_sharded_pallas(_t(want["big"]), mesh)
            _same(big.full_tensor().numpy(), want["r_big"])
            # the operator surface: ambient mesh, fused == staged, grads
            with T.config(mesh=mesh):
                conv = T.Conv2D(tuple(f.shape), _t(want["g"]))
                assert conv.plan.method == "sharded_cuda", tag
                _same(conv(f).numpy(), want["conv_shared"])
                fused = circ_conv2d_dprt(f, _t(want["g"]))
                staged = circ_conv2d_dprt(f, _t(want["g"]), fuse=False)
                assert torch.equal(fused, staged), tag
                op = T.DPRT(tuple(f.shape), torch.int32)
                _same(op.inverse(op(f)).numpy(), want["f"])
            opf = T.DPRT((3, N, N), torch.float32, mesh=mesh)
            x = _t(want["xf"]).requires_grad_(True)
            (opf(x) * _t(want["wf"])).sum().backward()
            _same(x.grad.numpy(), want["grad"])
            _same(opf.T(_t(want["wf"])).numpy(), want["grad"])
            # the reference's errors
            with pytest.raises(ValueError, match="needs prime"):
                TD.dprt_sharded_pallas(torch.zeros(12, 12, dtype=torch.int32),
                                       mesh)
            with pytest.raises(ValueError, match="must match the stack"):
                TD.projection_pipeline_sharded(f, mesh, op="mul",
                                               operand=_t(want["wb"][:3]))
        with pytest.raises(SystemExit, match="needs --mesh-shape"):
            serve.main(["--smoke", "--device", "cpu", "--method",
                        "sharded_pallas"])
    finally:
        dist.destroy_process_group()


def _reference_values():
    """Everything the ranks check against, from the reference (unsharded
    plans, staged pipelines and numpy oracles)."""
    f = _ints((B, N, N), 7)
    plan = r_get_plan((B, N, N), jnp.int32, "horner")
    fj = jnp.asarray(f)
    g = _ints((N, N), 8, -3, 4)
    gb = _ints((B, N, N), 9, -3, 4)
    w = _ints((N + 1, N), 10, -3, 4)
    wb = _ints((B, N + 1, N), 11, -3, 4)
    rg = dprt_oracle_np(g).astype(np.int32)
    big = _ints((B, N, N), 12, -2 ** 28, 2 ** 28)
    xf, wf = _floats((3, N, N), 13), _floats((3, N + 1, N), 14)
    f31, g31 = _ints((B, 31, 31), 15), _ints((31, 31), 16, -3, 4)
    rop = R.DPRT((3, N, N), jnp.float32, "horner")
    want = {
        "f": f, "g": g, "gb": gb, "w": w, "wb": wb, "rg": rg, "big": big,
        "xf": xf, "wf": wf, "f31": f31, "g31": g31,
        "r31": np.stack([dprt_oracle_np(x) for x in f31]).astype(np.int32),
        "conv31": np.stack([np.asarray(circ_conv2d_direct(x, g31))
                            for x in f31]),
        "r": np.stack([dprt_oracle_np(x) for x in f]).astype(np.int32),
        "skew1": np.stack([np.asarray(r_skew_sum(x, 1)) for x in fj]),
        "skew-1": np.stack([np.asarray(r_skew_sum(x, -1)) for x in fj]),
        "conv_shared": np.stack([np.asarray(circ_conv2d_direct(x, g))
                                 for x in fj]),
        "conv_batched": np.stack([np.asarray(circ_conv2d_direct(x, y))
                                  for x, y in zip(fj, gb)]),
        "conv_proj": np.asarray(plan.pipeline(fj, "conv", jnp.asarray(rg))),
        "mul_shared": np.asarray(plan.pipeline(fj, "mul", jnp.asarray(w))),
        "mul_batched": np.asarray(plan.pipeline(fj, "mul", jnp.asarray(wb))),
        "none": np.asarray(plan.pipeline(fj, "none")),
        "r_big": np.asarray(plan.forward(jnp.asarray(big))),
        "grad": np.asarray(rop.T(jnp.asarray(wf))),
    }
    assert np.array_equal(want["none"], f)
    assert np.array_equal(want["conv_proj"], want["conv_shared"])
    return want


@pytest.mark.slow
def test_four_gloo_ranks_match_reference():
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_mesh_worker, args=(4, port, _reference_values()), nprocs=4,
             join=True)
