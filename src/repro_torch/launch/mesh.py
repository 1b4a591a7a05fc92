"""Device meshes of the port: one process per rank, ``torch.distributed``.

The counterpart of :mod:`repro.launch.mesh`.  Importing this module opens
no process group; the functions do, and only when asked.

* :func:`init_world` joins the process group this process belongs to:
  the one ``torchrun`` describes in the environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or else a group of
  one rank on a free ``localhost`` port.  NCCL on the card, gloo on the
  CPU; asking for the card where there is none raises.
* :func:`make_local_mesh` is the reference's small ``data x model`` mesh
  over however many ranks there are, reshaped by the reference's rule
  when there are too few.
* :func:`make_production_mesh` is the reference's 16 x 16 (or 2 x 16 x
  16) mesh; it needs that many ranks.

A mesh lives on ``"cuda"`` when the group's backend is NCCL and on
``"cpu"`` otherwise.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["init_world", "mesh_device_type", "make_local_mesh",
           "make_production_mesh", "close_world"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device: str = "cuda") -> None:
    """Join this process's group once.

    ``device`` picks the backend: ``"cuda"`` is NCCL and raises
    RuntimeError without a card; ``"cpu"`` is gloo.  Under ``torchrun``
    the rank and world come from the environment (and the card from
    ``LOCAL_RANK``); otherwise the group has one rank.  An open group
    must be of ``device``'s kind.
    """
    kind = torch.device(device).type
    if dist.is_initialized():
        if mesh_device_type() != kind:
            raise RuntimeError(f"the open process group is "
                               f"{dist.get_backend()}, not one for {kind}")
        return
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA card: none is "
                               "available (use device='cpu' for gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"meshes live on 'cuda' or 'cpu', not {device!r}")
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)


def close_world() -> None:
    """Leave the process group, if one is open, and drop the cached plans
    built on its meshes (a later group's mesh of the same shape has the
    same topology token, but not these process groups)."""
    from ..core.plan import _PLAN_CACHE, plan_cache_discard
    plan_cache_discard([p for p in _PLAN_CACHE.values()
                        if p.mesh is not None])
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_device_type() -> str:
    """``"cuda"`` when the open group is NCCL, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_local_mesh(data: int = 2, model: int = 4) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks there are.

    With fewer than ``data * model`` ranks it takes the reference's
    shape: ``(2, ranks // 2)`` for an even count of at least 4, else
    ``(1, ranks)``.  The mesh lives on the open group's device; without
    an open group, :func:`init_world` opens one on the card.
    """
    if not dist.is_initialized():
        init_world()
    n = dist.get_world_size()
    if data * model > n:
        if n % 2 == 0 and n >= 4:
            data, model = 2, n // 2
        else:
            data, model = 1, n
    return init_device_mesh(mesh_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 = 256 ranks per pod; ``multi_pod`` adds a leading 2-pod
    axis.  Needs a group of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        init_world()
    return init_device_mesh(mesh_device_type(), shape,
                            mesh_dim_names=names)
