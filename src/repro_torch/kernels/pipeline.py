"""K2, the fused projection-domain pipeline, and K3, its mesh tail: their
launchers and plain versions.

The port of the pipeline half of :mod:`repro.kernels.sfdprt`.  One CUDA
source (``csrc/pipeline.cu``, CUDA C++ for ``sm_90a``) replaces the TPU
kernel ``repro/kernels/sfdprt.py:_pipeline_kernel`` with
``source="image"``: for a (B, N, N) image stack it runs the forward
DPRT of a block of directions, the per-direction op

* ``conv`` -- ``rc[m, d] = sum_t rf[m, t] * rg[m, <d - t>_N]`` against
  the operand's projections (computed in-kernel from an operand image,
  ``operand_form="image"``, or given, ``"proj"``),
* ``mul``  -- ``rf * w`` against (N+1, N) projection-domain weights,
* ``none`` -- no change,

keeps rows 0 and N of the result in ``aux`` and runs the inverse onto
all N x N outputs, ending with ``floor((Z - S + rc[N, i]) / N)``.  The
projections never reach device memory.

:func:`pipeline_raw` is the wrapper: on a CUDA tensor it launches the
kernel or raises (no fallback); on a CPU tensor it runs
:func:`pipeline_plain`, the same function composed from K1's plain
version and a chunked 1-D circular convolution, which is also what
``chip_smoke.py`` holds the kernel against on the card.  ``m_block``
caps the number of directions one thread block owns
(:func:`.tuning.pipeline_tile`: the registers and the 227 KB of shared
memory of one block per SM set the rest); ``group`` and ``lane_batch``
-- the TPU kernel's conv tap group and batch-in-lanes width -- are
validated and change no output here.

K3 (the same source, entry ``pipeline_tail_launch``) replaces the TPU
kernel with ``source="proj"``, ``defer=True``: the tail of the mesh
pipeline (:func:`repro_torch.core.distributed.projection_pipeline_sharded`).
It takes one shard of already-summed projection rows whose first global
direction is ``row_offset`` and returns the shard's uncorrected inverse
``Z`` and the op's rows 0 and N (``aux``, zero where the shard does not
hold them); the correction waits for the sum over shards.  It is K2 from
the op on: the same device functions for the operand window, the conv's
register window, the padded rc rows and the register-tiled inverse, on a
tile from the same layout (:func:`.tuning.tail_tile`, ``source="proj"``:
no forward and no ring, so only shared memory, ``m_block`` and the
shard's rows cap its directions per block).  :func:`pipeline_tail_raw`
launches it (or, on a CPU tensor, runs :func:`pipeline_tail_plain`);
:func:`pipeline_tail_launch_tile` launches it with an explicit tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core.conv import circ_conv1d_exact
from . import _build
from .sfdprt import _DTYPES, sfdprt_plain, tile_array
from .tuning import PipelineTile, pipeline_tile, tail_tile

__all__ = ["PIPELINE_OPS", "pipeline_raw", "pipeline_launch_tile",
           "pipeline_plain", "pipeline_tail_raw", "pipeline_tail_launch_tile",
           "pipeline_tail_plain", "OP_LAUNCHES", "TAIL_OP_LAUNCHES",
           "CONV_KERNEL_FORWARDS", "reset_launch_counts"]

PIPELINE_OPS = ("none", "mul", "conv")
_OPS = {"none": 0, "mul": 1, "conv": 2}

#: pipeline calls that launched K2 since the last reset, by op.  Only
#: :func:`pipeline_raw` adds to them, once per call that launches; one
#: call is a memset of the output and two kernel launches (the main
#: kernel, then the one that applies the correction and the floor
#: divide once every block of an image is done).
OP_LAUNCHES = {op: 0 for op in PIPELINE_OPS}
#: the same for K3: tail calls that launched it, by op (one call is two
#: memsets and one kernel launch).  Only
#: :func:`pipeline_tail_launch_tile` adds.
TAIL_OP_LAUNCHES = {op: 0 for op in PIPELINE_OPS}
#: forwards of a kernel image that ``radon.Conv2D`` computed on a call,
#: to hand K2 the kernel's projections for a batched stack.  Only
#: ``Conv2D.__call__`` adds, once per such call.
CONV_KERNEL_FORWARDS = 0


def reset_launch_counts() -> None:
    global CONV_KERNEL_FORWARDS
    CONV_KERNEL_FORWARDS = 0
    for counts in (OP_LAUNCHES, TAIL_OP_LAUNCHES):
        for op in counts:
            counts[op] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pipeline")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pipeline_launch.argtypes = [i32, vp, i64, vp, i64, vp, vp, i32, i32,
                                    vp, i32, i32, vp]
    lib.pipeline_launch.restype = i32
    lib.pipeline_tail_launch.argtypes = [i32, vp, i64, i32, vp, i64, vp, vp,
                                         i32, i32, vp, i32, i32, vp]
    lib.pipeline_tail_launch.restype = i32
    lib.pipeline_error_string.argtypes = [i32]
    lib.pipeline_error_string.restype = ctypes.c_char_p
    return lib


def _check(f: torch.Tensor, operand, op: str, operand_form: str,
           m_block: int, group: int, lane_batch: int) -> None:
    if op not in _OPS:
        raise ValueError(f"pipeline op must be one of {PIPELINE_OPS}: {op!r}")
    if f.ndim != 3 or f.shape[1] != f.shape[2] or f.shape[2] < 2:
        raise ValueError(f"pipeline image stack must be (B, N, N), got "
                         f"{tuple(f.shape)}")
    if f.dtype not in _DTYPES:
        raise TypeError(f"pipeline input must be in an accumulator dtype "
                        f"{tuple(_DTYPES)}, got {f.dtype}")
    if f.stride(2) != 1 or f.stride(1) != f.shape[2]:
        raise ValueError("pipeline image rows must be contiguous")
    for name, v in (("m_block", m_block), ("group", group),
                    ("lane_batch", lane_batch)):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    if op == "none":
        if operand is not None:
            raise ValueError("pipeline op 'none' takes no operand")
        return
    b, n = f.shape[0], f.shape[2]
    if operand_form not in ("image", "proj") or (
            operand_form == "image" and op != "conv"):
        raise ValueError(f"operand_form {operand_form!r} does not fit "
                         f"op {op!r}")
    rows = n if operand_form == "image" else n + 1
    if (operand is None or operand.ndim != 3
            or tuple(operand.shape[1:]) != (rows, n)
            or operand.shape[0] not in (1, b)):
        raise ValueError(
            f"pipeline operand for op={op!r}/{operand_form} must be "
            f"(1 or {b}, {rows}, {n}), got "
            f"{None if operand is None else tuple(operand.shape)}")
    if operand.dtype != f.dtype or operand.device != f.device:
        raise ValueError(f"pipeline operand must be {f.dtype} on "
                         f"{f.device}, got {operand.dtype} on "
                         f"{operand.device}")
    if operand.stride(2) != 1 or operand.stride(1) != n:
        raise ValueError("pipeline operand rows must be contiguous")


def pipeline_raw(f: torch.Tensor, operand: Optional[torch.Tensor] = None,
                 *, op: str = "none", operand_form: str = "proj",
                 m_block: int = 32, group: int = 4,
                 lane_batch: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K2 over ``f`` (B, N, N), already in the accumulator dtype.

    ``operand`` (same dtype and device): None for ``op="none"``; the
    conv operand as (B|1, N, N) images (``operand_form="image"``) or
    (B|1, N+1, N) projections, or (B|1, N+1, N) ``mul`` weights.
    Returns ``(out, aux)``: the (B, N, N) result and the (B, 2, N) rows
    0 and N of the per-direction op's output.  A CUDA tensor launches
    the kernel on the current stream (raising if the launch is
    refused); a CPU tensor takes :func:`pipeline_plain`.
    """
    _check(f, operand, op, operand_form, m_block, group, lane_batch)
    if f.device.type == "cpu":
        return pipeline_plain(f, operand, op=op, operand_form=operand_form)
    if f.device.type != "cuda":
        raise RuntimeError(f"K2 runs on CUDA or CPU tensors, not {f.device}")
    tile = pipeline_tile(f.shape[2], f.element_size(), m_block, op)
    return pipeline_launch_tile(f, operand, tile, op=op,
                                operand_form=operand_form)


def pipeline_launch_tile(f: torch.Tensor, operand: Optional[torch.Tensor],
                         tile: PipelineTile, *, op: str,
                         operand_form: str = "proj"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 over the CUDA stack ``f`` with an explicit ``tile``
    (:func:`pipeline_raw` passes :func:`.tuning.pipeline_tile`'s;
    ``chip_smoke.py`` times others).  The kernel checks the tile against
    its own constants and budgets and the launch raises if it is
    refused."""
    _check(f, operand, op, operand_form, tile.m_block, 1, 1)
    if f.device.type != "cuda":
        raise RuntimeError(f"K2 launches on CUDA tensors, not {f.device}")
    b, _, n = f.shape
    out = torch.empty((b, n, n), dtype=f.dtype, device=f.device)
    aux = torch.empty((b, 2, n), dtype=f.dtype, device=f.device)
    if b == 0:
        return out, aux
    lib = _lib()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    w_ptr, w_stride = None, 0
    if operand is not None:
        w_ptr = operand.data_ptr()
        w_stride = operand.stride(0) if operand.shape[0] == b and b > 1 \
            else 0
    err = lib.pipeline_launch(
        _DTYPES[f.dtype], f.data_ptr(), f.stride(0), w_ptr, w_stride,
        out.data_ptr(), aux.data_ptr(), b, n, tile_array(tile), _OPS[op],
        int(op == "conv" and operand_form == "image"), stream)
    if err != 0:
        raise RuntimeError(
            f"pipeline kernel launch failed (op={op}, {operand_form}, "
            f"B={b}, N={n}, {tile}): "
            f"{lib.pipeline_error_string(err).decode()}")
    with _build.COUNT_LOCK:
        OP_LAUNCHES[op] += 1
    _build.note_launch("pipeline", tile)
    return out, aux


def pipeline_plain(f: torch.Tensor, operand: Optional[torch.Tensor] = None,
                   *, op: str = "none",
                   operand_form: str = "proj"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (any device): K1's plain forward, the
    per-direction op (a chunked exact 1-D circular convolution for
    ``conv``), rows 0 and N into ``aux``, K1's plain inverse core and
    the floor-divided correction."""
    n = f.shape[-1]
    rf = sfdprt_plain(f, sign=1, mode="forward")
    if op == "conv":
        rg = (sfdprt_plain(operand, sign=1, mode="forward")
              if operand_form == "image" else operand)
        rc = circ_conv1d_exact(rf, rg)
    elif op == "mul":
        rc = rf * operand
    else:
        rc = rf
    aux = torch.stack([rc[:, 0], rc[:, n]], dim=1)
    z = sfdprt_plain(rc[:, :n].contiguous(), sign=-1, mode="core")
    s = rc[:, 0].sum(-1, dtype=rc.dtype)
    num = z - s[:, None, None] + rc[:, n, :, None]
    if num.dtype.is_floating_point:
        return num / n, aux
    return torch.div(num, n, rounding_mode="floor"), aux


def _check_tail(rows: torch.Tensor, operand, op: str, row_offset: int,
                m_block: int) -> None:
    if op not in _OPS:
        raise ValueError(f"pipeline op must be one of {PIPELINE_OPS}: {op!r}")
    if rows.ndim != 3 or rows.shape[1] < 1 or rows.shape[2] < 2:
        raise ValueError(f"pipeline tail rows must be (B, rows, N), got "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in _DTYPES:
        raise TypeError(f"pipeline tail rows must be in an accumulator "
                        f"dtype {tuple(_DTYPES)}, got {rows.dtype}")
    if rows.stride(2) != 1 or rows.stride(1) != rows.shape[2]:
        raise ValueError("pipeline tail rows must be contiguous")
    if int(row_offset) < 0 or int(m_block) < 1:
        raise ValueError(f"row_offset must be >= 0 and m_block >= 1, got "
                         f"{row_offset}/{m_block}")
    if op == "none":
        if operand is not None:
            raise ValueError("pipeline op 'none' takes no operand")
        return
    b, n = rows.shape[0], rows.shape[2]
    if (operand is None or operand.ndim != 3
            or tuple(operand.shape[1:]) != (n + 1, n)
            or operand.shape[0] not in (1, b)):
        raise ValueError(
            f"pipeline tail operand for op={op!r} must be (1 or {b}, "
            f"{n + 1}, {n}), got "
            f"{None if operand is None else tuple(operand.shape)}")
    if operand.dtype != rows.dtype or operand.device != rows.device:
        raise ValueError(f"pipeline tail operand must be {rows.dtype} on "
                         f"{rows.device}, got {operand.dtype} on "
                         f"{operand.device}")
    if operand.stride(2) != 1 or operand.stride(1) != n:
        raise ValueError("pipeline tail operand rows must be contiguous")


def pipeline_tail_raw(rows: torch.Tensor,
                      operand: Optional[torch.Tensor] = None, *,
                      op: str = "none", row_offset: int = 0,
                      m_block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K3 over ``rows`` (B, rows, N), already in the accumulator
    dtype: one shard of summed projection rows, first global direction
    ``row_offset``; rows of global index > N count as zero.

    ``operand`` (same dtype and device): None for ``op="none"``, else
    the FULL (B|1, N+1, N) projections (``conv``) or weights (``mul``),
    read at the shard's global directions.  Returns ``(z, aux)``: the
    (B, N, N) inverse of the shard's directions < N without correction
    or divide, and the (B, 2, N) op rows 0 and N (zero where the shard
    does not hold them).  A CUDA tensor launches the kernel on the
    current stream with :func:`.tuning.tail_tile`'s tile (``m_block``
    caps its directions per block; raising if the launch is refused); a
    CPU tensor takes :func:`pipeline_tail_plain`.
    """
    _check_tail(rows, operand, op, row_offset, m_block)
    if rows.device.type == "cpu":
        return pipeline_tail_plain(rows, operand, op=op,
                                   row_offset=row_offset)
    if rows.device.type != "cuda":
        raise RuntimeError(f"K3 runs on CUDA or CPU tensors, not "
                           f"{rows.device}")
    _, k, n = rows.shape
    tile = tail_tile(n, rows.element_size(), int(m_block), op, k)
    return pipeline_tail_launch_tile(rows, operand, tile, op=op,
                                     row_offset=row_offset)


def pipeline_tail_launch_tile(rows: torch.Tensor,
                              operand: Optional[torch.Tensor],
                              tile: PipelineTile, *, op: str,
                              row_offset: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 over the CUDA shard ``rows`` with an explicit ``tile``
    (:func:`pipeline_tail_raw` passes :func:`.tuning.tail_tile`'s;
    ``chip_smoke.py`` times others).  The kernel checks the tile against
    its own constants and budgets and the launch raises if it is
    refused."""
    _check_tail(rows, operand, op, row_offset, tile.m_block)
    if rows.device.type != "cuda":
        raise RuntimeError(f"K3 launches on CUDA tensors, not {rows.device}")
    b, k, n = rows.shape
    z = torch.empty((b, n, n), dtype=rows.dtype, device=rows.device)
    aux = torch.empty((b, 2, n), dtype=rows.dtype, device=rows.device)
    if b == 0:
        return z, aux
    lib = _lib()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    w_ptr, w_stride = None, 0
    if operand is not None:
        w_ptr = operand.data_ptr()
        w_stride = operand.stride(0) if operand.shape[0] == b and b > 1 \
            else 0
    err = lib.pipeline_tail_launch(
        _DTYPES[rows.dtype], rows.data_ptr(), rows.stride(0), k, w_ptr,
        w_stride, z.data_ptr(), aux.data_ptr(), b, n, tile_array(tile),
        int(row_offset), _OPS[op], stream)
    if err != 0:
        raise RuntimeError(
            f"pipeline tail kernel launch failed (op={op}, B={b}, rows={k}, "
            f"N={n}, row_offset={row_offset}, {tile}): "
            f"{lib.pipeline_error_string(err).decode()}")
    with _build.COUNT_LOCK:
        TAIL_OP_LAUNCHES[op] += 1
    _build.note_launch("pipeline", tile)
    return z, aux


def pipeline_tail_plain(rows: torch.Tensor,
                        operand: Optional[torch.Tensor] = None, *,
                        op: str = "none", row_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (any device): mask the rows past
    direction N, the per-direction op against the operand's rows at the
    global directions, rows 0 and N into ``aux``, and K1's plain inverse
    core of the directions < N at their global offset."""
    b, k, n = rows.shape
    dev, dt = rows.device, rows.dtype
    grow = int(row_offset) + torch.arange(k, device=dev)
    keep = (grow <= n)[None, :, None]
    rf = torch.where(keep, rows, torch.zeros((), dtype=dt, device=dev))
    if op == "none":
        rc = rf
    else:
        win = torch.where(keep, operand[:, grow.clamp(max=n)],
                          torch.zeros((), dtype=dt, device=dev))
        rc = circ_conv1d_exact(rf, win) if op == "conv" else rf * win
    aux = torch.zeros((b, 2, n), dtype=dt, device=dev)
    for slot, direction in ((0, 0), (1, n)):
        at = (grow == direction).nonzero()
        if len(at):
            aux[:, slot] = rc[:, int(at[0])]
    live = max(0, min(k, n - int(row_offset)))   # directions < N lead
    if live == 0:
        return torch.zeros((b, n, n), dtype=dt, device=dev), aux
    z = sfdprt_plain(rc[:, :live].contiguous(), sign=-1, mode="core",
                     row_offset=int(row_offset))
    return z, aux
