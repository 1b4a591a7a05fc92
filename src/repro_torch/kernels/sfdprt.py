"""K1, the fused batched SFDPRT kernel: its launcher and its plain version.

The port of the transform half of :mod:`repro.kernels.sfdprt`.  One
kernel (``csrc/sfdprt.cu``, CUDA C++ for ``sm_90a``) replaces the TPU
kernel ``repro/kernels/sfdprt.py:_sfdprt_kernel`` in its three modes:

* ``core``    -- the bare skew-sum
  ``out[b, m, d] = sum_i g[b, i, <d + sign*m*(row_offset + i)>_N]``,
* ``forward`` -- sign +1 plus the row-sum row R(N, d) = sum_j f[b, d, j],
* ``inverse`` -- sign -1 over r[:N] plus the fused epilogue
  ``floor((Z[i, j] + corr[i]) / N)``, ``corr[i] = R(N, i) - S``; the
  correction is computed here in torch before the launch, as the
  reference computes it outside its kernel.

:func:`sfdprt` is the wrapper: on a CUDA tensor it launches the kernel
or raises (no fallback); on a CPU tensor it runs :func:`sfdprt_plain`,
the direct, chunked-over-directions gather-and-sum of the same modes,
which is also what ``chip_smoke.py`` holds the kernel against on the
card.  ``strip_rows`` and ``m_block`` cap the kernel's tile
(:func:`.tuning.skew_tile`: the rows of one shared-memory stage and the
directions of one block, whose sums sit in registers); they change no
integer result.  With ``stream_rows`` the raw functions below launch
the streamed kernel (:mod:`.stream`, K4/K5) instead of K1, and so they
do where N is too wide for K1's block (:func:`_skew`).

The forward and the bare skew-sum of a narrow integer image sum in
:func:`repro_torch.core.dprt.forward_sum_dtype_for` (int32 for uint8
at every N the port runs) and return :func:`accum_dtype_for` (int64 at
N >= 2903 for uint8): the kernels store their int32 sums as int64
(``out_dtype``), so no cast kernel follows; the inverse sums in
:func:`accum_dtype_for`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.dprt import accum_dtype_for, forward_sum_dtype_for
from . import _build
from .stream import _sms, check_out_dtype, inverse_gated, stream_raw
from .tuning import SkewTile, skew_holds, skew_tile, stream_dma_holds

__all__ = ["sfdprt", "sfdprt_launch_tile", "sfdprt_plain", "skew_sum_raw",
           "dprt_raw", "idprt_raw", "isfdprt_core", "MODE_LAUNCHES",
           "NARROW_LAUNCHES", "reset_launch_counts", "skew_sum_pallas_raw",
           "dprt_pallas_raw", "idprt_pallas_raw", "pipeline_pallas_raw"]

#: kernel launches since the last reset (all modes); MODE_LAUNCHES splits
#: the same count by mode, NARROW_LAUNCHES counts those whose operand is
#: narrower than their output (int32 sums stored as int64).  Only
#: :func:`sfdprt_launch_tile` adds to them, once per launch of the CUDA
#: kernel.
LAUNCHES = 0
MODE_LAUNCHES = {"core": 0, "forward": 0, "inverse": 0}
NARROW_LAUNCHES = 0

_MODES = {"core": 0, "forward": 1, "inverse": 2}
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.float64: 3}

#: elements one chunk of the plain version gathers at a time
_PLAIN_CHUNK = 1 << 25


def reset_launch_counts() -> None:
    global LAUNCHES, NARROW_LAUNCHES
    LAUNCHES = NARROW_LAUNCHES = 0
    for mode in MODE_LAUNCHES:
        MODE_LAUNCHES[mode] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sfdprt")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sfdprt_launch.argtypes = [i32, i32, vp, i64, vp, vp, i32, i32, i32,
                                  i32, vp, i32, i32, i64, vp]
    lib.sfdprt_launch.restype = i32
    lib.sfdprt_error_string.argtypes = [i32]
    lib.sfdprt_error_string.restype = ctypes.c_char_p
    return lib


def _check(g: torch.Tensor, sign: int, mode: str, corr, strip_rows: int,
           m_block: int) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}: {mode!r}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    if (mode == "forward" and sign != 1) or (mode == "inverse"
                                             and sign != -1):
        raise ValueError(f"mode {mode!r} fixes sign to "
                         f"{1 if mode == 'forward' else -1}")
    if g.ndim != 3 or g.shape[1] < 1 or g.shape[1] > g.shape[2]:
        raise ValueError(f"operand must be (B, rows <= N, N), got "
                         f"{tuple(g.shape)}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"operand must be in an accumulator dtype "
                        f"{tuple(_DTYPES)}, got {g.dtype}")
    if g.stride(2) != 1 or g.stride(1) != g.shape[2]:
        raise ValueError("operand rows must be contiguous (stride (…, N, 1))")
    if int(strip_rows) < 1 or int(m_block) < 1:
        raise ValueError(f"strip_rows/m_block must be >= 1, got "
                         f"{strip_rows}/{m_block}")
    if mode == "inverse":
        b, _, n = g.shape
        if (corr is None or tuple(corr.shape) != (b, n)
                or corr.dtype != g.dtype or corr.device != g.device
                or not corr.is_contiguous()):
            raise ValueError(f"inverse mode needs a contiguous (B, N) = "
                             f"({b}, {n}) {g.dtype} corr on {g.device}")


def sfdprt(g: torch.Tensor, *, sign: int, mode: str, strip_rows: int,
           m_block: int, corr: torch.Tensor | None = None,
           row_offset: int = 0,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Run K1 over ``g`` (B, rows, N), already in the dtype it sums in.

    Returns (B, N+1, N) in ``forward`` mode and (B, N, N) otherwise, in
    ``out_dtype`` (:func:`.stream.check_out_dtype`; default ``g.dtype``).
    A CUDA operand launches the kernel on the current stream (raising if
    the launch is refused); a CPU operand takes :func:`sfdprt_plain`.
    """
    _check(g, sign, mode, corr, strip_rows, m_block)
    if g.device.type == "cpu":
        return sfdprt_plain(g, sign=sign, mode=mode, corr=corr,
                            row_offset=row_offset, out_dtype=out_dtype)
    if g.device.type != "cuda":
        raise RuntimeError(f"K1 runs on CUDA or CPU tensors, not {g.device}")
    b, rows, n = g.shape
    out_rows = n + 1 if mode == "forward" else n
    tile = skew_tile(n, rows, g.element_size(), strip_rows, m_block,
                     out_rows, batch=max(1, b),
                     sms=_sms(g.device.index or 0))
    return sfdprt_launch_tile(g, tile, sign=sign, mode=mode, corr=corr,
                              row_offset=row_offset, out_dtype=out_dtype)


def sfdprt_launch_tile(g: torch.Tensor, tile: SkewTile, *, sign: int,
                       mode: str, corr: torch.Tensor | None = None,
                       row_offset: int = 0,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch K1 over the CUDA operand ``g`` with an explicit ``tile``
    (:func:`sfdprt` passes :func:`.tuning.skew_tile`'s; ``chip_smoke.py``
    times others).  The kernel checks the tile against its own constants
    and budgets and the launch raises if it is refused."""
    global LAUNCHES, NARROW_LAUNCHES
    _check(g, sign, mode, corr, tile.stage_rows, tile.m_block)
    out_dtype = check_out_dtype(g, mode, out_dtype)
    if g.device.type != "cuda":
        raise RuntimeError(f"K1 launches on CUDA tensors, not {g.device}")
    b, rows, n = g.shape
    out_rows = n + 1 if mode == "forward" else n
    out = torch.empty((b, out_rows, n), dtype=out_dtype, device=g.device)
    if b == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.sfdprt_launch(
        _DTYPES[g.dtype], _DTYPES[out_dtype], g.data_ptr(), g.stride(0),
        None if corr is None else corr.data_ptr(), out.data_ptr(), b, rows,
        n, out_rows, tile_array(tile), int(sign), _MODES[mode],
        int(row_offset), stream)
    if err != 0:
        raise RuntimeError(
            f"sfdprt kernel launch failed ({mode}, B={b}, rows={rows}, "
            f"N={n}, {tile}): {lib.sfdprt_error_string(err).decode()}")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
        MODE_LAUNCHES[mode] += 1
        NARROW_LAUNCHES += out_dtype != g.dtype
    _build.note_launch("sfdprt", tile)
    return out


def tile_array(tile) -> ctypes.Array:
    """A tile's fields, in its NamedTuple's order, as the C int array a
    kernel's launch takes (its ``tile::`` enum names the same order)."""
    return (ctypes.c_int * len(tile))(*(int(v) for v in tile))


def sfdprt_plain(g: torch.Tensor, *, sign: int, mode: str,
                 corr: torch.Tensor | None = None, row_offset: int = 0,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): for each chunk of
    directions, gather ``g[b, i, <d + sign*m*(row_offset + i)>_N]`` and
    sum over i in ``g.dtype``; then the mode's row-sum row or inverse
    epilogue; the result is stored in ``out_dtype``, as the kernel
    stores it."""
    out_dtype = check_out_dtype(g, mode, out_dtype)
    b, rows, n = g.shape
    dev = g.device
    out_rows = n + 1 if mode == "forward" else n
    out = torch.zeros((b, out_rows, n), dtype=g.dtype, device=dev)
    flat = g.reshape(b, rows * n)
    i = torch.arange(rows, device=dev, dtype=torch.int64)
    d = torch.arange(n, device=dev, dtype=torch.int64)
    glob = i + int(row_offset)
    chunk = max(1, _PLAIN_CHUNK // max(1, b * rows * n))
    for m0 in range(0, n, chunk):
        ms = torch.arange(m0, min(m0 + chunk, n), device=dev,
                          dtype=torch.int64)
        idx = torch.remainder(d[None, None, :] + sign * ms[:, None, None]
                              * glob[None, :, None], n) + (i * n)[None, :,
                                                                   None]
        vals = flat[:, idx.reshape(-1)].reshape(b, len(ms), rows, n)
        out[:, m0:m0 + len(ms)] = vals.sum(2, dtype=g.dtype)
    if mode == "forward":
        keep = (glob >= 0) & (glob < n)
        out[:, n, glob[keep]] = g.sum(2, dtype=g.dtype)[:, keep]
    elif mode == "inverse":
        total = out + corr[:, :, None]
        if g.dtype.is_floating_point:
            out = total / n
        else:
            out = torch.div(total, n, rounding_mode="floor")
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# the counterparts of repro.kernels.sfdprt.*_pallas_raw
# ---------------------------------------------------------------------------
def _rows_contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are contiguous (the kernel takes any
    batch stride, e.g. ``r[:, :N]``), else a contiguous copy."""
    if x.stride(-1) == 1 and x.stride(-2) == x.shape[-1]:
        return x
    return x.contiguous()


def _stream_route(n: int, itemsize: int, strip_rows: int, stream_rows,
                  stream_impl):
    """Where a skew-sum of ``itemsize``-byte values over N columns runs:
    None for K1, else ``(stream_rows, impl)``, the streamed kernel's
    stage height and ``impl(width)``, the ``stream_impl`` of a launch
    over ``width``-byte values.  The caller's ``stream_rows`` and
    ``stream_impl`` where it gives ``stream_rows``; else, where K1
    cannot hold one direction of N (:func:`.tuning.skew_holds`: N >
    14336 for 4-byte sums, 7168 for 8-byte ones; the operand's width,
    not the output's, counts), stages of at most ``strip_rows`` rows
    through K5, or through K4 where K5's ring cannot hold two padded
    rows of that width."""
    if stream_rows is not None:
        return int(stream_rows), lambda width: stream_impl
    if skew_holds(n, itemsize):
        return None
    return int(strip_rows), lambda width: (
        "dma" if stream_dma_holds(n, width) else "grid")


def _skew(g: torch.Tensor, *, sign: int, mode: str, strip_rows: int,
          m_block: int, corr=None, row_offset=None, stream_rows=None,
          stream_impl=None, out_dtype=None) -> torch.Tensor:
    """K1, or the streamed kernel K4/K5 where :func:`_stream_route` says
    (and then K1 is not launched): the same function in one launch."""
    route = _stream_route(g.shape[2], g.element_size(), strip_rows,
                          stream_rows, stream_impl)
    if route is None:
        return sfdprt(g, sign=sign, mode=mode, strip_rows=strip_rows,
                      m_block=m_block, corr=corr,
                      row_offset=row_offset or 0, out_dtype=out_dtype)
    rows, impl = route
    return stream_raw(g, sign=sign, mode=mode, stream_rows=rows,
                      m_block=m_block, corr=corr, row_offset=row_offset or 0,
                      stream_impl=impl(g.element_size()), out_dtype=out_dtype)


def skew_sum_raw(g: torch.Tensor, sign: int = 1, strip_rows: int = 16,
                 m_block: int = 8, row_offset=None,
                 stream_rows: int | None = None,
                 stream_impl: str | None = None) -> torch.Tensor:
    """Bare skew-sum via K1 (core mode): (rows, N) or (B, rows, N), N
    prime, to the same rank with N direction rows in the accumulator
    dtype, summed in :func:`forward_sum_dtype_for`; ``rows < N`` with a
    ``row_offset`` gives the partial of a row strip aligned to global
    rows.  ``stream_rows`` streams the rows through K4/K5
    (``stream_impl`` "grid" or "dma", default "dma")."""
    single = g.ndim == 2
    gb = g[None] if single else g
    n = gb.shape[-1]
    ga = _rows_contiguous(gb.to(forward_sum_dtype_for(g.dtype, n)))
    out = _skew(ga, sign=sign, mode="core", strip_rows=strip_rows,
                m_block=m_block, row_offset=row_offset,
                stream_rows=stream_rows, stream_impl=stream_impl,
                out_dtype=accum_dtype_for(g.dtype, n))
    return out[0] if single else out


def dprt_raw(f: torch.Tensor, strip_rows: int = 16, m_block: int = 8,
             row_offset=None, stream_rows: int | None = None,
             stream_impl: str | None = None) -> torch.Tensor:
    """Fused batched forward DPRT: (B, N, N) -> (B, N+1, N) in one launch,
    the R(N, d) row produced in-kernel, in the accumulator dtype and
    summed in :func:`forward_sum_dtype_for`.  With ``rows < N`` and a
    ``row_offset`` this is the partial forward of a row strip;
    ``stream_rows`` runs it through K4/K5."""
    n = f.shape[-1]
    fa = _rows_contiguous(f.to(forward_sum_dtype_for(f.dtype, n)))
    return _skew(fa, sign=1, mode="forward", strip_rows=strip_rows,
                 m_block=m_block, row_offset=row_offset,
                 stream_rows=stream_rows, stream_impl=stream_impl,
                 out_dtype=accum_dtype_for(f.dtype, n))


def idprt_raw(r: torch.Tensor, strip_rows: int = 16, m_block: int = 8,
              stream_rows: int | None = None,
              stream_impl: str | None = None) -> torch.Tensor:
    """Fused batched inverse DPRT: (B, N+1, N) -> (B, N, N) in one
    launch; the -S + R(N, i) correction and the floor divide by N run
    in-kernel after the last tile (or strip, with ``stream_rows``).
    Streamed int64 sums take :func:`.stream.inverse_gated` (a pass
    over the operand and two launches, which sum each image in 32 bits
    where its values allow it); K1's int64 inverse stays one launch."""
    n = r.shape[-1]
    acc = accum_dtype_for(r.dtype, n)
    ra = _rows_contiguous(r.to(acc))
    corr = (ra[:, n, :] - ra[:, 0, :].sum(1, keepdim=True, dtype=acc))
    route = (_stream_route(n, 8, strip_rows, stream_rows, stream_impl)
             if acc == torch.int64 else None)
    if route is not None:
        # streamed: each image sums in 32 bits where its values allow
        rows, impl = route
        return inverse_gated(ra[:, :n, :], corr.contiguous(),
                             stream_rows=rows, m_block=m_block,
                             stream_impls=(impl(4), impl(8)))
    return _skew(ra[:, :n, :], sign=-1, mode="inverse",
                 strip_rows=strip_rows, m_block=m_block,
                 corr=corr.contiguous(), stream_rows=stream_rows,
                 stream_impl=stream_impl)


# The inverse core (iSFDPRT_core) is the skew-sum with circular right
# shifts, sign -1: the bare, uncorrected Z.
isfdprt_core = functools.partial(skew_sum_raw, sign=-1)


# ---------------------------------------------------------------------------
# the reference's raw names, with its signatures: ``interpret`` and
# ``step_impl`` (TPU-only knobs) are accepted and change nothing
# ---------------------------------------------------------------------------
def skew_sum_pallas_raw(g: torch.Tensor, sign: int = 1, strip_rows: int = 16,
                        m_block: int = 8, interpret: bool = True,
                        step_impl: str | None = None, row_offset=None,
                        stream_rows: int | None = None,
                        stream_impl: str | None = None) -> torch.Tensor:
    """:func:`skew_sum_raw` under the reference's name."""
    return skew_sum_raw(g, sign, strip_rows, m_block, row_offset,
                        stream_rows, stream_impl)


def dprt_pallas_raw(f: torch.Tensor, strip_rows: int = 16, m_block: int = 8,
                    interpret: bool = True, step_impl: str | None = None,
                    row_offset=None, stream_rows: int | None = None,
                    stream_impl: str | None = None) -> torch.Tensor:
    """:func:`dprt_raw` under the reference's name."""
    return dprt_raw(f, strip_rows, m_block, row_offset, stream_rows,
                    stream_impl)


def idprt_pallas_raw(r: torch.Tensor, strip_rows: int = 16, m_block: int = 8,
                     interpret: bool = True, step_impl: str | None = None,
                     stream_rows: int | None = None,
                     stream_impl: str | None = None) -> torch.Tensor:
    """:func:`idprt_raw` under the reference's name."""
    return idprt_raw(r, strip_rows, m_block, stream_rows, stream_impl)


def pipeline_pallas_raw(f: torch.Tensor, operand=None, op: str = "none",
                        operand_form: str = "proj", source: str = "image",
                        m_block: int = 32, group: int = 4,
                        lane_batch: int = 1, defer: bool = False,
                        interpret: bool = True, step_impl: str | None = None,
                        row_offset=None, n_rows: int | None = None):
    """The reference's one-call pipeline under its name, for the two
    forms the port's kernels run: ``source="image"`` without ``defer``
    (K2, :func:`.pipeline.pipeline_raw`) and ``source="proj"`` with
    ``defer`` (K3, :func:`.pipeline.pipeline_tail_raw`).  Returns
    ``(out, aux)`` at their true (…, N, N) / (…, 2, N) shapes (the
    reference pads them; its callers slice)."""
    from .pipeline import pipeline_raw, pipeline_tail_raw  # imports this
    if source == "image" and not defer:
        return pipeline_raw(f, operand, op=op, operand_form=operand_form,
                            m_block=m_block, group=group,
                            lane_batch=lane_batch)
    if source == "proj" and defer:
        if n_rows not in (None, f.shape[-1]):
            raise ValueError(f"n_rows={n_rows} must be the rows' width "
                             f"{f.shape[-1]}")
        return pipeline_tail_raw(f, operand, op=op,
                                 row_offset=int(row_offset or 0),
                                 m_block=m_block)
    raise ValueError(f"the port runs source='image' (K2) or source='proj' "
                     f"with defer=True (K3), got source={source!r}, "
                     f"defer={defer}")
