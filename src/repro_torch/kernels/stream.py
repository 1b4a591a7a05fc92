"""K4/K5, the streamed SFDPRT kernel: its launcher and its plain version.

The port of :func:`repro.kernels.sfdprt._pallas_stream_call`.  One CUDA
kernel template (``csrc/stream.cu``, CUDA C++ for ``sm_90a``) replaces
both TPU kernels of the giant-N path, in K1's three modes:

* ``stream_impl="grid"`` -- ``repro/kernels/sfdprt.py:_stream_grid_kernel``
  (K4): each stage of rows is loaded by the whole block, waited for, and
  only then summed;
* ``stream_impl="dma"`` -- ``_stream_dma_kernel`` (K5), the default as it
  is the reference's compiled default: one producer warp keeps a ring of
  stages filling (``cp.async.bulk`` for each row's aligned interior,
  ``cp.async`` for its ends, its wrap padding copied in shared memory,
  ``mbarrier`` signals) while the consumer warps sum the stages that have
  landed.

Either way one launch streams the whole ``(B, rows, N)`` operand, keeps
the partial sums in registers for the whole strip loop (each lane holds
a few columns of a few directions) and writes the output once.
:func:`stream_raw` is the wrapper: on a CUDA tensor it launches the
kernel or raises (no fallback to K1 or to the plain version); on a CPU
tensor it runs :func:`stream_plain`, the same function in plain PyTorch
in the streamed structure, which is also what ``chip_smoke.py`` holds
the kernel against on the card.

``stream_rows`` is the reference's strip height H.  On Hopper it caps
the rows of one shared-memory stage and ``m_block`` caps the directions
of one block (:func:`.tuning.stream_tile`: at N = 4099 int32, K5 runs 9
directions per block in 15 consumer warps and a ring of three 4-row
stages).  Neither changes an integer result.

``out_dtype`` lets the forward and the bare skew-sum of a narrow integer
image sum in int32 and store int64 (:func:`.sfdprt.dprt_raw` asks for it
where :func:`repro_torch.core.dprt.forward_sum_dtype_for` allows): the
tile and the route follow the operand's 4-byte width, and the kernel
widens each output as it stores it.

:func:`inverse_gated` is the inverse of an int64 operand: it sums each
image in 32 bits where that image's values allow it, chosen on the
device.  One pass (the span :data:`NARROW_SPAN`) takes the per-image
least and largest values (``bounds``) and the operand's low 32 bits;
the narrow variant then runs the 4-byte tile on the images whose bounds
pass the gate (:func:`narrow_fits`) and the int64 kernel, given the
same bounds, on the others, into one output.  Both store the int64
route's bits; no call waits on the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from . import _build
from .tuning import StreamTile, stream_tile

__all__ = ["stream_raw", "stream_launch_tile", "stream_plain",
           "inverse_gated", "narrow_fits", "narrow_inverse_images",
           "STREAM_IMPLS", "LAUNCHES", "IMPL_MODE_LAUNCHES",
           "NARROW_LAUNCHES", "NARROW_INVERSE_LAUNCHES", "NARROW_SPAN",
           "reset_launch_counts", "check_out_dtype"]

STREAM_IMPLS = ("grid", "dma")

#: kernel launches since the last reset; IMPL_MODE_LAUNCHES splits the
#: same count by (stream_impl, mode), NARROW_LAUNCHES counts those of the
#: core and forward modes whose operand is narrower than their output
#: (int32 sums stored as int64; the gated inverse's narrow launch is not
#: one of them).  Only :func:`stream_launch_tile` adds to them, once per
#: launch of the CUDA kernel.
LAUNCHES = 0
IMPL_MODE_LAUNCHES = {(impl, mode): 0 for impl in STREAM_IMPLS
                      for mode in ("core", "forward", "inverse")}
NARROW_LAUNCHES = 0
#: calls of :func:`inverse_gated` since the last reset (on any device: a
#: CPU operand takes the plain pair)
NARROW_INVERSE_LAUNCHES = 0
#: the ``record_function`` span around :func:`inverse_gated`'s pass over
#: the operand (bounds and low 32 bits)
NARROW_SPAN = "repro_torch.inverse.narrow"
#: device -> the int64 tally behind :func:`narrow_inverse_images`
_TALLIES: dict = {}

_IMPLS = {"grid": 0, "dma": 1}
_MODES = {"core": 0, "forward": 1, "inverse": 2}
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.float64: 3}

#: elements one chunk of the plain version gathers at a time
_PLAIN_CHUNK = 1 << 25


def reset_launch_counts() -> None:
    """Zero the host counters and, without waiting, every device tally."""
    global LAUNCHES, NARROW_LAUNCHES, NARROW_INVERSE_LAUNCHES
    LAUNCHES = NARROW_LAUNCHES = NARROW_INVERSE_LAUNCHES = 0
    for key in IMPL_MODE_LAUNCHES:
        IMPL_MODE_LAUNCHES[key] = 0
    for tally in _TALLIES.values():
        tally.zero_()


def _tally(device: torch.device) -> torch.Tensor:
    """The one-element int64 count of images the narrow inverse ran on
    ``device``, made at first use."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _TALLIES:
        _TALLIES[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _TALLIES[key]


def narrow_inverse_images(device) -> int:
    """Images whose gate chose 32-bit sums on ``device`` since the last
    reset.  The tally is added to on the device; reading it waits."""
    return int(_tally(torch.device(device)).item())


def resolve_impl(stream_impl) -> str:
    """``None`` -> ``"dma"``; anything but grid/dma raises the
    reference's ValueError."""
    if stream_impl is None:
        return "dma"
    if stream_impl not in STREAM_IMPLS:
        raise ValueError(f"stream_impl must be 'grid' or 'dma': "
                         f"{stream_impl!r}")
    return stream_impl


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: ``csrc/stream.cu:stream_launch``'s parameters, in order
LAUNCH_ARGTYPES = (_I32, _I32, _I32, _VP, _I64, _VP, _VP, _I32, _I32, _I32,
                   _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                   _I64, _VP, _VP, _VP)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stream")
    lib.stream_launch.argtypes = list(LAUNCH_ARGTYPES)
    lib.stream_launch.restype = _I32
    lib.stream_error_string.argtypes = [_I32]
    lib.stream_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """SMs of CUDA device ``index``, the wave width of the tile choice."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_out_dtype(g: torch.Tensor, mode: str, out_dtype,
                    gated: bool = False) -> torch.dtype:
    """The output dtype of a K1/K4/K5 launch over ``g``: ``g.dtype``
    (``None``), or int64 from an int32 operand in the core and forward
    modes, whose int32 sums the kernel stores widened, and in the
    inverse ``gated`` by bounds (the narrow half of
    :func:`inverse_gated`, which stores int64 only); any other pair
    raises."""
    widened = (g.dtype, out_dtype) == (torch.int32, torch.int64)
    if gated and g.dtype == torch.int32:
        if widened:
            return out_dtype
        raise TypeError(f"the gated inverse of an int32 operand stores "
                        f"int64, not {out_dtype}")
    if out_dtype is None or out_dtype == g.dtype:
        return g.dtype
    if widened and mode != "inverse":
        return out_dtype
    raise TypeError(f"a {g.dtype} operand in {mode!r} mode stores "
                    f"{g.dtype}, or int64 from int32 in the core and "
                    f"forward modes, not {out_dtype}")


def _check(g: torch.Tensor, sign: int, mode: str, corr, stream_rows: int,
           m_block: int, bounds=None) -> None:
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
    if int(stream_rows) < 1 or int(m_block) < 1:
        raise ValueError(f"stream_rows/m_block must be >= 1, got "
                         f"{stream_rows}/{m_block}")
    b, _, n = g.shape
    if bounds is not None and (
            mode != "inverse" or g.dtype not in (torch.int32, torch.int64)
            or tuple(bounds.shape) != (2, b) or bounds.dtype != torch.int64
            or bounds.device != g.device or not bounds.is_contiguous()):
        raise ValueError(f"bounds gate the inverse of an int32 or int64 "
                         f"operand: a contiguous (2, B) = (2, {b}) int64 "
                         f"tensor on {g.device}, not {mode!r} mode over "
                         f"{g.dtype}")
    if mode == "inverse":
        want = torch.int64 if bounds is not None else g.dtype
        if (corr is None or tuple(corr.shape) != (b, n)
                or corr.dtype != want or corr.device != g.device
                or not corr.is_contiguous()):
            raise ValueError(f"inverse mode needs a contiguous (B, N) = "
                             f"({b}, {n}) {want} corr on {g.device}")


def _check_out(out, shape, dtype, device) -> None:
    if out is not None and (tuple(out.shape) != shape or out.dtype != dtype
                            or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} {dtype} tensor "
                         f"on {device}")


def stream_raw(g: torch.Tensor, *, sign: int, mode: str, stream_rows: int,
               m_block: int, corr: torch.Tensor | None = None,
               row_offset: int = 0, stream_impl: str | None = None,
               out_dtype: torch.dtype | None = None,
               bounds: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Run the streamed kernel over ``g`` (B, rows, N), already in the
    dtype it sums in, in strips of ``stream_rows`` rows.

    Returns (B, N+1, N) in ``forward`` mode and (B, N, N) otherwise, in
    ``out_dtype`` (:func:`check_out_dtype`; default ``g.dtype``).  A
    CUDA operand launches K4 (``stream_impl="grid"``) or K5 (``"dma"``,
    the default) once on the current stream, raising if the launch is
    refused; a CPU operand takes :func:`stream_plain`.  ``bounds`` and
    ``out`` are one half of :func:`inverse_gated`: only the images that
    half runs are written, into ``out`` when given.
    """
    impl = resolve_impl(stream_impl)
    _check(g, sign, mode, corr, stream_rows, m_block, bounds)
    if g.device.type == "cpu":
        return stream_plain(g, sign=sign, mode=mode,
                            stream_rows=stream_rows, corr=corr,
                            row_offset=row_offset, out_dtype=out_dtype,
                            bounds=bounds, out=out)
    if g.device.type != "cuda":
        raise RuntimeError(f"K4/K5 run on CUDA or CPU tensors, not "
                           f"{g.device}")
    b, rows, n = g.shape
    out_rows = n + 1 if mode == "forward" else n
    tile = stream_tile(n, rows, g.element_size(), stream_rows, m_block,
                       out_rows, impl, batch=max(1, b),
                       sms=_sms(g.device.index or 0))
    return stream_launch_tile(g, tile, sign=sign, mode=mode, corr=corr,
                              row_offset=row_offset, stream_impl=impl,
                              out_dtype=out_dtype, bounds=bounds, out=out)


def stream_launch_tile(g: torch.Tensor, tile: StreamTile, *, sign: int,
                       mode: str, corr: torch.Tensor | None = None,
                       row_offset: int = 0,
                       stream_impl: str | None = None,
                       out_dtype: torch.dtype | None = None,
                       bounds: torch.Tensor | None = None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the streamed kernel over the CUDA operand ``g`` with an
    explicit ``tile`` (:func:`stream_raw` passes
    :func:`.tuning.stream_tile`'s; ``chip_smoke.py`` times others).  The
    kernel checks the tile against its own constants and budgets and
    the launch raises if it is refused."""
    global LAUNCHES, NARROW_LAUNCHES
    impl = resolve_impl(stream_impl)
    _check(g, sign, mode, corr, tile.stage_rows, tile.m_block, bounds)
    out_dtype = check_out_dtype(g, mode, out_dtype, bounds is not None)
    if g.device.type != "cuda":
        raise RuntimeError(f"the streamed kernel launches on CUDA tensors, "
                           f"not {g.device}")
    b, rows, n = g.shape
    out_rows = n + 1 if mode == "forward" else n
    _check_out(out, (b, out_rows, n), out_dtype, g.device)
    if out is None:
        out = torch.empty((b, out_rows, n), dtype=out_dtype, device=g.device)
    if b == 0:
        return out
    narrow = out_dtype != g.dtype
    tally = _tally(g.device) if bounds is not None and narrow else None
    lib = _lib()
    cuda_stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.stream_launch(
        _IMPLS[impl], _DTYPES[g.dtype], _DTYPES[out_dtype], g.data_ptr(),
        g.stride(0),
        None if corr is None else corr.data_ptr(), out.data_ptr(), b, rows,
        n, out_rows, tile.m_block, tile.warps, tile.cols, tile.items,
        tile.stage_rows, tile.slots, int(sign), _MODES[mode],
        int(row_offset), cuda_stream,
        None if bounds is None else bounds.data_ptr(),
        None if tally is None else tally.data_ptr())
    if err != 0:
        raise RuntimeError(
            f"streamed kernel launch failed ({impl}, {mode}, B={b}, "
            f"rows={rows}, N={n}, {tile}): "
            f"{lib.stream_error_string(err).decode()}")
    with _build.COUNT_LOCK:
        LAUNCHES += 1
        IMPL_MODE_LAUNCHES[(impl, mode)] += 1
        NARROW_LAUNCHES += narrow and mode != "inverse"
    _build.note_launch("stream", tile)
    return out


def narrow_fits(bounds: torch.Tensor, n: int) -> torch.Tensor:
    """The gate of each image (``csrc/stream.cu:narrow_fits``), a (B,)
    bool on ``bounds``' device: its least and largest values fit int32
    and N (hi - lo) < 2**32, so its inverse sums exactly in 32 bits."""
    lo, hi = bounds[0], bounds[1]
    return ((lo >= -2 ** 31) & (hi <= 2 ** 31 - 1)
            & (hi - lo <= (2 ** 32 - 1) // n))


def stream_plain(g: torch.Tensor, *, sign: int, mode: str, stream_rows: int,
                 corr: torch.Tensor | None = None, row_offset: int = 0,
                 out_dtype: torch.dtype | None = None,
                 bounds: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4/K5 (any device), in the streamed
    structure: for each strip of ``min(stream_rows, rows)`` rows, gather
    its partial skew-sum at the strip's global rows into one accumulator
    in ``g.dtype`` and place its row sums; the inverse epilogue runs
    once at the end; the result is stored in ``out_dtype``, as the
    kernel stores it.  With ``bounds`` it runs one half of
    :func:`inverse_gated` as the kernel does: an int32 operand's wrapped
    sums rebuilt from the gate's images' least values (which it adds to
    the tally), or an int64 operand's other images; the images the half
    leaves are ``out``'s (zero when not given)."""
    out_dtype = check_out_dtype(g, mode, out_dtype, bounds is not None)
    b, rows, n = g.shape
    dev = g.device
    h = max(1, min(int(stream_rows), rows))
    out_rows = n + 1 if mode == "forward" else n
    _check_out(out, (b, out_rows, n), out_dtype, dev)
    acc = torch.zeros((b, out_rows, n), dtype=g.dtype, device=dev)
    d = torch.arange(n, device=dev, dtype=torch.int64)
    for t0 in range(0, rows, h):
        strip = g[:, t0:t0 + h]
        ht = strip.shape[1]
        flat = strip.reshape(b, ht * n)
        i = torch.arange(ht, device=dev, dtype=torch.int64)
        glob = i + t0 + int(row_offset)
        chunk = max(1, _PLAIN_CHUNK // max(1, b * ht * n))
        for m0 in range(0, n, chunk):
            ms = torch.arange(m0, min(m0 + chunk, n), device=dev,
                              dtype=torch.int64)
            idx = (torch.remainder(d[None, None, :] + sign * ms[:, None, None]
                                   * glob[None, :, None], n)
                   + (i * n)[None, :, None])
            vals = flat[:, idx.reshape(-1)].reshape(b, len(ms), ht, n)
            acc[:, m0:m0 + len(ms)] += vals.sum(2, dtype=g.dtype)
        if mode == "forward":
            keep = (glob >= 0) & (glob < n)
            acc[:, n, glob[keep]] += strip.sum(2, dtype=g.dtype)[:, keep]
    if mode != "inverse":
        res = acc.to(out_dtype)
    elif bounds is None:
        total = acc + corr[:, :, None]
        res = (total / n if g.dtype.is_floating_point
               else torch.div(total, n, rounding_mode="floor"))
    else:
        fits = narrow_fits(bounds, n)
        if g.dtype == torch.int32:   # the true sum from its low 32 bits
            base = (n * bounds[0])[:, None, None]
            total = (base + ((acc.to(torch.int64) - base) & (2 ** 32 - 1))
                     + corr[:, :, None])
            _tally(dev).add_(fits.sum())
        else:
            total, fits = acc + corr[:, :, None], ~fits
        got = torch.div(total, n, rounding_mode="floor")
        keep = torch.zeros_like(got) if out is None else out
        res = torch.where(fits[:, None, None], got, keep)
    return res if out is None else out.copy_(res)


def inverse_gated(g: torch.Tensor, corr: torch.Tensor, *, stream_rows: int,
                  m_block: int, stream_impls=(None, None)) -> torch.Tensor:
    """The streamed inverse of an int64 operand ``g`` (B, N, N) with its
    int64 ``corr`` (B, N): each image sums in 32 bits where its values
    allow it (:func:`narrow_fits`), else in 64, chosen on the device.

    One pass, in the span :data:`NARROW_SPAN`, takes the (2, B) bounds
    (each image's least and largest value) and the operand's low 32
    bits; then the narrow variant runs on those bits and the int64
    kernel on ``g``, both with the bounds, each on its images, into one
    int64 output.  ``stream_impls`` are the two launches' ``stream_impl``
    (narrow, int64), as ``sfdprt._stream_route`` gives them by width.
    Nothing waits on the device."""
    global NARROW_INVERSE_LAUNCHES
    b, _, n = g.shape
    with record_function(NARROW_SPAN):
        bounds = torch.empty((2, b), dtype=torch.int64, device=g.device)
        torch.aminmax(g.flatten(1), dim=1, out=(bounds[0], bounds[1]))
        low = g.to(torch.int32)
    kw = dict(sign=-1, mode="inverse", stream_rows=stream_rows,
              m_block=m_block, corr=corr, bounds=bounds)
    narrow_impl, wide_impl = stream_impls
    out = stream_raw(low, stream_impl=narrow_impl, out_dtype=torch.int64,
                     **kw)
    out = stream_raw(g, stream_impl=wide_impl, out=out, **kw)
    with _build.COUNT_LOCK:
        NARROW_INVERSE_LAUNCHES += 1
    return out
