"""(N -> strip_rows H, m_block M) block resolution for the SFDPRT kernel.

The port of the transform and pipeline halves of
:mod:`repro.kernels.tuning`.  The tables and the heuristics are copied
unchanged so that every knob resolves to the same ``(strip_rows,
m_block)`` and pipeline ``(m_block, group)`` as the reference, and a
plan's ``describe()`` reads the same in both packages.

**These rows are the reference's, not H100 measurements.**  They were
chosen for the TPU kernels (CPU-interpret timings and VMEM budgets).
On Hopper ``m_block`` is the number of directions one thread block
owns (K2 further caps it by the shared memory a block can hold), and
``strip_rows`` caps the rows staged through shared memory per step (K1
further caps it the same way); integer results depend on neither.  The
pipeline's ``group`` (the TPU kernel's conv tap group) changes nothing
on Hopper.  Rows measured on the card replace these in a later change.

:func:`stream_tile` is the Hopper resolution of the streamed kernel's
tile (K4/K5): how many directions' partial sums a block keeps in
registers, how its warps split them, and how many rows each stage of
its shared-memory ring holds.  ``stream_rows`` caps the stage height
there, it does not set it, and a plan reports the knob unchanged.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

__all__ = ["PALLAS_TUNE", "pallas_block_spec", "resolve_blocks",
           "wasted_direction_rows", "PIPELINE_TUNE", "pipeline_block_spec",
           "resolve_pipeline_blocks", "check_strip_knobs",
           "STREAM_SMEM_BUDGET", "STREAM_SHAPES", "STREAM_WARPS",
           "StreamTile", "stream_row_bytes", "stream_smem", "stream_tile"]

# N values already warned about (once per process per N).
_FALLBACK_WARNED: set = set()
_PIPELINE_FALLBACK_WARNED: set = set()


def _warn_off_table(n: int, table: dict, warned: set, kind: str) -> None:
    """Warn once when N falls off the top of the table."""
    top = max(table)
    if n > top and n not in warned:
        warned.add(n)
        warnings.warn(
            f"N={n} is beyond the largest {kind} tuning row (N={top}); "
            f"using the heuristic block-shape fallback. Pass "
            f"strip_rows/m_block explicitly if performance matters at "
            f"this size.", stacklevel=3)


# N: (strip_rows H, m_block M) -- the reference's table, row for row.
PALLAS_TUNE = {
    2: (2, 8),
    3: (3, 8),
    5: (5, 8),
    7: (7, 8),
    11: (11, 8),
    13: (13, 8),
    17: (17, 8),
    31: (31, 8),
    61: (61, 16),
    127: (127, 16),
    251: (251, 32),
    509: (256, 32),
    1021: (256, 64),
    2053: (256, 64),
    4099: (256, 64),
}


def pallas_block_spec(n: int, itemsize: int = 4) -> tuple[int, int]:
    """Table (strip_rows, m_block) for prime N; the reference's
    heuristic off-table (``itemsize`` is the accumulator's bytes)."""
    if n in PALLAS_TUNE:
        return PALLAS_TUNE[n]
    _warn_off_table(n, PALLAS_TUNE, _FALLBACK_WARNED, "pallas")
    if n <= 32:
        return n, 8
    h = min(n, 128)
    m_block = 64 if n >= 128 else 16
    n_pad = ((n + 127) // 128) * 128
    budget = 2 * 1024 * 1024
    while (h + 2 * m_block) * n_pad * itemsize > budget:
        if h > 8:
            h //= 2
        elif m_block > 8:
            m_block //= 2
        else:
            break
    return max(h, 1), m_block


def check_strip_knobs(block_rows=None, stream_rows=None) -> None:
    """The ``block_rows`` / ``stream_rows`` validation of
    :func:`resolve_blocks` alone (the plan layer runs it first)."""
    if block_rows is not None and stream_rows is not None:
        raise ValueError(
            f"block_rows={block_rows} and stream_rows={stream_rows} are "
            "mutually exclusive: block_rows scans separate kernel "
            "launches over row strips (the staged fallback), stream_rows "
            "streams strips through ONE fused launch. Pick one.")
    if stream_rows is not None and int(stream_rows) < 1:
        raise ValueError(f"stream_rows must be >= 1, got {stream_rows}")


def resolve_blocks(n: int, itemsize: int = 4,
                   strip_rows=None, m_block=None, block_rows=None,
                   stream_rows=None) -> tuple[int, int]:
    """Fill missing (strip_rows, m_block) from the table, validate given.

    ``block_rows`` (the scan-of-launches fallback) and ``stream_rows``
    (the streamed kernel) both partition the image into row strips;
    asking for both is ambiguous and rejected.
    """
    check_strip_knobs(block_rows, stream_rows)
    th, tm = pallas_block_spec(n, itemsize)
    h = th if strip_rows is None else int(strip_rows)
    mb = tm if m_block is None else int(m_block)
    if h < 1 or mb < 1:
        raise ValueError(f"strip_rows/m_block must be >= 1, got {h}/{mb}")
    return h, mb


#: shared memory one streamed block may use: the H100's opt-in maximum
#: per block (227 KB), so one block runs per SM at giant N
STREAM_SMEM_BUDGET = 227 * 1024
#: the streamed kernel's register tile per accumulator width in bytes
#: (``csrc/stream.cu: Shape``): (columns a lane holds per item, items a
#: warp holds).  Lane L of an item's warp owns the outputs d = 32*cols*c
#: + L + 32*j, j < cols, of one direction m and column run c.
STREAM_SHAPES = {4: (13, 6), 8: (7, 6)}
#: consumer warps per streamed block at most, by ``stream_impl``: K5's 15
#: and its producer warp leave ptxas 128 registers a thread (a 17th warp
#: spills); K4, whose consumers also copy the stages, spills at 14 and
#: 15 warps too and takes 12 (``csrc/stream.cu: kWarps``)
STREAM_WARPS = {"dma": 15, "grid": 12}
#: stages in K5's ring: at most (mbarrier pairs in shared memory) and the
#: depth the stage height is chosen for
STREAM_MAX_SLOTS = 8
STREAM_TARGET_SLOTS = 3
#: the mbarriers at the head of the block's shared memory (landed, full,
#: empty per slot)
STREAM_BARRIER_BYTES = 3 * STREAM_MAX_SLOTS * 8
#: SMs of an H100 SXM, the default wave width of the direction choice
H100_SMS = 132
#: what streaming the rows costs a block beside its directions, in units
#: of one direction: a K5 block at N = 4099 took about 2.16 + 0.093*D ms
#: (``chip_smoke.py``'s sweep of D, NVIDIA H100 80GB HBM3, 700 W)
STREAM_BLOCK_COST = 23


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


class StreamTile(NamedTuple):
    """The launch geometry of the streamed kernel (``csrc/stream.cu``)."""
    stage_rows: int     # rows per shared-memory stage (<= stream_rows)
    slots: int          # stages in the ring (K5) or 1 (K4)
    m_block: int        # D: directions per block (<= m_block)
    cols: int           # columns a lane holds per item
    items: int          # items a consumer warp holds
    warps: int          # consumer warps per block
    runs: int           # column runs of 32*cols per direction
    pad: int            # padding columns after each staged row
    row_bytes: int      # bytes of one padded row slot (16-multiple)
    smem: int           # dynamic shared memory of one block
    blocks: int         # blocks per image


def stream_row_bytes(n: int, itemsize: int) -> int:
    """Bytes of one staged row's slot: the row, its padding of
    ``32*cols - 1`` columns, and up to 15 bytes of lead that puts it at
    its source's address mod 16."""
    cols, _ = STREAM_SHAPES[itemsize]
    return _align16((n + 32 * cols - 1) * itemsize) + 16


def stream_smem(n: int, itemsize: int, stage_rows: int, slots: int) -> int:
    """Bytes of shared memory a streamed block takes (the layout of
    ``csrc/stream.cu``): the ring's mbarriers, then ``slots`` stages of
    ``stage_rows`` padded row slots."""
    return (STREAM_BARRIER_BYTES
            + slots * stage_rows * stream_row_bytes(n, itemsize))


def _direction_block(dmax: int, out_rows: int, batch: int, sms: int) -> int:
    """The directions per block in [ceil(3*dmax/4), dmax] that finish the
    blocks in the least time, as waves of ``sms`` blocks that each cost
    :data:`STREAM_BLOCK_COST` plus one per direction; the larger on a
    tie."""
    best, best_cost = dmax, None
    for d in range(dmax, max(1, -(-3 * dmax // 4)) - 1, -1):
        waves = -(-batch * -(-out_rows // d) // sms)
        cost = waves * (STREAM_BLOCK_COST + d)
        if best_cost is None or cost < best_cost:
            best, best_cost = d, cost
    return best


def stream_tile(n: int, rows: int, itemsize: int, stream_rows: int,
                m_block: int, out_rows: int, stream_impl: str = "dma",
                batch: int = 1, sms: int = H100_SMS) -> StreamTile:
    """The geometry the streamed kernel runs with (:class:`StreamTile`).

    Registers set the directions per block D: a block of at most
    :data:`STREAM_WARPS` consumer warps holds that many times ``items``
    items of ``32 * cols`` columns, so ``floor(that / runs)`` directions,
    capped by ``m_block`` and the output rows, and lowered by at most a
    quarter where that fills the waves of ``sms`` SMs better for
    ``batch`` images (:func:`_direction_block`).  Shared memory holds only stages: the stage height
    is the rows that let :data:`STREAM_TARGET_SLOTS` stages fit (K5; K4
    has one stage of all that fit), capped by ``stream_rows`` and
    ``rows``, and K5's ring takes as many such stages as fit, up to
    :data:`STREAM_MAX_SLOTS` and the stage count.  Raises ValueError
    when not one direction fits the registers of a block or not one
    padded row its shared memory.  Integer results depend on none of it.
    """
    cols, items = STREAM_SHAPES[itemsize]
    max_warps = STREAM_WARPS[stream_impl]
    runs = -(-n // (32 * cols))
    row = stream_row_bytes(n, itemsize)
    fit = (STREAM_SMEM_BUDGET - STREAM_BARRIER_BYTES) // row
    if runs > max_warps * items or fit < 1:
        raise ValueError(
            f"the streamed kernel cannot hold one direction of N={n} "
            f"{itemsize}-byte sums in the registers of one block "
            f"({max_warps} warps x {items} items x {32 * cols} columns) "
            f"and one padded row in its {STREAM_SMEM_BUDGET}-byte shared "
            f"memory")
    cap = max(1, min(int(stream_rows), int(rows)))
    if stream_impl == "dma":
        h = min(cap, max(1, fit // STREAM_TARGET_SLOTS))
        slots = min(STREAM_MAX_SLOTS, fit // h, -(-int(rows) // h))
    else:
        h, slots = min(cap, fit), 1
    dmax = max(1, min(int(m_block), int(out_rows),
                      max_warps * items // runs))
    d = _direction_block(dmax, int(out_rows), int(batch), int(sms))
    return StreamTile(stage_rows=h, slots=slots, m_block=d, cols=cols,
                      items=items, warps=-(-d * runs // items), runs=runs,
                      pad=32 * cols - 1, row_bytes=row,
                      smem=stream_smem(n, itemsize, h, slots),
                      blocks=-(-int(out_rows) // d))


def wasted_direction_rows(n: int, m_block: int, forward: bool = True) -> int:
    """Rows of the final m-block past the last output row: the kernel
    neither computes nor writes them."""
    rows = n + 1 if forward else n
    return math.ceil(rows / m_block) * m_block - rows


# ---------------------------------------------------------------------------
# projection-domain pipeline (fused fwd -> per-direction op -> inverse)
# ---------------------------------------------------------------------------
# N: (m_block M, conv tap group K) -- the reference's table, row for row.
# The pipeline runs the whole image per direction block, so its only
# knobs are the direction block M and the TPU kernel's tap group K.
PIPELINE_TUNE = {
    61: (62, 4),
    127: (64, 4),
    251: (64, 4),
    509: (64, 4),
    1021: (64, 4),
    2053: (64, 4),
    4099: (64, 4),
}


def pipeline_block_spec(n: int, itemsize: int = 4) -> tuple[int, int]:
    """Table (m_block, group) for the fused pipeline; the reference's
    heuristic off-table."""
    if n in PIPELINE_TUNE:
        return PIPELINE_TUNE[n]
    _warn_off_table(n, PIPELINE_TUNE, _PIPELINE_FALLBACK_WARNED, "pipeline")
    if n <= 61:
        return n + 1, 4         # one m-block covers every direction row
    return 64, 4


def resolve_pipeline_blocks(n: int, itemsize: int = 4,
                            m_block=None, group=None) -> tuple[int, int]:
    """Fill missing pipeline (m_block, group) from the table, validate."""
    tm, tg = pipeline_block_spec(n, itemsize)
    mb = tm if m_block is None else int(m_block)
    k = tg if group is None else int(group)
    if mb < 1 or k < 1:
        raise ValueError(f"m_block/group must be >= 1, got {mb}/{k}")
    return mb, k
