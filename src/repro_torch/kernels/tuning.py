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

:func:`skew_tile` (K1), :func:`pipeline_tile` (K2) and :func:`tail_tile`
(K3) are the Hopper resolution of the register-tiled skew-sum the
kernels share (``csrc/skew_tile.cuh``): the columns a lane holds per
item, the directions per block and its warps, the stage height and ring
depth, and for K2 and K3 the layout of their shared memory.
``strip_rows`` caps K1's stage height and ``m_block`` caps the
directions per block of all three.

The serving tier's warm batch sizes (:data:`SERVE_WARM_BATCHES`,
:func:`warm_batch_sizes`, :func:`router_warm_sizes`,
:func:`nearest_warm_batch`) are the reference's rules, copied.
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple

__all__ = ["PALLAS_TUNE", "pallas_block_spec", "resolve_blocks",
           "wasted_direction_rows", "PIPELINE_TUNE", "pipeline_block_spec",
           "resolve_pipeline_blocks", "check_strip_knobs",
           "STREAM_SMEM_BUDGET", "STREAM_SHAPES", "STREAM_WARPS",
           "StreamTile", "stream_row_bytes", "stream_smem", "stream_tile",
           "stream_dma_holds",
           "SKEW_ITEMS", "SKEW_COLS", "SKEW_WARPS", "SKEW_SMEM_BUDGET",
           "PIPE_WARPS", "PIPE_ITEMS", "SkewTile", "skew_cols", "conv_run",
           "skew_row_bytes", "skew_holds", "skew_geometry", "skew_tile",
           "PipelineTile", "pipeline_geometry", "pipeline_tile",
           "tail_tile", "SERVE_WARM_BATCHES", "warm_batch_sizes",
           "ROUTER_TRIM_N", "router_warm_sizes", "nearest_warm_batch"]

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


def stream_dma_holds(n: int, itemsize: int) -> bool:
    """Whether K5's ring holds two padded rows of N, as it must to stream
    more than one stage (N <= 28613 for 4-byte values, 14291 for 8-byte
    ones); K4 streams through one stage."""
    return ((STREAM_SMEM_BUDGET - STREAM_BARRIER_BYTES)
            // stream_row_bytes(n, itemsize) >= 2)


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


# ---------------------------------------------------------------------------
# K1 and K2 on Hopper: the register-tiled skew-sum (csrc/skew_tile.cuh)
# ---------------------------------------------------------------------------
#: items a warp holds per accumulator width in bytes (``kItems``)
SKEW_ITEMS = {4: 8, 8: 4}
#: the columns K a lane may hold per item: the kernels' instantiations
SKEW_COLS = (1, 2, 4, 8)
#: K1: consumer warps per block at most (``csrc/sfdprt.cu: kMaxWarps``);
#: with the producer 256 threads, two blocks of which leave ptxas 128
#: registers a thread
SKEW_WARPS = 7
#: K1: shared memory one block's ring may take, so that three blocks
#: share an SM (228 KB, 1 KB of it reserved per block); a ring of two
#: rows that does not fit takes a block's whole 227 KB instead
SKEW_SMEM_BUDGET = 72 * 1024
#: K1 and K2: the stages a ring is sized for: at radon_251 two tall
#: stages run as fast as three shorter ones and faster than four
#: (``chip_smoke.py``'s sweep of K1's stage shape; ``PERF.md``)
SKEW_TARGET_SLOTS = 2
#: K1: what streaming its rows costs a block beside its directions, in
#: units of one direction (the waves choice of directions per block): at
#: radon_251 a block's pass over the image costs as much as some 50-70
#: directions (``chip_smoke.py``'s sweep of D; ``PERF.md``)
SKEW_BLOCK_COST = 64
#: K2: consumer warps per block at most (``csrc/pipeline.cu:
#: kPipeMaxWarps``); with the producer 12 warps, one block per SM, which
#: leaves ptxas 168 registers a thread (13 to 16 warps leave 128, and
#: the 32-bit instantiations spilled there)
PIPE_WARPS = 11
PIPE_THREAD_REGS = 168
#: K2: items a warp holds per accumulator width (``kPipeItems``): six for
#: 4-byte sums, whose 64 accumulators at eight spilled at 168 registers
PIPE_ITEMS = {4: 6, 8: 4}
#: per SM: registers, shared memory, threads; and the registers a K1
#: thread takes at most under its launch bounds
SM_REGS = 65536
SM_SMEM = 228 * 1024
SM_THREADS = 2048
MAX_THREAD_REGS = 128


def skew_cols(n: int) -> int:
    """The columns K a lane holds per item at N: the one of
    :data:`SKEW_COLS` whose runs of ``32*K`` columns cost the fewest
    instructions per row, ``runs * (2K + 3)`` (K loads and adds per item
    plus its window step); the larger K on a tie.  N = 251: K = 8, one run
    of 256 columns."""
    def cost(k):
        return -(-n // (32 * k)) * (2 * k + 3), -k
    return min(SKEW_COLS, key=cost)


def conv_run(cols: int) -> int:
    """R, the consecutive conv outputs a lane owns in K2
    (``kConvRun``): odd, so that the lanes' loads at stride R hit 32
    banks, and >= ``cols``, so that a padded rc row fits its slot."""
    return 1 if cols == 1 else cols + 1


def skew_row_bytes(n: int, cols: int, itemsize: int) -> int:
    """Bytes of one staged row's slot in K1's and K2's rings: the row, its
    padding of ``32*cols - 1`` columns, and up to 15 bytes of lead that
    put it at its source's address mod 16."""
    return _align16((n + 32 * cols - 1) * itemsize) + 16


def _ring(fit: int, rows: int, cap: int) -> tuple[int, int]:
    """(stage rows, slots) of a ring in ``fit`` padded row slots for
    ``rows`` rows: stages of at most ``cap`` rows sized for
    :data:`SKEW_TARGET_SLOTS` of them, as many as fit up to
    :data:`STREAM_MAX_SLOTS` and the stage count, and two at least when
    there is more than one stage (the producer pads a stage after it
    issues the next)."""
    h = max(1, min(cap, rows, fit // SKEW_TARGET_SLOTS))
    stages = -(-rows // h)
    slots = min(STREAM_MAX_SLOTS, stages, max(fit // h, 2))
    return h, slots


class SkewTile(NamedTuple):
    """K1's launch geometry (``csrc/sfdprt.cu``).  The kernel takes every
    field as given and only checks it against its compile-time constants
    and budgets."""
    stage_rows: int     # rows per shared-memory stage (<= strip_rows)
    slots: int          # stages in the ring
    m_block: int        # D: directions per block (<= m_block)
    cols: int           # columns a lane holds per item
    items: int          # items a consumer warp holds
    warps: int          # consumer warps per block (plus one producer)
    runs: int           # column runs of 32*cols per direction
    pad: int            # padding columns after each staged row
    row_bytes: int      # bytes of one padded row slot (16-multiple)
    smem: int           # dynamic shared memory of one block
    blocks: int         # blocks per image
    per_sm: int         # blocks an SM holds at once (registers, smem)


def _skew_warps(d: int, n: int, runs: int, items: int) -> int:
    return max(1, -(-min(d, n) * runs // items))


def _per_sm(warps: int, smem: int) -> int:
    threads = (warps + 1) * 32
    return max(1, min(SM_REGS // (threads * MAX_THREAD_REGS),
                      SM_SMEM // (smem + 1024), SM_THREADS // threads))


def _skew_fit(n: int, itemsize: int) -> int:
    """Padded rows of N that K1's ring may hold: those of
    :data:`SKEW_SMEM_BUDGET` when two fit there, else of a whole block's
    227 KB."""
    row = skew_row_bytes(n, skew_cols(n), itemsize)
    fit = (SKEW_SMEM_BUDGET - STREAM_BARRIER_BYTES) // row
    if fit < 2:
        fit = (STREAM_SMEM_BUDGET - STREAM_BARRIER_BYTES) // row
    return fit


def skew_holds(n: int, itemsize: int) -> bool:
    """Whether K1 holds one direction of N ``itemsize``-byte sums in the
    registers of a block (:data:`SKEW_WARPS` warps of ``items`` items of
    ``32*K`` columns: N <= 14336 for 4-byte sums, 7168 for 8-byte ones)
    and a ring of two of its padded rows in shared memory.  Where it does
    not, the raw functions of ``kernels/sfdprt.py`` launch the streamed
    kernel K5, whose block holds 37440 / 20160 columns."""
    runs = -(-n // (32 * skew_cols(n)))
    return (runs <= SKEW_WARPS * SKEW_ITEMS[itemsize]
            and _skew_fit(n, itemsize) >= 2)


def skew_geometry(n: int, itemsize: int, out_rows: int, m_block: int,
                  stage_rows: int, slots: int) -> SkewTile:
    """K1's tile with D = ``m_block`` directions per block and a ring of
    ``slots`` stages of ``stage_rows`` rows: every other field follows
    from these (:func:`skew_tile` chooses them; ``chip_smoke.py``'s sweeps
    build their tiles here)."""
    cols = skew_cols(n)
    items = SKEW_ITEMS[itemsize]
    runs = -(-n // (32 * cols))
    row = skew_row_bytes(n, cols, itemsize)
    d = int(m_block)
    warps = _skew_warps(d, n, runs, items)
    smem = STREAM_BARRIER_BYTES + int(slots) * int(stage_rows) * row
    return SkewTile(stage_rows=int(stage_rows), slots=int(slots), m_block=d,
                    cols=cols, items=items, warps=warps, runs=runs,
                    pad=32 * cols - 1, row_bytes=row, smem=smem,
                    blocks=-(-int(out_rows) // d),
                    per_sm=_per_sm(warps, smem))


@functools.lru_cache(maxsize=1024)
def skew_tile(n: int, rows: int, itemsize: int, strip_rows: int,
              m_block: int, out_rows: int, batch: int = 1,
              sms: int = H100_SMS) -> SkewTile:
    """K1's geometry (:class:`SkewTile`) for ``batch`` operands of
    (rows, N) with ``out_rows`` output rows.

    K from N (:func:`skew_cols`).  Shared memory holds the ring: the
    stage height fits :data:`SKEW_TARGET_SLOTS` stages in
    :data:`SKEW_SMEM_BUDGET`, capped by ``strip_rows`` and ``rows``.
    Registers bound the directions per block D: at most
    :data:`SKEW_WARPS` consumer warps of ``items`` items of ``32*K``
    columns, capped by ``m_block`` and the output rows; D is then the
    value in [ceil(that / 2), that] whose blocks finish in the least
    time, as waves (at least one) of ``sms`` SMs times the blocks an SM
    holds, each costing :data:`SKEW_BLOCK_COST` plus one per direction
    (the larger on a tie): a large batch takes the largest D, a batch of
    one image spreads over more, smaller blocks.
    Raises ValueError where K1 cannot hold one direction
    (:func:`skew_holds`).  Integer results depend on none of it.  Cached:
    every launch asks, and the search over D would otherwise cost a
    launch of one image more than the kernel."""
    if not skew_holds(n, itemsize):
        cols = skew_cols(n)
        raise ValueError(
            f"K1 cannot hold one direction of N={n} {itemsize}-byte sums in "
            f"the registers of one block ({SKEW_WARPS} warps x "
            f"{SKEW_ITEMS[itemsize]} items x {32 * cols} columns) and two "
            f"padded rows in {STREAM_SMEM_BUDGET}-byte shared memory; the "
            f"raw functions stream such N through K5")
    cols = skew_cols(n)
    items = SKEW_ITEMS[itemsize]
    runs = -(-n // (32 * cols))
    row = skew_row_bytes(n, cols, itemsize)
    h, slots = _ring(_skew_fit(n, itemsize), int(rows),
                     max(1, int(strip_rows)))
    smem = STREAM_BARRIER_BYTES + slots * h * row
    dmax = max(1, min(int(m_block), int(out_rows),
                      SKEW_WARPS * items // runs))
    best, best_cost = dmax, None
    for d in range(dmax, max(1, -(-dmax // 2)) - 1, -1):
        per_sm = _per_sm(_skew_warps(d, n, runs, items), smem)
        waves = max(1.0, int(batch) * -(-int(out_rows) // d)
                    / (sms * per_sm))
        cost = waves * (SKEW_BLOCK_COST + d)
        if best_cost is None or cost < best_cost:
            best, best_cost = d, cost
    return skew_geometry(n, itemsize, out_rows, best, h, slots)


class PipelineTile(NamedTuple):
    """The launch geometry and shared-memory layout of K2 and K3
    (``csrc/pipeline.cu``).  The kernels take every field as given and
    only check it against their compile-time constants and budgets."""
    stage_rows: int     # rows per stage of the image's ring (K3: 0)
    slots: int          # stages in the ring (K3: 0, no ring)
    m_block: int        # D: directions per block (<= m_block)
    cols: int           # columns a lane holds per item (skew-sums)
    items: int          # items a consumer warp holds
    warps: int          # consumer warps per block (K2: plus one producer)
    runs: int           # column runs of 32*cols per direction
    pad: int            # padding columns of a staged or rc row
    row_bytes: int      # bytes of one padded staged row (K3: 0)
    conv_run: int       # R: consecutive conv outputs a lane owns
    conv_passes: int    # P: runs of 32*R outputs per direction
    e_slot: int         # elements of one direction's slot
    rc_off: int         # where a direction's rc row starts in its slot
    rf_bytes: int       # bytes of the rf rows (conv), else 0
    smem: int           # dynamic shared memory of one block
    blocks: int         # blocks per image


def pipeline_geometry(n: int, itemsize: int, op: str, m_block: int,
                      stage_rows: int | None = None, source: str = "image",
                      rows: int | None = None) -> PipelineTile:
    """The tile with D = ``m_block`` directions per block: the layout of
    its shared memory -- the barriers, the rf rows (conv: D + 1 of N),
    then the D direction slots.  A conv slot holds its direction's
    operand row extended to columns -(N-1) .. 32R*P, then its padded rc
    row (for P > 1 runs behind the operand's columns, which later runs
    still read); a mul or none slot holds the padded rc row.

    ``source="image"`` is K2's: a ring of image stages, capped at
    ``stage_rows`` rows (N by default), aliases the slots, and its
    consumer warps hold the forward's D directions; the blocks of an
    image cover its N + 1 directions.  ``source="proj"`` is K3's: no
    forward and no ring, so the warps are the most that the inverse's
    items of one output row band can use (:data:`PIPE_WARPS` at most),
    and the blocks cover the shard's ``rows`` rows.  :func:`pipeline_tile`
    and :func:`tail_tile` choose D; ``chip_smoke.py``'s edges and sweeps
    build their tiles here."""
    cols = skew_cols(n)
    items = PIPE_ITEMS[itemsize]
    runs = -(-n // (32 * cols))
    d = int(m_block)
    pad = 32 * cols - 1
    r = conv_run(cols)
    passes = -(-n // (32 * r))
    if op == "conv":
        reach = 32 * r * passes
        e_slot = n - 1 + (reach if passes == 1 else max(reach, n + pad))
        rc_off = 0 if passes == 1 else n - 1
        rf = _align16((d + 1) * n * itemsize)
    else:
        e_slot, rc_off, rf = n + pad, 0, 0
    area = _align16(d * e_slot * itemsize)
    if source == "image":
        row = skew_row_bytes(n, cols, itemsize)
        h, slots = _ring(area // row, n, n if stage_rows is None
                         else int(stage_rows))
        warps = _skew_warps(d, n, runs, items)
        covered = n + 1
    elif source == "proj":
        row = h = slots = 0
        warps = min(PIPE_WARPS, -(-n * runs // items))
        covered = int(rows)
    else:
        raise ValueError(f"pipeline source must be 'image' or 'proj', got "
                         f"{source!r}")
    return PipelineTile(stage_rows=h, slots=slots, m_block=d, cols=cols,
                        items=items, warps=warps, runs=runs, pad=pad,
                        row_bytes=row, conv_run=r, conv_passes=passes,
                        e_slot=e_slot, rc_off=rc_off, rf_bytes=rf,
                        smem=STREAM_BARRIER_BYTES + rf + max(
                            area, slots * h * row),
                        blocks=-(-covered // d))


@functools.lru_cache(maxsize=1024)
def pipeline_tile(n: int, itemsize: int, m_block: int,
                  op: str) -> PipelineTile:
    """K2's geometry (:class:`PipelineTile`, laid out by
    :func:`pipeline_geometry`) for ``op`` at N.

    One block per SM.  K from N (:func:`skew_cols`), R from K
    (:func:`conv_run`).  D is the most directions that ``m_block``, N + 1,
    the registers (:data:`PIPE_WARPS` consumer warps of
    :data:`PIPE_ITEMS` items) and the 227 KB of shared memory allow, then
    spread evenly over the blocks of an image.  Raises ValueError when
    not one direction fits.  Integer results depend on none of it."""
    cols = skew_cols(n)
    items = PIPE_ITEMS[itemsize]
    runs = -(-n // (32 * cols))
    d = min(int(m_block), n + 1, PIPE_WARPS * items // runs)
    while d >= 1 and pipeline_geometry(n, itemsize, op,
                                       d).smem > STREAM_SMEM_BUDGET:
        d -= 1
    if d < 1:
        raise ValueError(
            f"one direction of N={n} {itemsize}-byte values (with its "
            f"operand and padded rows for op={op!r}) does not fit the "
            f"pipeline kernel's registers ({PIPE_WARPS} warps x {items} "
            f"items x {32 * cols} columns) and {STREAM_SMEM_BUDGET}-byte "
            f"shared memory")
    blocks = -(-(n + 1) // d)
    return pipeline_geometry(n, itemsize, op, -(-(n + 1) // blocks))


@functools.lru_cache(maxsize=1024)
def tail_tile(n: int, itemsize: int, m_block: int, op: str,
              rows: int) -> PipelineTile:
    """K3's geometry (:class:`PipelineTile` with ``source="proj"``, laid
    out by :func:`pipeline_geometry`) for a shard of ``rows`` direction
    rows at N.

    One block per SM, as K2's, with no forward and no ring: D is the
    most directions that ``m_block``, the shard's rows, N + 1 and the
    227 KB of shared memory (D slots, plus D + 1 rf rows for conv)
    allow, then spread evenly over the blocks of an image.  Raises
    ValueError when not one direction fits.  Integer results depend on
    none of it."""
    d = min(int(m_block), int(rows), n + 1)
    while d >= 1 and pipeline_geometry(n, itemsize, op, d, source="proj",
                                       rows=rows).smem > STREAM_SMEM_BUDGET:
        d -= 1
    if d < 1:
        raise ValueError(
            f"one direction of N={n} {itemsize}-byte values (with its "
            f"operand and padded rows for op={op!r}) does not fit the "
            f"pipeline tail kernel's {STREAM_SMEM_BUDGET}-byte shared "
            f"memory")
    blocks = -(-int(rows) // d)
    return pipeline_geometry(n, itemsize, op, -(-int(rows) // blocks),
                             source="proj", rows=rows)


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


# ---------------------------------------------------------------------------
# serving tier: warm batch sizes (the reference's rules, unchanged)
# ---------------------------------------------------------------------------
# The dynamic batcher pads coalesced request groups up to one of these
# batch sizes, so a service keeps one executable per size and per
# (geometry, dtype, datapath) -- every admitted group hits a warm stack
# shape instead of building for its exact count.  Powers of two bound
# the padding waste below 2x.
SERVE_WARM_BATCHES = (1, 2, 4, 8, 16)


def warm_batch_sizes(max_batch: int) -> tuple:
    """The warm sizes a service with admission limit ``max_batch`` keeps
    compiled: table entries up to ``max_batch``, plus ``max_batch``
    itself (an off-table limit still gets an exact-fit executable)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = [b for b in SERVE_WARM_BATCHES if b <= max_batch]
    if not sizes or sizes[-1] != max_batch:
        sizes.append(max_batch)
    return tuple(sizes)


#: routed keys at/above this geometry get a trimmed warm ladder: a
#: multi-tenant router keeping the full ladder for every resident giant
#: geometry would hold that many warm stacks' plans and buffers per
#: route, which the LRU eviction exists to bound.
ROUTER_TRIM_N = 509


def router_warm_sizes(n: int, max_batch: int) -> tuple:
    """Warm batch sizes for one routed ``(geometry, dtype, datapath)``
    key: the full :func:`warm_batch_sizes` ladder for small geometries,
    trimmed to ``(1, max_batch)`` once ``n >= ROUTER_TRIM_N``."""
    if n >= ROUTER_TRIM_N and max_batch > 1:
        return (1, int(max_batch))
    return warm_batch_sizes(max_batch)


def nearest_warm_batch(count: int, sizes) -> int:
    """Smallest warm size >= ``count`` (the padding target for one
    coalesced batch).  ``count`` above every size is a caller bug: the
    admission loop never collects more than the largest warm size."""
    for b in sizes:
        if b >= count:
            return int(b)
    raise ValueError(f"batch of {count} exceeds warm sizes {tuple(sizes)}")
