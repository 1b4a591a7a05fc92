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
tile (K4/K5): how many directions' partial sums a block keeps in shared
memory and how many rows one of its stages holds.  ``stream_rows`` caps
the stage height there, it does not set it, and a plan reports the knob
unchanged.
"""
from __future__ import annotations

import math
import warnings

__all__ = ["PALLAS_TUNE", "pallas_block_spec", "resolve_blocks",
           "wasted_direction_rows", "PIPELINE_TUNE", "pipeline_block_spec",
           "resolve_pipeline_blocks", "check_strip_knobs", "STREAM_SMEM_BUDGET", "stream_smem",
           "stream_tile"]

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


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def stream_smem(n: int, itemsize: int, m_block: int, stage_rows: int,
                stream_impl: str = "dma") -> int:
    """Bytes of shared memory a streamed block takes (the layout of
    ``csrc/stream.cu``): ``m_block`` rows of accumulators, a start-index
    table, and two stages of ``stage_rows`` rows for ``dma`` (one for
    ``grid``), each with 16 bytes of slack."""
    slots = 2 if stream_impl == "dma" else 1
    return (_align16(m_block * n * itemsize) + _align16(4 * m_block)
            + slots * _align16(stage_rows * n * itemsize + 16))


def stream_tile(n: int, rows: int, itemsize: int, stream_rows: int,
                m_block: int, out_rows: int,
                stream_impl: str = "dma") -> tuple[int, int]:
    """(stage_rows, m_block) the streamed kernel runs with.

    The block's accumulators take at most half of
    :data:`STREAM_SMEM_BUDGET` (at least one direction), capped by
    ``m_block`` and the output rows; the stages take the rest, capped by
    ``stream_rows`` and ``rows``.  Raises ValueError when not one
    direction and one row fit.  Integer results depend on neither.
    """
    row = n * itemsize
    mb = max(1, min(int(m_block), int(out_rows),
                    (STREAM_SMEM_BUDGET // 2) // row))
    fixed = stream_smem(n, itemsize, mb, 0, stream_impl)
    slots = 2 if stream_impl == "dma" else 1
    fit = ((STREAM_SMEM_BUDGET - fixed) // slots) // row
    if fit < 1:
        raise ValueError(
            f"the streamed kernel cannot hold one direction and one row of "
            f"N={n} {itemsize}-byte values in its {STREAM_SMEM_BUDGET}-byte "
            f"shared-memory budget")
    h = max(1, min(int(stream_rows), int(rows), fit))
    while stream_smem(n, itemsize, mb, h, stream_impl) > STREAM_SMEM_BUDGET:
        h -= 1                  # the 16-byte alignment of the last stage
    if h < 1:
        raise ValueError(
            f"the streamed kernel cannot hold one row of N={n} "
            f"{itemsize}-byte values beside its accumulators")
    return h, mb


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
