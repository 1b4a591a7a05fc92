"""The register tile that K1 (``csrc/sfdprt.cu``), K2 and K3
(``csrc/pipeline.cu``) share (``csrc/skew_tile.cuh``), as pure arithmetic
on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them
against their plain versions there).  These tests pin the tiles of
``kernels/tuning.py`` at the main path's shapes, check that they fit
an SM's registers and shared memory, and run Python models of the
kernels' thread maps: every output is covered exactly once, every
window stays inside its padded row and loads the column the skew-sum
needs, K2's conv window (a ring of R registers rotated by unrolling)
computes the circular convolution, and its rc rows are written only
where no later read of the direction's slot falls.  K3 is K2 from the op
on: its tile comes from the same layout, and its blocks over a shard of
direction rows are modelled the same way.
"""
import numpy as np
import pytest

from repro_torch.kernels import tuning as TT

BARRIERS = 192          # the rings' mbarriers (csrc/skew_tile.cuh)
SMEM_MAX = 227 * 1024


def _skew_map(n, cols, items, warps, runs, dir0, live_dirs):
    """(direction, d) of the live outputs of one block's items, as
    ``tile_init`` / ``tile_emit`` lay them out: item q = warp*items + u is
    direction dir0 + q // runs and column run q % runs, and lane L holds
    columns 32*cols*c + L + 32*j below N; items past ``live_dirs*runs``
    are dead."""
    warp, u, lane, j = np.meshgrid(np.arange(warps), np.arange(items),
                                   np.arange(32), np.arange(cols),
                                   indexing="ij")
    q = warp * items + u
    m = dir0 + q // runs
    d = 32 * cols * (q % runs) + lane + 32 * j
    keep = (q < live_dirs * runs) & (d < n)
    return m[keep], d[keep]


def _check_windows(n, cols, dirs, ds, sign, off, rows):
    """Step each output's window as ``tile_init`` / ``tile_add_row`` do
    (base <32K*c + step*off>_N, plus <sign*dir>_N per row, minus N on
    wrap) and check that the lane loads column <d + sign*dir*(off + r)>_N
    from inside its padded row of N + 32K - 1 columns."""
    pad = 32 * cols - 1
    c = ds // (32 * cols)
    step = np.where((sign > 0) | (dirs == 0), dirs, n - dirs)
    w = ((32 * cols * c) % n + (step * (off % n)) % n) % n
    rows = set(rows)
    for r in range(max(rows) + 1):
        if r in rows:
            x = w + ds - 32 * cols * c
            assert ((x >= 0) & (x < n + pad)).all()
            assert ((x % n) == (ds + sign * dirs * (off + r)) % n).all()
        w = np.where(w + step >= n, w + step - n, w + step)


def _sample_rows(n, rng):
    return range(n) if n <= 61 else sorted(rng.choice(n, 6, replace=False))


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,batch,out_rows,itemsize,want", [
    (251, 256, 252, 4, (17, 2, 32, 4, 8)),     # radon_251 forward
    (251, 256, 251, 4, (17, 2, 32, 4, 8)),     # radon_251 inverse, core
    (251, 1, 252, 4, (17, 2, 16, 2, 16)),      # Conv2D's 3x3 kernel
    (251, 256, 252, 8, (9, 2, 28, 7, 9)),
    (4099, 4, 4100, 4, (2, 2, 3, 7, 1367))])
def test_skew_tile_fits_registers_and_shared_memory(n, batch, out_rows,
                                                   itemsize, want):
    """(stage rows, ring slots, directions per block, consumer warps,
    blocks per image) at the main path's shapes, with the table's
    strip_rows / m_block; the block's registers (accumulators under the
    launch bounds' 128 a thread) and its ring fit its share of an SM, so
    that ``per_sm`` blocks run at once; strip_rows and m_block cap."""
    strip_rows, m_block = TT.pallas_block_spec(n)
    t = TT.skew_tile(n, n, itemsize, strip_rows, m_block, out_rows,
                     batch=batch)
    assert (t.stage_rows, t.slots, t.m_block, t.warps, t.blocks) == want
    assert t.cols == TT.skew_cols(n) and t.items == TT.SKEW_ITEMS[itemsize]
    regs = t.items * (t.cols * itemsize // 4 + 2) + 20
    assert regs <= TT.MAX_THREAD_REGS
    assert t.per_sm * (t.warps + 1) * 32 * TT.MAX_THREAD_REGS <= 65536
    assert t.per_sm * (t.smem + 1024) <= 228 * 1024
    assert t.warps <= TT.SKEW_WARPS
    assert t.warps * t.items >= min(t.m_block, n) * t.runs
    assert t.smem == BARRIERS + t.slots * t.stage_rows * t.row_bytes
    assert t.smem <= (TT.SKEW_SMEM_BUDGET if n < 1000 else SMEM_MAX)
    assert t.row_bytes % 16 == 0
    assert t.row_bytes >= (n + t.pad) * itemsize + 16 - itemsize
    assert t.stage_rows <= strip_rows and t.m_block <= m_block
    assert t.slots >= min(2, -(-n // t.stage_rows))
    assert t.blocks == -(-out_rows // t.m_block)


def test_skew_cols_wastes_little_of_a_run():
    """K per N: 8 at N = 251 (256 of 251 columns used), and for every N
    a run of 32K columns that no other K beats on instructions per row."""
    want = {5: 1, 13: 1, 31: 1, 37: 2, 61: 2, 127: 4, 131: 8, 251: 8,
            257: 4, 509: 8, 4099: 8}
    assert {n: TT.skew_cols(n) for n in want} == want
    assert TT.conv_run(8) == 9 and TT.conv_run(1) == 1
    assert all(TT.conv_run(k) % 2 == 1 and TT.conv_run(k) >= k
               for k in TT.SKEW_COLS)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n,batch", [(5, 3), (13, 1), (31, 2), (61, 3),
                                     (251, 256), (251, 1), (421, 2)])
def test_skew_thread_map_covers_each_output_once(n, batch, itemsize):
    """K1's blocks and lanes cover every output (m, d), m < N, exactly
    once for the forward's N + 1 rows (row N, summed apart, by exactly one
    block) and the inverse's N; each window stays inside its padded row
    and loads column <d + sign*m*(off + i)>_N, at row offsets 0 and
    unaligned ones, for both signs."""
    m_block = TT.pallas_block_spec(n, itemsize)[1]
    rng = np.random.default_rng(n * itemsize + batch)
    for out_rows in (n + 1, n):
        t = TT.skew_tile(n, n, itemsize, 256, m_block, out_rows,
                         batch=batch)
        hits = np.zeros((n, n), dtype=np.int64)
        owners = 0
        for blk in range(t.blocks):
            m0 = blk * t.m_block
            m_count = min(t.m_block, out_rows - m0)
            live = max(0, min(m_count, n - m0))
            assert t.warps * t.items >= live * t.runs
            m, d = _skew_map(n, t.cols, t.items, t.warps, t.runs, m0, live)
            assert ((m >= m0) & (m < m0 + live)).all()
            np.add.at(hits, (m, d), 1)
            owners += out_rows > n and m0 <= n < m0 + m_count
            pick = rng.choice(len(m), min(len(m), 40), replace=False)
            for sign, off in ((1, 0), (-1, 0), (1, 2), (-1, n + 3)):
                _check_windows(n, t.cols, m[pick], d[pick], sign, off,
                               _sample_rows(n, rng))
        assert (hits == 1).all()
        assert owners == (out_rows > n)


def test_skew_tile_raises_when_no_row_fits():
    with pytest.raises(ValueError, match="N=40009 8-byte"):
        TT.skew_tile(40009, 40009, 8, 256, 64, 40010)


@pytest.mark.parametrize("itemsize,top", [(4, 14336), (8, 7168)])
def test_k1_holds_a_direction_up_to_its_registers(itemsize, top):
    """K1 holds one direction up to 7 warps x items x 256 columns: N =
    14336 for 4-byte sums, 7168 for 8-byte ones.  One column more raises
    in its tile, and the streamed kernel holds every N up to the 28928 /
    14464 that K1 ran to before its register tile: K5 while its ring
    holds two padded rows, K4 (one stage) above."""
    assert TT.skew_holds(top, itemsize) and not TT.skew_holds(top + 1,
                                                              itemsize)
    t = TT.skew_tile(top, top, itemsize, 8, 64, top + 1)
    assert t.runs == TT.SKEW_WARPS * t.items and t.m_block == 1
    with pytest.raises(ValueError, match=f"N={top + 1} {itemsize}-byte"):
        TT.skew_tile(top + 1, top + 1, itemsize, 8, 64, top + 2)
    dma_top = {4: 28613, 8: 14291}[itemsize]
    assert TT.stream_dma_holds(dma_top, itemsize)
    assert not TT.stream_dma_holds(dma_top + 1, itemsize)
    old_top = {4: 28928, 8: 14464}[itemsize]
    for n, impl in ((top + 1, "dma"), (dma_top, "dma"),
                    (dma_top + 1, "grid"), (old_top, "grid")):
        s = TT.stream_tile(n, n, itemsize, 8, 8, n + 1, impl)
        assert s.slots >= (2 if impl == "dma" else 1)
        assert s.smem <= SMEM_MAX


def _c_constant(text, name, **env):
    """The value of ``constexpr int name = ...;`` in CUDA source
    ``text``, a number or one ``a ? b : c`` over ``env``."""
    import re
    expr = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                     text).group(1)
    cond = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if cond:
        expr = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
    return eval(expr, {}, dict(env))


def _c_tile_fields(text):
    """The ``tile::`` enum of a kernel source: the host tile's fields in
    the order its launch reads them."""
    import re
    body = re.search(r"namespace tile \{\s*enum : int \{([^}]*)\}",
                     text).group(1)
    return [f.strip() for f in body.split(",") if f.strip()]


def _camel(field):
    return "k" + "".join(w[:1].upper() + w[1:] for w in field.split("_"))


def test_cuda_sources_match_the_host_tiles():
    """The kernels take their layout from the host's tiles and check it
    against compile-time constants; those constants and the order in
    which each launch reads a tile's fields are the ones
    ``kernels/tuning.py`` builds the tiles with."""
    from pathlib import Path
    csrc = Path(TT.__file__).parent / "csrc"
    head = (csrc / "skew_tile.cuh").read_text()
    k1 = (csrc / "sfdprt.cu").read_text()
    k2 = (csrc / "pipeline.cu").read_text()
    assert _c_constant(head, "kMaxSlots") == TT.STREAM_MAX_SLOTS
    assert _c_constant(head, "kBarrierBytes",
                       kMaxSlots=TT.STREAM_MAX_SLOTS) == BARRIERS
    assert _c_constant(head, "kSmemMax") == TT.STREAM_SMEM_BUDGET
    for size in (4, 8):
        assert _c_constant(head, "kItems", kBytes=size) == \
            TT.SKEW_ITEMS[size]
        assert _c_constant(k2, "kPipeItems", kBytes=size) == \
            TT.PIPE_ITEMS[size]
    for k in TT.SKEW_COLS:
        assert _c_constant(head, "kConvRun", K=k) == TT.conv_run(k)
        assert f"case {k}:" in k1 and f"case {k}:" in k2
    assert _c_constant(k1, "kMaxWarps") == TT.SKEW_WARPS
    assert _c_constant(k2, "kPipeMaxWarps") == TT.PIPE_WARPS
    assert _c_tile_fields(k1) == [_camel(f) for f in TT.SkewTile._fields
                                  ] + ["kCount"]
    assert _c_tile_fields(k2) == [_camel(f) for f in
                                  TT.PipelineTile._fields] + ["kCount"]
    # K3 takes the same PipelineTile through the same enum: its entry takes
    # the int array, its launch reads every field (read_tile, op_stages_ok)
    # and dispatches on K as K2's does
    import re
    assert re.search(r'extern "C" int pipeline_tail_launch\([^)]*'
                     r'const int\* tile', k2)
    tail = k2[k2.index("int launch_tail_checked("):]
    tail = tail[:tail.index("\n}\n")]
    for call in ("read_tile(t, ", "op_stages_ok<T>(geo, t)", "by_cols(",
                 "launch_tail<T, decltype(k)::value>"):
        assert call in tail
    used = set(re.findall(r"tile::(k\w+)", k2)) - {"kCount"}
    assert used == {_camel(f) for f in TT.PipelineTile._fields}
    assert "pipeline_tail_kernel(" in k2 and not any(
        f"{old}(" in k2 for old in ("load_rows", "apply_op", "write_aux",
                                     "inverse_add"))


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op,itemsize,want,rows", [
    pytest.param("conv", 4, (33, 2, 63, 11, 4, 538, 0, 200032), None,
                 id="conv-4-want0"),
    pytest.param("mul", 4, (31, 2, 63, 11, 4, 506, 0, 127712), None,
                 id="mul-4-want1"),
    pytest.param("none", 4, (31, 2, 63, 11, 4, 506, 0, 127712), None,
                 id="none-4-want2"),
    pytest.param("conv", 8, (19, 2, 36, 9, 7, 538, 0, 229440), None,
                 id="conv-8-want3"),
    # K3 at world size 1 (all 252 directions) and on a 63-row shard
    pytest.param("conv", 4, (0, 0, 63, 11, 4, 538, 0, 200032), 252,
                 id="proj-conv-4-252"),
    pytest.param("mul", 4, (0, 0, 63, 11, 4, 506, 0, 127712), 252,
                 id="proj-mul-4-252"),
    pytest.param("none", 4, (0, 0, 63, 11, 1, 506, 0, 127712), 63,
                 id="proj-none-4-63"),
    pytest.param("conv", 8, (0, 0, 36, 11, 7, 538, 0, 229440), 252,
                 id="proj-conv-8-252")])
def test_pipeline_tile_fits_one_block_per_sm(op, itemsize, want, rows):
    """(stage rows, slots, directions per block, consumer warps, blocks
    per image, slot elements, rc offset, shared bytes) at radon_251 with
    the table's m_block: one block per SM holds its registers and its
    227 KB; the slots hold the operand window and then the padded rc
    row; the ring fits in what it aliases.  K3 (``rows`` of a shard):
    the same layout with no ring, the warps the inverse's items can use,
    and blocks of D that cover the shard's rows."""
    n = 251
    m_block = TT.pipeline_block_spec(n)[0]
    if rows is None:
        t = TT.pipeline_tile(n, itemsize, m_block, op)
        covered = n + 1
        assert t.warps * t.items >= min(t.m_block, n) * t.runs
    else:
        t = TT.tail_tile(n, itemsize, m_block, op, rows)
        covered = rows
        assert t.stage_rows == t.slots == t.row_bytes == 0
        assert t.warps == min(TT.PIPE_WARPS, -(-n * t.runs // t.items))
    assert (t.stage_rows, t.slots, t.m_block, t.warps, t.blocks, t.e_slot,
            t.rc_off, t.smem) == want
    assert (t.warps + 1) * 32 * TT.PIPE_THREAD_REGS <= 65536
    assert t.warps <= TT.PIPE_WARPS and t.m_block <= m_block
    assert t.smem <= SMEM_MAX
    area = -(-t.m_block * t.e_slot * itemsize // 16) * 16
    assert t.smem == BARRIERS + t.rf_bytes + max(
        area, t.slots * t.stage_rows * t.row_bytes)
    assert t.e_slot >= t.rc_off + n + t.pad
    if op == "conv":
        assert t.rf_bytes >= (t.m_block + 1) * n * itemsize
        assert t.e_slot >= n - 1 + 32 * t.conv_run * t.conv_passes
    assert t.blocks * t.m_block >= covered > (t.blocks - 1) * t.m_block


def test_pipeline_tile_caps_and_raises():
    """m_block caps D (the m_block sweep of chip_smoke.py), N + 1 caps it
    at small N, and a direction that does not fit one block raises."""
    assert TT.pipeline_tile(251, 4, 16, "conv").m_block == 16
    assert TT.pipeline_tile(5, 4, 100, "none").m_block == 6
    with pytest.raises(ValueError, match="does not fit"):
        TT.pipeline_tile(40009, 8, 64, "conv")


def _conv_run(a, e, d0, n, r):
    """The kernel's conv_run: outputs d0 + k, k < r, against the operand
    row extended as the kernel lays it out (``e[y + n - 1]`` is column
    <y>_N); the window is a ring of r registers, the loop over t unrolled
    by r, so the register index of every read is (k - s) mod r.  Returns
    the sums and the extended columns it read."""
    acc = [0] * r
    v = [None] * r
    reads = []

    def load(y):
        reads.append(y)
        return e[y + n - 1]

    for k in range(1, r):
        v[k] = load(d0 + k)
    t0 = 0
    while t0 + r <= n or t0 < n:
        for s in range(r):
            if t0 + s >= n:
                break
            v[(r - s) % r] = load(d0 - (t0 + s))
            for k in range(r):
                acc[k] += a[t0 + s] * v[(k - s + r) % r]
        t0 += r
    return acc, reads


@pytest.mark.parametrize("n", [5, 13, 31, 61, 127, 251, 257, 421])
def test_conv_window_computes_the_circular_convolution(n):
    """K2's conv epilogue: the lanes' runs of R consecutive outputs cover
    each d < N of a direction once (R odd: 32 lanes at stride R hit 32
    banks), the rotating register window computes sum_t rf[t] *
    rg[<d - t>_N], and every read stays inside the extended operand row
    -(N-1) .. 32R*P."""
    rng = np.random.default_rng(n)
    cols = TT.skew_cols(n)
    r = TT.conv_run(cols)
    passes = -(-n // (32 * r))
    reach = 32 * r * passes
    assert r % 2 == 1 and len({(r * lane) % 32 for lane in range(32)}) == 32
    a = rng.integers(-9, 10, n)
    g = rng.integers(-9, 10, n)
    e = np.array([g[(x + 1) % n] for x in range(n - 1 + reach)])
    want = [sum(int(a[t]) * int(g[(d - t) % n]) for t in range(n))
            for d in range(n)]
    seen = np.zeros(n, dtype=np.int64)
    lanes = range(32) if n <= 61 else rng.choice(32, 5, replace=False)
    for p in range(passes):
        for lane in range(32):
            d0 = 32 * r * p + r * lane
            ds = [d0 + k for k in range(r) if d0 + k < n]
            seen[ds] += 1
            if lane not in lanes:
                continue
            acc, reads = _conv_run(a, e, d0, n, r)
            assert min(reads) >= -(n - 1) and max(reads) < reach
            assert [acc[k] for k in range(len(ds))] == [want[d] for d in ds]
    assert (seen == 1).all()


@pytest.mark.parametrize("n,itemsize", [(13, 4), (251, 4), (257, 4),
                                        (421, 4), (421, 8)])
def test_conv_rc_rows_are_written_behind_the_reads(n, itemsize):
    """A direction's rc row replaces its operand window in the same slot,
    pass by pass from the last run of 32R outputs to the first: no pass
    writes a slot column that the same or a later pass still reads, and
    the padded rc row (N + 32K - 1 columns from rc_off) fits the slot."""
    t = TT.pipeline_tile(n, itemsize, 64, "conv")
    r, passes, pad = t.conv_run, t.conv_passes, t.pad
    last_read = np.full(t.e_slot, -1)        # the order of the last read
    order = 0
    for p in range(passes - 1, -1, -1):
        lo = 32 * r * p - (n - 1)            # extended columns pass p reads
        hi = 32 * r * (p + 1)
        last_read[lo + n - 1:hi + n - 1] = order
        order += 1
    order = 0
    for p in range(passes - 1, -1, -1):
        for d in range(32 * r * p, min(n, 32 * r * (p + 1))):
            for x in range(d, n + pad, n):
                pos = t.rc_off + x
                assert pos < t.e_slot
                assert last_read[pos] <= order   # no later pass reads it
        order += 1


def _inverse_covers_once(n, t, m0, ms, rng):
    """One block's inverse on tile ``t``: its items (output row i, column
    run) in passes of warps x items cover each (i, j) once, and each
    window over the block's ``ms`` rc rows (sign -1, row offset m0)
    loads column <j - (m0 + ml)*i>_N inside the padded row."""
    out = np.zeros((n, n), dtype=np.int64)
    total = n * t.runs
    for qb in range(0, total, t.warps * t.items):
        q = qb + np.arange(t.warps * t.items)
        live = q[q < total]
        i = np.repeat(live // t.runs, 32 * t.cols)
        c = np.repeat(live % t.runs, 32 * t.cols)
        lane_j = np.tile(np.arange(32 * t.cols), len(live))
        j = 32 * t.cols * c + lane_j
        keep = j < n
        np.add.at(out, (i[keep], j[keep]), 1)
        if qb == 0 or n <= 61:
            pick = rng.choice(keep.sum(), min(keep.sum(), 30),
                              replace=False)
            _check_windows(n, t.cols, i[keep][pick], j[keep][pick], -1,
                           m0, range(min(ms, 8)))
    assert (out == 1).all()


#: K2's cases: (N, op)
K2_MAP_CASES = [(5, "conv"), (13, "mul"), (31, "none"), (61, "conv"),
                (251, "conv"), (251, "none"), (421, "conv")]
#: K3's shards: (N, op, row_offset, rows, m_block) -- row_offset 0, a
#: middle shard, one that straddles N (its last rows are padding) and one
#: of padding only; m_block 3 splits a shard into blocks whose first
#: direction is no multiple of D
K3_MAP_CASES = [
    (5, "conv", 0, 2, 6), (5, "conv", 2, 2, 6), (5, "mul", 4, 3, 6),
    (5, "none", 6, 2, 6),
    (13, "conv", 0, 5, 14), (13, "none", 5, 5, 3), (13, "mul", 10, 5, 3),
    (13, "conv", 15, 5, 14),
    (31, "mul", 0, 8, 3), (31, "conv", 8, 8, 32), (31, "none", 29, 8, 3),
    (31, "conv", 32, 8, 32),
    (251, "conv", 189, 64, 64)]


@pytest.mark.parametrize("n,op,shard", [
    pytest.param(n, op, None, id=f"{n}-{op}") for n, op in K2_MAP_CASES] + [
    pytest.param(n, op, (off, rows, mb),
                 id=f"proj-{n}-{op}-off{off}-rows{rows}-m{mb}")
    for n, op, off, rows, mb in K3_MAP_CASES])
def test_pipeline_thread_map_covers_each_output_once(n, op, shard):
    """K2's three stages on its tile: the forward items cover each
    direction m < N of the image exactly once (row N by row sums in the
    last block); the conv's warps cover the block's directions; the
    inverse's items (output row i, column run) in passes of warps x items
    cover each (i, j) once per block, and each window over the block's rc
    rows (sign -1, row offset m0) loads column <j - (m0 + ml)*i>_N inside
    the padded row.  K3 on a ``shard`` (row_offset, rows, m_block): its
    blocks of D rows hold each of the shard's rows of global direction
    <= N exactly once (a block of padding only returns at once), aux
    rows 0 and N come from the one block that holds them, the conv's
    warps cover each block's directions, and each block with directions
    < N runs the same inverse at its global row offset."""
    rng = np.random.default_rng(n)
    if shard is not None:
        off, rows, m_block = shard
        t = TT.tail_tile(n, 4, m_block, op, rows)
        assert t.stage_rows == t.slots == 0
        assert t.blocks * t.m_block >= rows > (t.blocks - 1) * t.m_block
        held, aux_rows = [], []
        for blk in range(t.blocks):
            m0 = off + blk * t.m_block
            if m0 > n:
                continue
            mc = min(t.m_block, rows - blk * t.m_block, n + 1 - m0)
            ms = max(0, min(mc, n - m0))
            held += range(m0, m0 + mc)
            aux_rows += [m for m in (0, n) if m0 <= m < m0 + mc]
            conv_dirs = sorted(ml for w in range(t.warps)
                               for ml in range(w, mc, t.warps))
            assert conv_dirs == list(range(mc))
            if ms:
                _inverse_covers_once(n, t, m0, ms, rng)
        assert held == list(range(off, min(off + rows, n + 1)))
        assert aux_rows == [m for m in (0, n) if off <= m < off + rows]
        return
    t = TT.pipeline_tile(n, 4, TT.pipeline_block_spec(n)[0], op)
    hits = np.zeros((n, n), dtype=np.int64)
    for blk in range(t.blocks):
        m0 = blk * t.m_block
        mc = min(t.m_block, n + 1 - m0)
        ms = max(0, min(mc, n - m0))
        m, d = _skew_map(n, t.cols, t.items, t.warps, t.runs, m0, ms)
        np.add.at(hits, (m, d), 1)
        conv_dirs = sorted(ml for w in range(t.warps)
                           for ml in range(w, mc, t.warps))
        assert conv_dirs == list(range(mc))
        if ms:
            _inverse_covers_once(n, t, m0, ms, rng)
    assert (hits == 1).all()


# ---------------------------------------------------------------------------
# the ring (skew::produce / skew::consume)
# ---------------------------------------------------------------------------
def _producer_ops(rows, stage_rows, slots, k0):
    """The producer's waits and signals for one operand, in the order of
    ``skew::produce``: ("pad", stage) waits for the stage to land, pads it
    and arrives on full; ("issue", stage) waits on empty for the stage
    that held the slot before, then issues the copy (landed)."""
    n_stages = -(-rows // stage_rows)
    ahead = slots - 1 if slots > 1 else 1
    ops = []
    for k in range(n_stages + ahead):
        if k >= ahead:
            ops.append(("pad", k0 + k - ahead))
        if k < n_stages:
            ops.append(("issue", k0 + k))
    return ops, k0 + n_stages


def _run_ring(operand_rows, stage_rows, slots):
    """Run the producer and the consumers of one block step by step
    (each waits until its barrier's phase completes) and return the order
    of events; fails on a deadlock, on a stage issued into a slot the
    consumers still read, and on a stage consumed before it is padded."""
    ops, consumer_stages, k = [], [], 0
    for rows in operand_rows:
        more, k_next = _producer_ops(rows, stage_rows, slots, k)
        ops += more
        consumer_stages += list(range(k, k_next))
        k = k_next
    issued, padded, consumed = set(), set(), set()
    events, pi, ci = [], 0, 0
    while pi < len(ops) or ci < len(consumer_stages):
        moved = False
        if pi < len(ops):
            kind, st = ops[pi]
            if kind == "pad" and st in issued:         # landed
                padded.add(st)
                events.append(("pad", st))
                pi, moved = pi + 1, True
            elif kind == "issue" and (st < slots or st - slots in consumed):
                issued.add(st)
                events.append(("issue", st))
                pi, moved = pi + 1, True
        if ci < len(consumer_stages):
            st = consumer_stages[ci]
            if st in padded:                            # full
                assert st in issued
                consumed.add(st)
                events.append(("consume", st))
                ci, moved = ci + 1, True
        assert moved, f"deadlock: producer at {ops[pi:pi + 1]}, " \
                      f"consumers at stage {consumer_stages[ci:ci + 1]}"
    return events


@pytest.mark.parametrize("operand_rows,stage_rows,slots", [
    ((5,), 5, 1), ((5,), 6, 1), ((5, 5), 5, 1),     # one stage, one slot
    ((13,), 3, 2), ((13,), 3, 5), ((251,), 11, 3),  # K1's main path
    ((251, 251), 22, 3), ((251,), 8, 8),            # K2 image operand
    ((4099,), 1, 4)])
def test_ring_streams_every_stage_without_deadlock(operand_rows,
                                                   stage_rows, slots):
    """The producer keeps slots - 1 stages in flight and pads each before
    the consumers reach it; a ring of one slot holds a single stage per
    operand.  Every stage is issued, padded and consumed once, in order,
    and no copy lands in a slot whose previous stage is still read."""
    if slots == 1:
        assert all(r <= stage_rows for r in operand_rows)
    events = _run_ring(operand_rows, stage_rows, slots)
    total = sum(-(-r // stage_rows) for r in operand_rows)
    for kind in ("issue", "pad", "consume"):
        assert [st for k, st in events if k == kind] == list(range(total))
    # slots - 1 copies are in flight before the first stage is padded
    if slots > 1 and total >= slots - 1:
        first = events.index(("pad", 0))
        assert [e for e in events[:first]] == [
            ("issue", st) for st in range(slots - 1)]
