// K1 on Hopper: the fused, batched SFDPRT skew-sum kernel.
//
// Replaces the TPU kernel repro/kernels/sfdprt.py:_sfdprt_kernel (launched
// by _pallas_skew_call).  It computes what that kernel computes, in three
// modes, for a (B, rows, N) operand g in the type T it sums in, into an
// output of type O:
//
//   core     out[b, m, d] = sum_i g[b, i, <d + sign*m*(row_offset + i)>_N]
//            for m < N                                   -> (B, N, N)
//   forward  core with sign = +1, plus row N: the row-sum R(N, d) =
//            sum_j g[b, d - row_offset, j] at the image row's global
//            position d (zero elsewhere)                 -> (B, N+1, N)
//   inverse  core with sign = -1 over r[:N], then the epilogue
//            floor((Z[i, j] + corr[b, i]) / N), corr[i] = R(N, i) - S,
//            computed by the caller                      -> (B, N, N)
//
// in one launch, each output written once.  O is T, or int64 over an int32
// operand in the core and forward modes: the forward of a narrow integer
// image sums at most N values of magnitude <= v per output, so where v*N <
// 2^31 it sums in int32 even where its result is int64 (uint8 at N >=
// 2903), and only the store widens, through the signed 32-bit value, so a
// negative int16 sum sign-extends (kernels/csrc/stream.cu says more).
//
// What bounds it.  At the main path's shapes (B = 256, N = 251, int32)
// the kernel moves ~129 MB (39 us at 3.35 TB/s) but does B*N^3 = 4.0e9
// adds, so it is bound by operations: 0.24 ms at the card's 16.75e12
// int32 adds/s.  A skew-sum gives no reuse of a loaded word across
// outputs, so each add needs one shared-memory load, and the 128 bytes
// per clock of an SM's shared memory cap it lower: one 4-byte word per add
// is 32 adds per clock per SM, 0.48 ms at that shape.
//
// Design.  One thread block per (image b, block of D output rows), with
// `warps` consumer warps and one producer warp; the block owns all N
// columns of its rows, because output (m, d) reads g[i, <d + sign*m*(off
// + i)>_N], which can be any column.  The sums live in registers for the
// whole row loop (skew_tile.cuh: an item is a direction and a run of 32K
// columns, lane L owns columns L + 32j; K = 8 at N = 251, so one run
// covers 256 of the 251 columns), and the operand streams through a ring
// of padded stages fed by the producer warp (skew_tile.cuh).  The block
// that owns row N of the forward mode has no item for it: its consumer
// warps share the staged rows, sum each with a shuffle reduction and
// write R(N, col) for the row's global position col straight to the
// output; the columns no row reaches are written zero at the end.  After
// the last stage every lane writes its outputs once, applying the inverse
// epilogue in registers.
//
// A block is small (at most 7 consumer warps, 128 registers a thread,
// ~72 KB of stages), so several run on one SM: one block's 251-row pass
// would otherwise leave the SM idle while it starts and drains.  The
// host (kernels/tuning.py:skew_tile) picks K from N, D and the warps from
// the registers and the batch, the stage height and ring depth from the
// shared memory, and lays the tile out; this file takes that layout as
// given and only checks it against its constants and budgets.  strip_rows
// only caps the stage height, m_block only caps D; integer results depend
// on neither.
#include <cuda_runtime.h>

#include <climits>

#include "skew_tile.cuh"

namespace {

using skew::arith_t;

constexpr int kCore = 0;
constexpr int kForward = 1;
constexpr int kInverse = 2;
// At most 7 consumer warps and the producer: 256 threads; two such blocks
// leave ptxas 128 registers a thread.
constexpr int kMaxWarps = 7;
constexpr int kThreads = (kMaxWarps + 1) * 32;

// What the host decided (kernels/tuning.py:skew_tile), checked by
// launch_checked before any launch.
struct Geometry {
  long long g_bstride;
  long long row_offset;
  int rows, n, out_rows;
  int dirs;        // D, directions per block
  int n_dblocks;   // direction blocks per image, ceil(out_rows / D)
  int runs;        // column runs per direction, ceil(N / 32K)
  int warps;       // consumer warps per block
  int stage_rows;  // rows per stage
  int slots;       // stages in the ring
  int row_bytes;   // bytes of one padded row slot, a multiple of 16
  int pad;         // padding columns after each staged row, 32K - 1
  int sign, mode, off_mod;
};

template <typename T, int K, typename O = T>
__global__ void __launch_bounds__(kThreads, 2)
sfdprt_kernel(const T* __restrict__ g, const T* __restrict__ corr,
              O* __restrict__ out, const Geometry geo) {
  using U = arith_t<T>;
  constexpr int I = skew::kItems<sizeof(T)>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  const skew::Ring ring{smem_raw + skew::kBarrierBytes,
                        bars,
                        bars + skew::kMaxSlots,
                        bars + 2 * skew::kMaxSlots,
                        geo.stage_rows,
                        geo.slots,
                        geo.row_bytes,
                        geo.pad};

  const int n = geo.n;
  const int b = blockIdx.x / geo.n_dblocks;
  const int m0 = (blockIdx.x - b * geo.n_dblocks) * geo.dirs;
  const int m_count = min(geo.dirs, geo.out_rows - m0);
  const int m_skew = max(0, min(m_count, n - m0));  // rows m < N
  const bool owns_row_sums =
      (geo.mode == kForward) && (n >= m0) && (n < m0 + m_count);
  const T* gb = g + static_cast<long long>(b) * geo.g_bstride;
  O* const ob = out + static_cast<long long>(b) * geo.out_rows * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) skew::ring_init(ring, geo.warps);
  __syncthreads();
  if (warp == geo.warps) {  // the producer warp
    skew::produce(ring, gb, geo.rows, n, 0, lane);
    return;
  }

  const int q0 = warp * I;
  const int live = max(0, min(I, m_skew * geo.runs - q0));
  skew::Tile<U, K, I> tile;
  skew::tile_init(tile, q0, live, m0, geo.runs, geo.sign, n, geo.off_mod);
  skew::consume(ring, tile, live > 0, gb, geo.rows, n, 0, owns_row_sums,
                warp, geo.warps, lane, [&](int t, U sum) {
                  const long long col = geo.row_offset + t;
                  if (col >= 0 && col < n) {
                    ob[static_cast<long long>(n) * n + col] =
                        static_cast<O>(static_cast<T>(sum));
                  }
                });

  // the outputs, written once
  const bool inverse = geo.mode == kInverse;
  const T* const cb =
      inverse ? corr + static_cast<long long>(b) * n : nullptr;
  skew::tile_emit(tile, q0, live, m0, geo.runs, n, lane,
                  [&](int m, int d, U v) {
                    O* const o = ob + static_cast<long long>(m) * n + d;
                    if (inverse) {
                      const U total = v + static_cast<U>(cb[m]);
                      *o = static_cast<O>(
                          skew::divide_by_n(static_cast<T>(total), n));
                    } else {
                      *o = static_cast<O>(static_cast<T>(v));
                    }
                  });
  if (owns_row_sums) {  // row N's columns that no image row reaches
    O* const orow = ob + static_cast<long long>(n) * n;
    for (int col = threadIdx.x; col < n; col += geo.warps * 32) {
      const long long t = col - geo.row_offset;
      if (t < 0 || t >= geo.rows) orow[col] = O(0);
    }
  }
}

template <typename T, int K, typename O>
int launch(const void* g, const void* corr, void* out, int batch,
           const Geometry& geo, size_t smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * geo.n_dblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sfdprt_kernel<T, K, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sfdprt_kernel<T, K, O><<<static_cast<unsigned>(blocks),
                           (geo.warps + 1) * 32, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(corr),
      static_cast<O*>(out), geo);
  return static_cast<int>(cudaGetLastError());
}

// The tile of kernels/tuning.py:skew_tile as the host passes it: the
// fields of its SkewTile, in their order.
namespace tile {
enum : int {
  kStageRows,
  kSlots,
  kMBlock,
  kCols,
  kItems,
  kWarps,
  kRuns,
  kPad,
  kRowBytes,
  kSmem,
  kBlocks,
  kPerSm,
  kCount
};
}  // namespace tile

// Check the host's tile against this instantiation and the budgets, and
// launch the instantiation of K.  The layout is the host's; these are
// the conditions the kernel relies on.
template <typename T, typename O = T>
int launch_checked(const void* g, long long g_bstride, const void* corr,
                   void* out, int batch, int rows, int n, int out_rows,
                   const int* t, int sign, int mode, long long row_offset,
                   cudaStream_t s) {
  using LL = long long;
  const int dirs = t[tile::kMBlock], cols = t[tile::kCols];
  const int items = t[tile::kItems], smem = t[tile::kSmem];
  Geometry geo;
  geo.g_bstride = g_bstride;
  geo.row_offset = row_offset;
  geo.rows = rows;
  geo.n = n;
  geo.out_rows = out_rows;
  geo.dirs = dirs;
  geo.n_dblocks = t[tile::kBlocks];
  geo.runs = t[tile::kRuns];
  geo.warps = t[tile::kWarps];
  geo.stage_rows = t[tile::kStageRows];
  geo.slots = t[tile::kSlots];
  geo.pad = t[tile::kPad];
  geo.row_bytes = t[tile::kRowBytes];
  geo.sign = sign;
  geo.mode = mode;
  geo.off_mod = static_cast<int>(((row_offset % n) + n) % n);
  const LL skew_rows = dirs < n ? dirs : n;
  const LL ring = skew::kBarrierBytes +
                  static_cast<LL>(geo.slots) * geo.stage_rows * geo.row_bytes;
  if (dirs < 1 || geo.warps < 1 || geo.stage_rows < 1 || geo.slots < 1 ||
      geo.n_dblocks < 1 || items != skew::kItems<sizeof(T)> ||
      geo.warps > kMaxWarps || n >= (1 << 16) || geo.runs < 1 ||
      // every column lies in a run, and no window leaves its padded row
      static_cast<LL>(geo.runs) * 32 * cols < n || geo.pad < 32 * cols - 1 ||
      // a row lands at its source's address mod 16: up to 15 bytes of lead
      geo.row_bytes % 16 != 0 ||
      geo.row_bytes < (static_cast<LL>(n) + geo.pad) *
                              static_cast<LL>(sizeof(T)) + 15 ||
      static_cast<LL>(geo.warps) * items < skew_rows * geo.runs ||
      static_cast<LL>(geo.n_dblocks) * dirs < out_rows ||
      static_cast<LL>(geo.n_dblocks - 1) * dirs >= out_rows ||
      geo.slots > skew::kMaxSlots || (geo.slots < 2 && rows > geo.stage_rows) ||
      smem < ring || static_cast<size_t>(smem) > skew::kSmemMax) {
    // the producer pads stage k - 1 after issuing stage k, so a ring of
    // one slot holds one stage only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(smem);
  switch (cols) {
    case 1: return launch<T, 1, O>(g, corr, out, batch, geo, bytes, s);
    case 2: return launch<T, 2, O>(g, corr, out, batch, geo, bytes, s);
    case 4: return launch<T, 4, O>(g, corr, out, batch, geo, bytes, s);
    case 8: return launch<T, 8, O>(g, corr, out, batch, geo, bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype, out_dtype: 0 int32, 1 int64, 2 float32, 3 float64, the operand's
// and the output's, equal or int32 -> int64 outside the inverse mode; tile:
// the tile::kCount fields of kernels/tuning.py:skew_tile.  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int sfdprt_launch(int dtype, int out_dtype, const void* g,
                             long long g_bstride, const void* corr, void* out,
                             int batch, int rows, int n, int out_rows,
                             const int* tile, int sign, int mode,
                             long long row_offset, void* stream) {
  if (tile == nullptr || batch < 1 || rows < 1 || n < 1 ||
      (sign != 1 && sign != -1) || mode < kCore || mode > kInverse ||
      (mode == kInverse && corr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != dtype) {
    if (dtype != 0 || out_dtype != 1 || mode == kInverse) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_checked<int32_t, int64_t>(g, g_bstride, corr, out, batch,
                                            rows, n, out_rows, tile, sign,
                                            mode, row_offset, s);
  }
  switch (dtype) {
    case 0:
      return launch_checked<int32_t>(g, g_bstride, corr, out, batch, rows, n,
                                     out_rows, tile, sign, mode, row_offset, s);
    case 1:
      return launch_checked<int64_t>(g, g_bstride, corr, out, batch, rows, n,
                                     out_rows, tile, sign, mode, row_offset, s);
    case 2:
      return launch_checked<float>(g, g_bstride, corr, out, batch, rows, n,
                                   out_rows, tile, sign, mode, row_offset, s);
    case 3:
      return launch_checked<double>(g, g_bstride, corr, out, batch, rows, n,
                                    out_rows, tile, sign, mode, row_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sfdprt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
