// K2 and K3 on Hopper: the fused projection-domain pipeline and its mesh
// tail, on the register tile of skew_tile.cuh.
//
// Replaces the TPU kernel repro/kernels/sfdprt.py:_pipeline_kernel with
// source="image", defer=False (launched by pipeline_pallas_raw).  For a
// (B, N, N) image stack f, N prime, in the accumulator type T it computes
//
//   rf      = DPRT(f)                                         (N+1, N)
//   rc[m,:] = conv: sum_t rf[m,t] * rg[m, <d - t>_N]   (rg = DPRT(g), or
//                   the operand's given projections)
//             mul:  rf[m,:] * w[m,:]
//             none: rf[m,:]
//   aux     = rc rows 0 and N                                 (B, 2, N)
//   Z[i,j]  = sum_{m<N} rc[m, <j - m*i>_N]
//   out     = floor((Z - S + rc[N, i]) / N),  S = sum_d rc[0, d]
//
// without writing rf, rg or rc to device memory.
//
// What bounds it.  At the main path's shapes (B = 256, N = 251, int32,
// conv) the call moves ~129 MB (~39 us at 3.35 TB/s) but does ~12.2e9
// integer adds and multiply-adds (forward, conv, inverse: ~4e9 each), so
// it is bound by operations (0.73 ms at 16.75e12 int32 operations/s).
// The forward and the inverse are skew-sums, one shared-memory load per
// add (32 adds per clock per SM at most, skew_tile.cuh); the conv reuses
// its loads from registers.  On top come the inverse's atomics: every
// block adds its directions' share onto all N^2 outputs of its image.
//
// Design.  Kernel 1 (pipeline_kernel) runs one thread block per (image b,
// block of D directions), over ceil((N+1)/D) blocks, so the row-sum row
// N falls in the last block; `warps` consumer warps and one producer warp
// that streams the image (and an image-form operand) through a ring of
// padded stages (skew_tile.cuh).  Three stages, on the block's D
// directions:
//
//   forward  the register-tiled skew-sum of skew_tile.cuh over the image
//            (row N: a shuffle sum of each staged row); for conv the rf
//            rows then go to shared memory once, and an image-form operand
//            is summed the same way;
//   op       conv: a warp per direction; lane L owns the R consecutive
//            outputs d = R*L + k (R odd: the lanes' loads hit 32 banks),
//            and for each t reads rf[m, t] (a broadcast) and ONE new
//            element of the operand row, then does R multiply-adds against
//            a window of the operand held in registers, the paper's
//            circular shift register: the loop over t is unrolled by R,
//            so the window rotates by register renaming, not by moves.
//            The operand row sits in shared memory extended to columns
//            -(N-1) .. 32R*P (column y is <y>_N), so no index wraps.
//            mul and none stay elementwise, in the forward's registers;
//   inverse  rc overwrites the operand window of its own direction (only
//            the direction's warp reads it), padded as a staged row is,
//            and the same register-tiled skew-sum runs with sign -1 and
//            row offset m0 over the block's rc rows, for items (output row
//            i, column run); each output is added with one atomicAdd per
//            block into an output zeroed on the stream first.
//
// Integer partials add in the unsigned type of the same width, which is
// exact, wraps as JAX does and does not depend on the order; float
// partials add in an order that changes from run to run, so floats agree
// with the plain version within a tolerance, never bit for bit.  Kernel 2
// (pipeline_finish_kernel), launched on the same stream after kernel 1,
// applies the correction and the floor divide once every block of the
// image is done: one block per (image, row band) reduces S from aux and
// rewrites its rows.  One pipeline call is a memset and these two
// launches.
//
// Shared memory (one block per SM, up to 227 KB): the ring's mbarriers;
// for conv the rf rows (D + 1 of N: the last holds an image-form
// operand's row sums); then the work region of D direction slots -- the
// ring while rows stream, then each direction's operand window (conv),
// then its padded rc row.  The budget splits between D (fewer blocks per
// image, so fewer atomics and fewer passes over each image) and that
// padding; the host (kernels/tuning.py:pipeline_tile) picks D, the warps,
// K and R from N and the budgets and lays the shared memory out
// (tuning.py:pipeline_geometry); this file takes that layout as given
// and only checks it against its constants and budgets.  m_block only
// caps D; integer results do not depend on it.
//
// K3 (pipeline_tail_kernel, entry pipeline_tail_launch) replaces the same
// TPU kernel with source="proj", defer=True: the mesh pipeline's tail.
// Its input is one shard of already-summed projection rows whose first
// global direction is row_offset, so it is K2 from the op on, on the same
// device functions (load_operand_window, conv_rows, put_rc,
// inverse_rows): a block of D of the shard's rows (tuning.py:tail_tile;
// no producer warp, no ring) copies its rows of global direction <= N --
// conv into the rf rows, mul and none (times the weight) straight into
// the padded rc slots -- runs the op against the operand's rows at the
// global directions m0 = row_offset + its first row, writes the aux rows
// where it holds directions 0 and N, and runs the register-tiled inverse
// over its rows of direction < N with sign -1 and row offset m0, one
// atomicAdd per output per block.  The row copy is ~64 MB of HBM traffic
// at radon_251 (~20 us), so no ring hides it.  K3 launches no finish
// kernel: the correction needs Z and aux summed over every shard first,
// which the caller does after its collectives.
//
// Integer rules that differ from JAX: signed overflow is undefined in C++
// while JAX wraps, so every integer sum and product runs in the unsigned
// type of the same width and is cast back; C '/' rounds toward zero, so
// the final divide is corrected to floor; C '%' takes the dividend's sign,
// so every index is built from non-negative terms.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "skew_tile.cuh"

namespace {

using skew::arith_t;
using skew::divide_by_n;

constexpr int kNone = 0;
constexpr int kMul = 1;
constexpr int kConv = 2;
constexpr int kThreads = 256;     // the finish kernel
constexpr int kFinishRows = 16;   // output rows per block of kernel 2
// K2: at most 11 consumer warps and the producer, one block per SM: ptxas
// (which counts warps in fours) keeps 168 registers a thread; at 13 to 16
// warps it keeps 128, and the int32 and float32 instantiations spilled.
// K3 runs at most as many warps, all consumers, under the same bounds.
constexpr int kPipeMaxWarps = 11;
constexpr int kPipeThreads = (kPipeMaxWarps + 1) * 32;
// Items a K2 or K3 warp holds per accumulator width (kernels/tuning.py:
// PIPE_ITEMS): fewer than K1's 8 for 4-byte sums, whose 64 accumulators
// spilled at 168 registers here though K1 holds them in 128.
template <int kBytes>
constexpr int kPipeItems = kBytes == 4 ? 6 : 4;

__device__ __forceinline__ void add_to(int32_t* p, uint32_t v) {
  atomicAdd(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(v));
}
__device__ __forceinline__ void add_to(int64_t* p, uint64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void add_to(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(double* p, double v) {
  atomicAdd(p, v);
}

// ---------------------------------------------------------------------------
// The tile and the conv window
// ---------------------------------------------------------------------------
// What the host decided (kernels/tuning.py:pipeline_tile for K2, tail_tile
// for K3), checked by launch_checked / launch_tail_checked before any
// launch.
struct PipeGeometry {
  long long f_bstride, w_bstride;  // image (K3: rows) and operand
  int n;
  int dirs;         // D, directions per block
  int n_dblocks;    // direction blocks per image
  int runs;         // column runs per direction, ceil(N / 32K)
  int warps;        // consumer warps per block
  int stage_rows;   // rows per stage (K3: 0, no ring)
  int slots;        // stages in the ring (K3: 0)
  int row_bytes;    // bytes of one padded staged row, a multiple of 16
  int pad;          // padding columns of a staged or rc row, 32K - 1
  int conv_passes;  // P: runs of 32R outputs per direction in the conv
  int e_slot;       // elements of one direction's slot in the work region
  int rc_off;       // where a direction's rc row starts in its slot
  int rf_bytes;     // bytes of the rf region (conv), 0 otherwise
  int op, operand_image;
};

// One run of R consecutive conv outputs d0 + k, k < R, of one direction:
// acc[k] = sum_t a[t] * e[k - t], where e points at column d0 of the
// operand row extended to columns <= d0 - (N - 1) (column y is <y>_N).
// The window of the R operand elements the run needs at step t,
// e[k - t] for k < R, shifts by one per step: element e[-t] enters, the
// oldest leaves.  It lives in v[] as a ring indexed (k - t) mod R, so one
// load per step refills it, and unrolling t by R makes every index a
// constant: the rotation is register renaming.
template <typename U, int R>
__device__ __forceinline__ void conv_run(const U* __restrict__ a,
                                         const U* __restrict__ e, int n,
                                         U (&acc)[R]) {
  U v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = U(0);
#pragma unroll
  for (int k = 1; k < R; ++k) v[k] = e[k];
  int t0 = 0;
#pragma unroll 1  // the body is unrolled by R already
  for (; t0 + R <= n; t0 += R, a += R, e -= R) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      v[(R - s) % R] = e[-s];
      const U at = a[s];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] += at * v[(k - s + R) % R];
    }
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (t0 + s < n) {
      v[(R - s) % R] = e[-s];
      const U at = a[s];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] += at * v[(k - s + R) % R];
    }
  }
}

// ---------------------------------------------------------------------------
// The stages after the forward, shared by K2 and K3
// ---------------------------------------------------------------------------
// A block owns directions m0 .. m0 + mc - 1; direction m0 + ml has slot ml
// of the work region, and its rc row lies at rc_off in the slot, padded as
// a staged row is (column x < N + pad is column x mod N).

// The operand window of each direction from projections (rows m0 + ml of
// the (N+1, N) operand wb): slot[y + N - 1] = wb[m, <y>_N] for y in
// [-(N - 1), 32R*P).  Threads tid, tid + threads, ... of the block.
template <int R, typename T, typename U>
__device__ __forceinline__ void load_operand_window(
    U* slots, const T* __restrict__ wb, int m0, int mc,
    const PipeGeometry& geo, int tid, int threads) {
  const int n = geo.n;
  const int ext = n - 1 + 32 * R * geo.conv_passes;
  for (int e = tid; e < mc * ext; e += threads) {
    const int ml = e / ext;
    const int x = e - ml * ext;
    slots[static_cast<size_t>(ml) * geo.e_slot + x] = static_cast<U>(
        wb[static_cast<long long>(m0 + ml) * n + (x + 1) % n]);
  }
}

// The conv, a warp per direction: rc[m, d] = sum_t rf[ml, t] *
// rg[m, <d - t>_N] against the direction's operand window; its padded rc
// row replaces the window (P > 1: each run writes behind the columns the
// runs still to come read; P = 1: after the run, over the whole slot),
// and rc rows 0 and N go to aux.
template <int R, typename T, typename U>
__device__ __forceinline__ void conv_rows(const U* rf, U* slots,
                                          T* __restrict__ ab, int m0, int mc,
                                          const PipeGeometry& geo, int warp,
                                          int lane) {
  const int n = geo.n;
  for (int ml = warp; ml < mc; ml += geo.warps) {
    const int m = m0 + ml;
    U* const slot = slots + static_cast<size_t>(ml) * geo.e_slot;
    U* const rc = slot + geo.rc_off;
    for (int p = geo.conv_passes - 1; p >= 0; --p) {
      const int d0 = 32 * R * p + R * lane;
      U acc[R];
      conv_run<U, R>(rf + static_cast<size_t>(ml) * n, slot + (n - 1) + d0,
                     n, acc);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int d = d0 + k;
        if (d < n) {
          for (int x = d; x < n + geo.pad; x += n) rc[x] = acc[k];
          if (m == 0) ab[d] = static_cast<T>(acc[k]);
          if (m == n) ab[n + d] = static_cast<T>(acc[k]);
        }
      }
      __syncwarp();
    }
  }
}

// mul, none: rc[m, d] from the projection value v (mul: times the weight
// wb[m, d]) into the direction's padded rc row; returns rc[m, d] (the
// caller writes the aux rows).
template <typename T, typename U>
__device__ __forceinline__ U put_rc(U* slots, const T* __restrict__ wb,
                                    int m0, int m, int d, U v,
                                    const PipeGeometry& geo) {
  const int n = geo.n;
  if (geo.op == kMul) {
    v *= static_cast<U>(wb[static_cast<long long>(m) * n + d]);
  }
  U* const rc = slots + static_cast<size_t>(m - m0) * geo.e_slot + geo.rc_off;
  for (int x = d; x < n + geo.pad; x += n) rc[x] = v;
  return v;
}

// The inverse of the block's directions m0 .. m0 + ms - 1 (all < N) onto
// all N x N outputs of image ob: items (output row i, column run) in
// passes of warps x I; row ml of the register-tiled skew-sum is the rc row
// of direction m0 + ml, so the window steps by <-i>_N from
// <32K*c - i*m0>_N.  Each output is added with one atomicAdd per block
// into an output zeroed on the stream first.
template <int K, int I, typename T, typename U>
__device__ __forceinline__ void inverse_rows(const U* slots,
                                             T* __restrict__ ob, int m0,
                                             int ms, const PipeGeometry& geo,
                                             int warp, int lane) {
  const int n = geo.n;
  const int runs = geo.runs;
  const U* const rc0 = slots + geo.rc_off + lane;
  const int total = n * runs;
  const int q0 = warp * I;
  skew::Tile<U, K, I> tile;
  for (int qb = 0; qb < total; qb += geo.warps * I) {
    const int qi = qb + q0;
    const int live = max(0, min(I, total - qi));
    if (live == 0) break;  // warp-uniform
    skew::tile_init(tile, qi, live, 0, runs, -1, n, m0 % n);
#pragma unroll 1  // one rc row at a time, as in skew::consume
    for (int ml = 0; ml < ms; ++ml) {
      skew::tile_add_row(tile, rc0 + static_cast<size_t>(ml) * geo.e_slot, n);
    }
    skew::tile_emit(tile, qi, live, 0, runs, n, lane, [&](int i, int d, U v) {
      add_to(ob + static_cast<long long>(i) * n + d, v);
    });
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kPipeThreads, 1)
pipeline_kernel(const T* __restrict__ f, const T* __restrict__ w,
                T* __restrict__ out, T* __restrict__ aux,
                const PipeGeometry geo) {
  using U = arith_t<T>;
  constexpr int I = kPipeItems<sizeof(T)>;
  constexpr int R = skew::kConvRun<K>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw);
  U* const rf = reinterpret_cast<U*>(smem_raw + skew::kBarrierBytes);
  unsigned char* const work = smem_raw + skew::kBarrierBytes + geo.rf_bytes;
  U* const slots = reinterpret_cast<U*>(work);
  const skew::Ring ring{work,
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
  const int mc = min(geo.dirs, n + 1 - m0);  // direction rows of this block
  const int ms = max(0, min(mc, n - m0));    // of which m < N
  const bool owns_n = n < m0 + mc;
  const T* const fb = f + b * geo.f_bstride;
  const T* const wb = w == nullptr ? nullptr : w + b * geo.w_bstride;
  T* const ab = aux + static_cast<long long>(b) * 2 * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int op = geo.op;

  if (threadIdx.x == 0) skew::ring_init(ring, geo.warps);
  __syncthreads();
  if (warp == geo.warps) {  // the producer warp: the image, then the operand
    const int k = skew::produce(ring, fb, n, n, 0, lane);
    if (geo.operand_image) skew::produce(ring, wb, n, n, k, lane);
    return;
  }
  const int cthreads = geo.warps * 32;
  const int runs = geo.runs;

  // -- forward: rf of the block's directions m < N in registers; row N by
  // row sums (conv: into rf; mul, none: rc row N straight into aux)
  const int q0 = warp * I;
  const int live = max(0, min(I, ms * runs - q0));
  skew::Tile<U, K, I> tile;
  skew::tile_init(tile, q0, live, m0, runs, 1, n, 0);
  const int k1 = skew::consume(
      ring, tile, live > 0, fb, n, n, 0, owns_n, warp, geo.warps, lane,
      [&](int t, U sum) {
        if (op == kConv) {
          rf[static_cast<size_t>(n - m0) * n + t] = sum;
        } else if (op == kMul) {
          ab[n + t] = static_cast<T>(
              sum * static_cast<U>(wb[static_cast<long long>(n) * n + t]));
        } else {
          ab[n + t] = static_cast<T>(sum);
        }
      });
  U* const rg_n = rf + static_cast<size_t>(geo.dirs) * n;  // conv, image form
  if (op == kConv) {
    skew::tile_emit(tile, q0, live, m0, runs, n, lane, [&](int m, int d, U v) {
      rf[static_cast<size_t>(m - m0) * n + d] = v;
    });
    if (geo.operand_image) {  // rg of the operand image, the same way
      skew::tile_init(tile, q0, live, m0, runs, 1, n, 0);
      skew::consume(ring, tile, live > 0, wb, n, n, k1, owns_n, warp,
                    geo.warps, lane, [&](int t, U sum) { rg_n[t] = sum; });
    }
  }
  skew::consumers_sync(cthreads);  // the ring is drained: the slots are free

  if (op == kConv) {
    // -- the operand window of each direction: given projections, or the
    // forward's registers of an operand image
    if (!geo.operand_image) {
      load_operand_window<R>(slots, wb, m0, mc, geo, threadIdx.x, cthreads);
    } else {
      const int reach = 32 * R * geo.conv_passes;
      skew::tile_emit(tile, q0, live, m0, runs, n, lane,
                      [&](int m, int d, U v) {
                        U* const e = slots +
                                     static_cast<size_t>(m - m0) * geo.e_slot +
                                     (n - 1);
                        for (int y = d - n; y < reach; y += n) {
                          if (y > -n) e[y] = v;
                        }
                      });
      if (owns_n) {
        U* const e = slots + static_cast<size_t>(n - m0) * geo.e_slot;
        for (int x = threadIdx.x; x < n - 1 + reach; x += cthreads) {
          e[x] = rg_n[(x + 1) % n];
        }
      }
    }
    skew::consumers_sync(cthreads);
    conv_rows<R>(rf, slots, ab, m0, mc, geo, warp, lane);
  } else {
    // -- mul, none: rc from the forward's registers into padded rows (its
    // directions are < N: row N went to aux with the row sums)
    skew::tile_emit(tile, q0, live, m0, runs, n, lane, [&](int m, int d, U v) {
      const U r = put_rc(slots, wb, m0, m, d, v, geo);
      if (m == 0) ab[d] = static_cast<T>(r);
    });
  }
  skew::consumers_sync(cthreads);

  // -- inverse: the block's rc rows of directions m < N
  if (ms > 0) {
    inverse_rows<K, I>(slots, out + static_cast<long long>(b) * n * n, m0, ms,
                       geo, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// K3, the mesh pipeline's shard-local tail (see pipeline_tail_launch): K2
// from the op on
// ---------------------------------------------------------------------------
// One block per (image b, block of D of the shard's n_rows rows), every
// warp a consumer (no forward, no ring); the block's first global
// direction is m0 = row_offset + its first row.  Rows of global index > N
// (the padding of the direction space) are zero, so the block keeps only
// its rows <= N -- the operand is never read past its row N -- and returns
// at once when it has none.
template <typename T, int K>
__global__ void __launch_bounds__(kPipeThreads, 1)
pipeline_tail_kernel(const T* __restrict__ rows, const T* __restrict__ w,
                     T* __restrict__ out, T* __restrict__ aux,
                     const PipeGeometry geo, int n_rows, int row_offset) {
  using U = arith_t<T>;
  constexpr int I = kPipeItems<sizeof(T)>;
  constexpr int R = skew::kConvRun<K>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  U* const rf = reinterpret_cast<U*>(smem_raw + skew::kBarrierBytes);
  U* const slots =
      reinterpret_cast<U*>(smem_raw + skew::kBarrierBytes + geo.rf_bytes);

  const int n = geo.n;
  const int b = blockIdx.x / geo.n_dblocks;
  const int k0 = (blockIdx.x - b * geo.n_dblocks) * geo.dirs;
  const long long dir0 = static_cast<long long>(row_offset) + k0;
  if (dir0 > n) return;  // block-uniform: every row is padding
  const int m0 = static_cast<int>(dir0);
  const int mc = min(min(geo.dirs, n_rows - k0), n + 1 - m0);
  const int ms = max(0, min(mc, n - m0));  // directions < N
  const T* const src =
      rows + b * geo.f_bstride + static_cast<long long>(k0) * n;
  const T* const wb = w == nullptr ? nullptr : w + b * geo.w_bstride;
  T* const ab = aux + static_cast<long long>(b) * 2 * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int threads = geo.warps * 32;

  // -- the shard's rows: conv into rf, beside each direction's operand
  // window; mul and none straight into the padded rc rows (and aux)
  if (geo.op == kConv) {
    for (int e = threadIdx.x; e < mc * n; e += threads) {
      rf[e] = static_cast<U>(src[e]);
    }
    load_operand_window<R>(slots, wb, m0, mc, geo, threadIdx.x, threads);
    __syncthreads();
    conv_rows<R>(rf, slots, ab, m0, mc, geo, warp, lane);
  } else {
    for (int e = threadIdx.x; e < mc * n; e += threads) {
      const int ml = e / n;
      const int m = m0 + ml;
      const int d = e - ml * n;
      const U r = put_rc(slots, wb, m0, m, d, static_cast<U>(src[e]), geo);
      if (m == 0) ab[d] = static_cast<T>(r);
      if (m == n) ab[n + d] = static_cast<T>(r);
    }
  }
  __syncthreads();
  // -- inverse: the block's rc rows of directions m < N
  if (ms > 0) {
    inverse_rows<K, I>(slots, out + static_cast<long long>(b) * n * n, m0, ms,
                       geo, warp, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pipeline_finish_kernel(T* __restrict__ out, const T* __restrict__ aux,
                       int n, int n_rblocks) {
  using U = arith_t<T>;
  __shared__ U part[kThreads];
  const int b = blockIdx.x / n_rblocks;
  const int i0 = (blockIdx.x - b * n_rblocks) * kFinishRows;
  const T* a0 = aux + static_cast<long long>(b) * 2 * n;
  const T* an = a0 + n;

  U s = U(0);
  for (int d = threadIdx.x; d < n; d += blockDim.x) s += static_cast<U>(a0[d]);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) part[threadIdx.x] += part[threadIdx.x + k];
    __syncthreads();
  }
  const U total = part[0];

  const int i1 = min(n, i0 + kFinishRows);
  T* ob = out + static_cast<long long>(b) * n * n;
  for (int e = i0 * n + threadIdx.x; e < i1 * n; e += blockDim.x) {
    const int i = e / n;
    const U num = static_cast<U>(ob[e]) - total + static_cast<U>(an[i]);
    ob[e] = divide_by_n(static_cast<T>(num), n);
  }
}

template <typename T, int K>
int launch(const void* f, const void* w, void* out, void* aux, int batch,
           const PipeGeometry& geo, size_t smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * geo.n_dblocks;
  const int n_rblocks = (geo.n + kFinishRows - 1) / kFinishRows;
  const long long fblocks = static_cast<long long>(batch) * n_rblocks;
  if (blocks > INT_MAX || fblocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pipeline_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(batch) * geo.n * geo.n * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_kernel<T, K><<<static_cast<unsigned>(blocks), (geo.warps + 1) * 32,
                          smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(aux), geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_finish_kernel<T><<<static_cast<unsigned>(fblocks), kThreads, 0,
                              stream>>>(static_cast<T*>(out),
                                        static_cast<const T*>(aux), geo.n,
                                        n_rblocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_tail(const void* rows, const void* w, void* out, void* aux,
                int batch, const PipeGeometry& geo, int n_rows,
                int row_offset, size_t smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * geo.n_dblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pipeline_tail_kernel<T, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(batch) * geo.n * geo.n * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(
      aux, 0, static_cast<size_t>(batch) * 2 * geo.n * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_tail_kernel<T, K><<<static_cast<unsigned>(blocks), geo.warps * 32,
                               smem, stream>>>(
      static_cast<const T*>(rows), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(aux), geo, n_rows, row_offset);
  return static_cast<int>(cudaGetLastError());
}

// The tile of kernels/tuning.py:pipeline_tile (K2) or tail_tile (K3) as
// the host passes it: the fields of its PipelineTile, in their order.
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
  kConvRun,
  kConvPasses,
  kESlot,
  kRcOff,
  kRfBytes,
  kSmem,
  kBlocks,
  kCount
};
}  // namespace tile

PipeGeometry read_tile(const int* t, int n, int op, int operand_image,
                       long long f_bstride, long long w_bstride) {
  PipeGeometry geo;
  geo.f_bstride = f_bstride;
  geo.w_bstride = w_bstride;
  geo.n = n;
  geo.dirs = t[tile::kMBlock];
  geo.n_dblocks = t[tile::kBlocks];
  geo.runs = t[tile::kRuns];
  geo.warps = t[tile::kWarps];
  geo.stage_rows = t[tile::kStageRows];
  geo.slots = t[tile::kSlots];
  geo.row_bytes = t[tile::kRowBytes];
  geo.pad = t[tile::kPad];
  geo.conv_passes = t[tile::kConvPasses];
  geo.e_slot = t[tile::kESlot];
  geo.rc_off = t[tile::kRcOff];
  geo.rf_bytes = t[tile::kRfBytes];
  geo.op = op;
  geo.operand_image = operand_image;
  return geo;
}

// The conditions that the op and inverse stages of both kernels rely on:
// the register tile, the padded rc rows, the conv's window and the rf
// rows, and shared memory for the rf rows and D slots within the budget.
template <typename T>
bool op_stages_ok(const PipeGeometry& geo, const int* t) {
  using LL = long long;
  const LL sz = static_cast<LL>(sizeof(T));
  const int n = geo.n, dirs = geo.dirs;
  const int cols = t[tile::kCols], conv_run = t[tile::kConvRun];
  const LL smem = t[tile::kSmem];
  const bool conv_ok =
      geo.op != kConv ||
      (geo.conv_passes >= 1 &&
       static_cast<LL>(geo.conv_passes) * 32 * conv_run >= n &&
       // the operand window: columns -(N-1) .. 32R*P of the slot
       geo.e_slot >= n - 1 + 32 * conv_run * geo.conv_passes &&
       // P > 1: each run writes rc behind the columns later runs read
       (geo.conv_passes == 1 || geo.rc_off >= n - 1) &&
       geo.rf_bytes >= static_cast<LL>(dirs + 1) * n * sz);
  return dirs >= 1 && dirs <= n + 1 && geo.warps >= 1 &&
         geo.warps <= kPipeMaxWarps &&
         t[tile::kItems] == kPipeItems<sizeof(T)> && n < (1 << 16) &&
         geo.runs >= 1 && geo.n_dblocks >= 1 &&
         // every column lies in a run, and no window leaves its padded row
         static_cast<LL>(geo.runs) * 32 * cols >= n &&
         geo.pad >= 32 * cols - 1 && geo.rc_off >= 0 &&
         geo.e_slot >= geo.rc_off + n + geo.pad && geo.rf_bytes >= 0 &&
         geo.rf_bytes % 16 == 0 && conv_ok &&
         smem >= skew::kBarrierBytes + geo.rf_bytes +
                     static_cast<LL>(dirs) * geo.e_slot * sz &&
         static_cast<size_t>(smem) <= skew::kSmemMax;
}

// launch(std::integral_constant<int, K>()) for the instantiation K = cols;
// a conv run other than that K's is refused.
template <typename F>
int by_cols(int cols, int conv_run, F&& launch) {
  switch (cols) {
    case 1:
      if (conv_run != skew::kConvRun<1>) break;
      return launch(std::integral_constant<int, 1>());
    case 2:
      if (conv_run != skew::kConvRun<2>) break;
      return launch(std::integral_constant<int, 2>());
    case 4:
      if (conv_run != skew::kConvRun<4>) break;
      return launch(std::integral_constant<int, 4>());
    case 8:
      if (conv_run != skew::kConvRun<8>) break;
      return launch(std::integral_constant<int, 8>());
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Check the host's tile against this instantiation and the budgets, and
// launch K2's instantiation of K.  The layout is the host's; these are
// the conditions the kernel relies on: the op stages', then the forward's
// (its warps hold the block's directions) and the ring's.
template <typename T>
int launch_checked(const void* f, long long f_bstride, const void* w,
                   long long w_bstride, void* out, void* aux, int batch,
                   int n, const int* t, int op, int operand_image,
                   cudaStream_t s) {
  const PipeGeometry geo =
      read_tile(t, n, op, operand_image, f_bstride, w_bstride);
  using LL = long long;
  const LL sz = static_cast<LL>(sizeof(T));
  const LL skew_rows = geo.dirs < n ? geo.dirs : n;
  const LL ring_area = static_cast<LL>(geo.slots) * geo.stage_rows *
                       geo.row_bytes;
  if (!op_stages_ok<T>(geo, t) ||
      static_cast<LL>(geo.warps) * t[tile::kItems] < skew_rows * geo.runs ||
      static_cast<LL>(geo.n_dblocks) * geo.dirs < n + 1 ||
      static_cast<LL>(geo.n_dblocks - 1) * geo.dirs >= n + 1 ||
      geo.stage_rows < 1 || geo.stage_rows > n || geo.slots < 1 ||
      // a row lands at its source's address mod 16: up to 15 bytes of lead
      geo.row_bytes % 16 != 0 ||
      geo.row_bytes < (static_cast<LL>(n) + geo.pad) * sz + 15 ||
      t[tile::kSmem] < skew::kBarrierBytes + geo.rf_bytes + ring_area ||
      geo.slots > skew::kMaxSlots || (geo.slots < 2 && n > geo.stage_rows)) {
    // the producer pads stage k - 1 after issuing stage k, so a ring of
    // one slot holds one stage only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(t[tile::kSmem]);
  return by_cols(t[tile::kCols], t[tile::kConvRun], [&](auto k) {
    return launch<T, decltype(k)::value>(f, w, out, aux, batch, geo, bytes, s);
  });
}

// The same for K3: the op stages' conditions, no ring, and blocks of D
// rows that cover the shard's n_rows rows.
template <typename T>
int launch_tail_checked(const void* rows, long long r_bstride, int n_rows,
                        const void* w, long long w_bstride, void* out,
                        void* aux, int batch, int n, const int* t,
                        int row_offset, int op, cudaStream_t s) {
  const PipeGeometry geo = read_tile(t, n, op, 0, r_bstride, w_bstride);
  using LL = long long;
  if (!op_stages_ok<T>(geo, t) || geo.stage_rows != 0 || geo.slots != 0 ||
      static_cast<LL>(geo.n_dblocks) * geo.dirs < n_rows ||
      static_cast<LL>(geo.n_dblocks - 1) * geo.dirs >= n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(t[tile::kSmem]);
  return by_cols(t[tile::kCols], t[tile::kConvRun], [&](auto k) {
    return launch_tail<T, decltype(k)::value>(rows, w, out, aux, batch, geo,
                                              n_rows, row_offset, bytes, s);
  });
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  op: 0 none, 1 mul,
// 2 conv.  f is (batch, n, n) with rows contiguous and batch stride
// f_bstride; w is the operand -- (batch|1, n, n) images when
// operand_image, else (batch|1, n+1, n) projections/weights -- with batch
// stride w_bstride (0 for one shared operand), or null for op none.
// out is (batch, n, n) and aux (batch, 2, n), both contiguous.  tile: the
// tile::kCount fields of kernels/tuning.py:pipeline_tile.  Returns a
// cudaError_t (0 on success); the work is asynchronous on `stream`.
extern "C" int pipeline_launch(int dtype, const void* f, long long f_bstride,
                               const void* w, long long w_bstride, void* out,
                               void* aux, int batch, int n, const int* tile,
                               int op, int operand_image, void* stream) {
  if (tile == nullptr || batch < 1 || n < 2 || op < kNone || op > kConv ||
      (op == kNone) != (w == nullptr) || (operand_image && op != kConv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_checked<int32_t>(f, f_bstride, w, w_bstride, out, aux,
                                     batch, n, tile, op, operand_image, s);
    case 1:
      return launch_checked<int64_t>(f, f_bstride, w, w_bstride, out, aux,
                                     batch, n, tile, op, operand_image, s);
    case 2:
      return launch_checked<float>(f, f_bstride, w, w_bstride, out, aux, batch,
                                   n, tile, op, operand_image, s);
    case 3:
      return launch_checked<double>(f, f_bstride, w, w_bstride, out, aux, batch,
                                    n, tile, op, operand_image, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3, the mesh pipeline's shard-local tail: the counterpart of the TPU
// kernel _pipeline_kernel with source="proj", defer=True and a traced
// row_offset (launched by pipeline_pallas_raw from pipeline_tail_pallas).
// rows is (batch, n_rows, n), rows contiguous, batch stride r_bstride:
// one shard of already-assembled projection rows whose first global
// direction is row_offset; rows of global index > n are taken as zero.
// w is the full (batch|1, n+1, n) operand (batch stride w_bstride, 0 for
// one shared operand), read at the global directions, or null for op
// none.  out (batch, n, n) receives the uncorrected inverse Z of the
// shard's directions < n, aux (batch, 2, n) the op's rows 0 and N where
// the shard holds them; both are zeroed first, and there is no
// correction or divide: it needs the sum of every shard's Z and aux.
// tile: the tile::kCount fields of kernels/tuning.py:tail_tile.
// Bound: at B = 256, N = 251 the inverse's adds (B * dirs * N^2) and, for
// conv, as many multiply-adds dominate the ~130 MB moved, so operations;
// the inverse is K2's register-tiled skew-sum, one shared load per add,
// and the conv K2's register window.
extern "C" int pipeline_tail_launch(int dtype, const void* rows,
                                    long long r_bstride, int n_rows,
                                    const void* w, long long w_bstride,
                                    void* out, void* aux, int batch, int n,
                                    const int* tile, int row_offset, int op,
                                    void* stream) {
  if (tile == nullptr || batch < 1 || n < 2 || n_rows < 1 ||
      row_offset < 0 || op < kNone || op > kConv ||
      (op == kNone) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_tail_checked<int32_t>(rows, r_bstride, n_rows, w,
                                          w_bstride, out, aux, batch, n, tile,
                                          row_offset, op, s);
    case 1:
      return launch_tail_checked<int64_t>(rows, r_bstride, n_rows, w,
                                          w_bstride, out, aux, batch, n, tile,
                                          row_offset, op, s);
    case 2:
      return launch_tail_checked<float>(rows, r_bstride, n_rows, w, w_bstride,
                                        out, aux, batch, n, tile, row_offset,
                                        op, s);
    case 3:
      return launch_tail_checked<double>(rows, r_bstride, n_rows, w,
                                         w_bstride, out, aux, batch, n, tile,
                                         row_offset, op, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
