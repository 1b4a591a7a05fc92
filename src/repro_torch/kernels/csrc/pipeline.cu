// K2 and K3 on Hopper: the fused projection-domain pipeline and its mesh
// tail.
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
// global direction is row_offset, so it drops the forward stage and runs
// the device functions load_rows / apply_op / write_aux / inverse_add:
// the op against the operand's rows at the global directions, the aux
// rows where the shard holds directions 0 and N, and the inverse of the
// shard's directions < N added into Z with atomicAdd (one shared-memory
// load per add and per multiply-add; not yet on K2's register tile).  It
// launches no finish kernel: the correction needs Z and aux summed over
// every shard first, which the caller does after its collectives.
//
// Integer rules that differ from JAX: signed overflow is undefined in C++
// while JAX wraps, so every integer sum and product runs in the unsigned
// type of the same width and is cast back; C '/' rounds toward zero, so
// the final divide is corrected to floor; C '%' takes the dividend's sign,
// so every index is built from non-negative terms.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "skew_tile.cuh"

namespace {

using skew::arith_t;
using skew::divide_by_n;

constexpr int kNone = 0;
constexpr int kMul = 1;
constexpr int kConv = 2;
constexpr int kThreads = 256;     // K3 and the finish kernel
constexpr int kFinishRows = 16;   // output rows per block of kernel 2
// K2: at most 11 consumer warps and the producer, one block per SM: ptxas
// (which counts warps in fours) keeps 168 registers a thread; at 13 to 16
// warps it keeps 128, and the int32 and float32 instantiations spilled.
constexpr int kPipeMaxWarps = 11;
constexpr int kPipeThreads = (kPipeMaxWarps + 1) * 32;
// Items a K2 warp holds per accumulator width (kernels/tuning.py:
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
// K2
// ---------------------------------------------------------------------------
// What the host decided (kernels/tuning.py:pipeline_tile), checked by
// launch_checked before any launch.
struct PipeGeometry {
  long long f_bstride, w_bstride;
  int n;
  int dirs;         // D, directions per block
  int n_dblocks;    // direction blocks per image
  int runs;         // column runs per direction, ceil(N / 32K)
  int warps;        // consumer warps per block
  int stage_rows;   // rows per stage
  int slots;        // stages in the ring
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

  const int pad = geo.pad;
  if (op == kConv) {
    // -- the operand window of each direction: slot[y + N - 1] = rg[<y>_N]
    // for y in [-(N - 1), 32R*P)
    const int reach = 32 * R * geo.conv_passes;
    const int ext = n - 1 + reach;
    if (!geo.operand_image) {
      for (int e = threadIdx.x; e < mc * ext; e += cthreads) {
        const int ml = e / ext;
        const int x = e - ml * ext;
        slots[static_cast<size_t>(ml) * geo.e_slot + x] = static_cast<U>(
            wb[static_cast<long long>(m0 + ml) * n + (x + 1) % n]);
      }
    } else {
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
        for (int x = threadIdx.x; x < ext; x += cthreads) {
          e[x] = rg_n[(x + 1) % n];
        }
      }
    }
    skew::consumers_sync(cthreads);
    // -- the conv, a warp per direction; its padded rc row replaces its
    // operand window (P > 1: each run writes behind the columns the runs
    // still to come read; P = 1: after the run, over the whole slot)
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
            for (int x = d; x < n + pad; x += n) rc[x] = acc[k];
            if (m == 0) ab[d] = static_cast<T>(acc[k]);
            if (m == n) ab[n + d] = static_cast<T>(acc[k]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // -- mul, none: rc from the forward's registers into padded rows
    skew::tile_emit(tile, q0, live, m0, runs, n, lane, [&](int m, int d, U v) {
      if (op == kMul) {
        v *= static_cast<U>(wb[static_cast<long long>(m) * n + d]);
      }
      if (m == 0) ab[d] = static_cast<T>(v);
      U* const rc =
          slots + static_cast<size_t>(m - m0) * geo.e_slot + geo.rc_off;
      for (int x = d; x < n + pad; x += n) rc[x] = v;
    });
  }
  skew::consumers_sync(cthreads);

  // -- inverse: items (output row i, column run) in passes of warps x I;
  // row ml of the skew-sum is rc of direction m0 + ml, so the window steps
  // by <-i>_N from <32K*c - i*m0>_N
  if (ms > 0) {
    T* const ob = out + static_cast<long long>(b) * n * n;
    const U* const rc0 = slots + geo.rc_off + lane;
    const int total = n * runs;
    for (int qb = 0; qb < total; qb += geo.warps * I) {
      const int qi = qb + q0;
      const int live_i = max(0, min(I, total - qi));
      if (live_i == 0) break;  // warp-uniform
      skew::tile_init(tile, qi, live_i, 0, runs, -1, n, m0 % n);
#pragma unroll 1  // one rc row at a time, as in skew::consume
      for (int ml = 0; ml < ms; ++ml) {
        skew::tile_add_row(tile, rc0 + static_cast<size_t>(ml) * geo.e_slot,
                           n);
      }
      skew::tile_emit(tile, qi, live_i, 0, runs, n, lane,
                      [&](int i, int d, U v) {
                        add_to(ob + static_cast<long long>(i) * n + d, v);
                      });
    }
  }
}

// ---------------------------------------------------------------------------
// K3's device functions (the mesh tail; K2 no longer uses them)
// ---------------------------------------------------------------------------
// dst[e] = src[e] for the first rows * n values (rows of the operand or
// of already-assembled projections, in T), widened to the arithmetic type.
template <typename T>
__device__ void load_rows(arith_t<T>* dst, const T* __restrict__ src, int n,
                          int rows) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    dst[e] = static_cast<arith_t<T>>(src[e]);
  }
  __syncthreads();
}

// The per-direction op over rows ml < mc of rf (shared memory); returns
// where the result rc lies.  conv: rc[ml, d] = sum_t rf[ml, t] *
// rg[ml, <d - t>_n] into `work`; mul: rf[ml, :] * w[ml, :] in place (w
// in T, the block's rows of the operand); none: rf itself.
template <typename T>
__device__ arith_t<T>* apply_op(arith_t<T>* rf, const arith_t<T>* rg,
                                arith_t<T>* work, const T* __restrict__ w,
                                int n, int mc, int op) {
  using U = arith_t<T>;
  const int size = mc * n;
  if (op == kConv) {
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      const int ml = e / n;
      const int d = e - ml * n;
      const U* a = rf + ml * n;  // a warp mostly shares ml: a broadcast
      const U* g = rg + ml * n;  // and reads neighbouring words here
      U acc = U(0);
      int idx = d;  // <d - t>_n
      for (int t = 0; t < n; ++t) {
        acc += a[t] * g[idx];
        idx = idx == 0 ? n - 1 : idx - 1;
      }
      work[e] = acc;
    }
    __syncthreads();
    return work;
  }
  if (op == kMul) {
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      rf[e] = rf[e] * static_cast<U>(w[e]);
    }
    __syncthreads();
  }
  return rf;
}

// The correction rows: rc's global direction 0 (for S) into aux row 0,
// direction N (the column R'(N, i)) into aux row 1, where this block
// holds them (its rows are global directions m0 .. m0 + mc - 1).
template <typename T>
__device__ void write_aux(const arith_t<T>* rc, T* __restrict__ ab, int n,
                          int m0, int mc) {
  if (m0 == 0) {
    for (int d = threadIdx.x; d < n; d += blockDim.x) {
      ab[d] = static_cast<T>(rc[d]);
    }
  }
  if (m0 <= n && n < m0 + mc) {
    const arith_t<T>* row = rc + static_cast<long long>(n - m0) * n;
    for (int d = threadIdx.x; d < n; d += blockDim.x) {
      ab[n + d] = static_cast<T>(row[d]);
    }
  }
}

// The inverse of directions m0 .. m0 + mi - 1 (all < n, rows of rc) onto
// all n x n outputs: ob[i, j] += sum_ml rc[ml, <j - (m0 + ml) * i>_n],
// across blocks with atomicAdd.
template <typename T>
__device__ void inverse_add(const arith_t<T>* rc, T* __restrict__ ob, int n,
                            int m0, int mi) {
  using U = arith_t<T>;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e - i * n;
    int idx = j - static_cast<int>((static_cast<long long>(m0) * i) % n);
    if (idx < 0) idx += n;  // <j - m0*i>_n
    U acc = U(0);
    const U* row = rc;
    for (int ml = 0; ml < mi; ++ml, row += n) {
      acc += row[idx];
      idx -= i;
      if (idx < 0) idx += n;
    }
    add_to(ob + e, acc);
  }
}

// K3, the mesh pipeline's shard-local tail (see pipeline_tail_launch).
// One block per (image b, block of m_block of the shard's n_rows rows);
// the block's first global direction is dir0 = row_offset + its first
// row.  Rows of global index > n (the padding of the direction space)
// are zero, so the block keeps only its rows <= n -- the operand is
// never read past its row n -- and returns early when it has none.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pipeline_tail_kernel(const T* __restrict__ rows, long long r_bstride,
                     int n_rows, const T* __restrict__ w,
                     long long w_bstride, T* __restrict__ out,
                     T* __restrict__ aux, int n, int m_block, int n_mblocks,
                     int row_offset, int op) {
  using U = arith_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* rf = reinterpret_cast<U*>(smem_raw);
  U* rg = rf + static_cast<size_t>(m_block) * n;  // conv only
  U* work = rg + static_cast<size_t>(m_block) * n;

  const int b = blockIdx.x / n_mblocks;
  const int k0 = (blockIdx.x - b * n_mblocks) * m_block;
  const long long dir0 = static_cast<long long>(row_offset) + k0;
  if (dir0 > n) return;  // block-uniform: every row is padding
  const int mc = static_cast<int>(
      min(static_cast<long long>(min(m_block, n_rows - k0)), n + 1 - dir0));
  const int m0 = static_cast<int>(dir0);

  load_rows<T>(rf, rows + b * r_bstride + static_cast<long long>(k0) * n, n,
               mc);
  const T* wb = w == nullptr
                    ? nullptr
                    : w + b * w_bstride + static_cast<long long>(m0) * n;
  if (op == kConv) load_rows<T>(rg, wb, n, mc);
  const U* rc = apply_op<T>(rf, rg, work, wb, n, mc, op);
  write_aux<T>(rc, aux + static_cast<long long>(b) * 2 * n, n, m0, mc);
  const int mi = min(mc, n - m0);  // rows of global direction < n
  if (mi > 0) {
    inverse_add<T>(rc, out + static_cast<long long>(b) * n * n, n, m0, mi);
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

// The tile of kernels/tuning.py:pipeline_tile as the host passes it:
// the fields of its PipelineTile, in their order.
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

// Check the host's tile against this instantiation and the budgets, and
// launch the instantiation of K.  The layout is the host's; these are
// the conditions the kernel relies on.
template <typename T>
int launch_checked(const void* f, long long f_bstride, const void* w,
                   long long w_bstride, void* out, void* aux, int batch,
                   int n, const int* t, int op, int operand_image,
                   cudaStream_t s) {
  const int dirs = t[tile::kMBlock], warps = t[tile::kWarps];
  const int cols = t[tile::kCols], items = t[tile::kItems];
  const int conv_run = t[tile::kConvRun], smem = t[tile::kSmem];
  PipeGeometry geo;
  geo.f_bstride = f_bstride;
  geo.w_bstride = w_bstride;
  geo.n = n;
  geo.dirs = dirs;
  geo.runs = t[tile::kRuns];
  geo.pad = t[tile::kPad];
  geo.row_bytes = t[tile::kRowBytes];
  geo.stage_rows = t[tile::kStageRows];
  geo.slots = t[tile::kSlots];
  geo.conv_passes = t[tile::kConvPasses];
  geo.e_slot = t[tile::kESlot];
  geo.rc_off = t[tile::kRcOff];
  geo.rf_bytes = t[tile::kRfBytes];
  geo.n_dblocks = t[tile::kBlocks];
  geo.warps = warps;
  geo.op = op;
  geo.operand_image = operand_image;
  using LL = long long;
  const LL sz = static_cast<LL>(sizeof(T));
  const LL skew_rows = dirs < n ? dirs : n;
  const LL slot_area = static_cast<LL>(dirs) * geo.e_slot * sz;
  const LL ring_area = static_cast<LL>(geo.slots) * geo.stage_rows *
                       geo.row_bytes;
  const LL need = skew::kBarrierBytes + geo.rf_bytes +
                  (slot_area > ring_area ? slot_area : ring_area);
  const bool conv_ok =
      op != kConv ||
      (geo.conv_passes >= 1 &&
       static_cast<LL>(geo.conv_passes) * 32 * conv_run >= n &&
       // the operand window: columns -(N-1) .. 32R*P of the slot
       geo.e_slot >= n - 1 + 32 * conv_run * geo.conv_passes &&
       // P > 1: each run writes rc behind the columns later runs read
       (geo.conv_passes == 1 || geo.rc_off >= n - 1) &&
       geo.rf_bytes >= static_cast<LL>(dirs + 1) * n * sz);
  if (dirs < 1 || dirs > n + 1 || warps < 1 || geo.stage_rows < 1 ||
      geo.stage_rows > n || geo.slots < 1 || geo.n_dblocks < 1 ||
      items != kPipeItems<sizeof(T)> || warps > kPipeMaxWarps ||
      n >= (1 << 16) || geo.runs < 1 ||
      // every column lies in a run, and no window leaves its padded row
      static_cast<LL>(geo.runs) * 32 * cols < n || geo.pad < 32 * cols - 1 ||
      // a row lands at its source's address mod 16: up to 15 bytes of lead
      geo.row_bytes % 16 != 0 ||
      geo.row_bytes < (static_cast<LL>(n) + geo.pad) * sz + 15 ||
      geo.rc_off < 0 || geo.e_slot < geo.rc_off + n + geo.pad ||
      geo.rf_bytes < 0 || geo.rf_bytes % 16 != 0 || !conv_ok ||
      static_cast<LL>(warps) * items < skew_rows * geo.runs ||
      static_cast<LL>(geo.n_dblocks) * dirs < n + 1 ||
      static_cast<LL>(geo.n_dblocks - 1) * dirs >= n + 1 ||
      geo.slots > skew::kMaxSlots || (geo.slots < 2 && n > geo.stage_rows) ||
      smem < need || static_cast<size_t>(smem) > skew::kSmemMax) {
    // the producer pads stage k - 1 after issuing stage k, so a ring of
    // one slot holds one stage only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(smem);
  switch (cols) {
    case 1:
      if (conv_run != skew::kConvRun<1>) break;
      return launch<T, 1>(f, w, out, aux, batch, geo, bytes, s);
    case 2:
      if (conv_run != skew::kConvRun<2>) break;
      return launch<T, 2>(f, w, out, aux, batch, geo, bytes, s);
    case 4:
      if (conv_run != skew::kConvRun<4>) break;
      return launch<T, 4>(f, w, out, aux, batch, geo, bytes, s);
    case 8:
      if (conv_run != skew::kConvRun<8>) break;
      return launch<T, 8>(f, w, out, aux, batch, geo, bytes, s);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_tail(const void* rows, long long r_bstride, int n_rows,
                const void* w, long long w_bstride, void* out, void* aux,
                int batch, int n, int m_block, int row_offset, int op,
                cudaStream_t stream) {
  const int n_mblocks = (n_rows + m_block - 1) / m_block;
  const long long blocks = static_cast<long long>(batch) * n_mblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int bufs = op == kConv ? 3 : 1;  // rf (+ rg and rc for conv)
  const size_t smem = static_cast<size_t>(bufs) * m_block * n * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pipeline_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(batch) * n * n * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(aux, 0, static_cast<size_t>(batch) * 2 * n * sizeof(T),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_tail_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(
      static_cast<const T*>(rows), r_bstride, n_rows,
      static_cast<const T*>(w), w_bstride, static_cast<T*>(out),
      static_cast<T*>(aux), n, m_block, n_mblocks, row_offset, op);
  return static_cast<int>(cudaGetLastError());
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
// Bound: at B = 256, N = 251 the inverse's adds (B * dirs * N^2) and, for
// conv, as many multiply-adds dominate the ~130 MB moved, so operations;
// each costs a shared-memory load here, as in K2.
extern "C" int pipeline_tail_launch(int dtype, const void* rows,
                                    long long r_bstride, int n_rows,
                                    const void* w, long long w_bstride,
                                    void* out, void* aux, int batch, int n,
                                    int m_block, int row_offset, int op,
                                    void* stream) {
  if (batch < 1 || n < 2 || n_rows < 1 || m_block < 1 || m_block > n_rows ||
      row_offset < 0 || op < kNone || op > kConv ||
      (op == kNone) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_tail<int32_t>(rows, r_bstride, n_rows, w, w_bstride,
                                        out, aux, batch, n, m_block,
                                        row_offset, op, s);
    case 1: return launch_tail<int64_t>(rows, r_bstride, n_rows, w, w_bstride,
                                        out, aux, batch, n, m_block,
                                        row_offset, op, s);
    case 2: return launch_tail<float>(rows, r_bstride, n_rows, w, w_bstride,
                                      out, aux, batch, n, m_block,
                                      row_offset, op, s);
    case 3: return launch_tail<double>(rows, r_bstride, n_rows, w, w_bstride,
                                       out, aux, batch, n, m_block,
                                       row_offset, op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


extern "C" const char* pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
