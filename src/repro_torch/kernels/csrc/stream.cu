// K4 and K5 on Hopper: the streamed SFDPRT kernel, one launch per call.
//
// Replaces the TPU kernels repro/kernels/sfdprt.py:_stream_grid_kernel (K4,
// stream_impl="grid") and _stream_dma_kernel (K5, stream_impl="dma"), both
// launched by _pallas_stream_call.  It computes what K1 computes, in the
// same three modes, for a (B, rows, N) operand g in the type T it sums in,
// into an output of type O (T, or int64 from int32: below):
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
// The contract it keeps from the TPU kernels: the whole strip loop runs in
// one launch, the partial sums stay on chip for all of it, and the output
// is written exactly once.
//
// What bounds it.  The work is B*N^3 adds (2.75e11 int32 adds at N = 4099,
// B = 4: 16.4 ms at the card's 16.75e12 int32 adds/s).  Each add needs one
// shared-memory load of a staged image element, and a skew-sum gives no
// reuse of a loaded word across outputs, so the 128 bytes per clock of an
// SM's shared memory cap it lower: one 4-byte word per add is 32 adds per
// clock per SM, 32.9 ms at that shape; writing the stages into shared
// memory takes ~12% more of the same bandwidth at 9 directions per block.
// Every block also reads the whole image from L2 once (456 rereads per
// image at that shape).  The design spends ~1.65 other instructions per
// add (SASS: 207 instructions for 78 loads and adds in the inner loop), so
// neither instruction issue nor registers stand in the way of those two.
// 8-byte sums halve the adds a shared-memory clock feeds, thin the tile to
// 4 directions per block and double both the bytes and the blocks that
// reread the image (1025 per image), ~2.8x the time at that shape.
//
// The forward and the core of a narrow integer image (uint8, int16) need
// no 8-byte sums even where the result is int64 (uint8 at N >= 2903): an
// output sums at most N values of magnitude <= v, and v*N < 2^31 for every
// N the port runs, so the host hands an int32 operand and asks for an int64
// output (O = int64_t, T = int32_t; forward and core only).  The kernel
// then runs the 4-byte tile and its bounds above, and only the store
// widens: static_cast<O>(static_cast<T>(sum)), the wrapped unsigned sum
// read back as signed 32-bit first, so a negative int16 sum sign-extends.
//
// The inverse of int64 projections needs no 8-byte sums either wherever
// the values allow it, which the host cannot know without waiting on the
// device, so each block decides for its image (kernels/stream.py:
// inverse_gated).  The host hands the operand's low 32 bits as an int32
// operand and bounds[b] = lo_b, bounds[B + b] = hi_b, the least and the
// largest value of image b.  An output sums N of them, so its true sum
// lies in [N lo_b, N hi_b]; where N (hi_b - lo_b) < 2^32 (and lo_b, hi_b
// fit int32) that interval holds fewer than 2^32 integers, and the
// wrapped 32-bit sum fixes it: true = N lo_b + (uint32)(sum - N lo_b).
// The narrow variant (T = int32, O = int64, int64 corr, kNarrow) runs the
// 4-byte tile on the images that pass (narrow_fits) and returns at entry
// for the others; the int64 instantiation, given the same bounds, runs
// only the others; the epilogue rebuilds the sum in 64 bits, adds corr
// and floor-divides as the int64 route does, so both store the same bits.
//
// Design.  One thread block per (image b, block of D output rows), with
// `warps` consumer warps; the block owns all N columns of its rows,
// because output (m, d) reads g[i, <d + sign*m*(off+i)>_N], which can be
// any column.  The partial sums live in registers for the whole strip
// loop:
//
//   * an item is (direction m, column run c) with 32*kCols columns; lane L
//     of the warp that holds it owns the kCols outputs d = 32*kCols*c + L
//     + 32*j, j < kCols;
//   * a warp holds kItems items, consecutive in (m, c) order, so a block
//     holds D * runs <= warps * kItems of them (runs = ceil(N / 32kCols));
//     items past the block's last are dead (step 0, window 0): the loop
//     runs them without a test and nothing they add is stored;
//   * for each staged row every item steps one window base w = <32kCols*c
//     + sign*m*r>_N (add <sign*m>_N, subtract N on wrap) and lane L adds
//     row[w + L + 32j] for j < kCols: 32 consecutive words across the warp
//     (no bank conflicts), at immediate offsets from one address.
//
// The wrap inside a lane's run is handled by padding, not by a test per
// element: every staged row is followed in shared memory by its first
// P = 32*kCols - 1 columns again (column x of the padded row is column
// x mod N), so the window [w, w + 32kCols) never leaves the padded row.
// Padding was chosen over a split point with two base pointers because it
// keeps the inner loop free of compares and selects whatever w is; a split
// costs a select per element in the ~32kCols/N of windows that wrap, and
// for N < 32kCols every window wraps.  It costs P extra words per staged
// row (10% at N = 4099), copied inside shared memory once the row is there.
//
// The image streams through shared memory in stages of stage_rows rows,
// each row in a 16-byte aligned slot of row_bytes at the same address mod
// 16 as its source, so its 16-byte aligned interior is one aligned block
// and its ends [0, lo) and [hi, N) are at most 16 bytes together:
//
//   grid (K4)  one stage: the whole block copies it with cp.async (16-byte
//              vectors over the interiors, elements at the ends), waits,
//              __syncthreads, pads, __syncthreads, sums, __syncthreads --
//              the strip loop of the TPU grid, inside the block;
//   dma (K5)   a ring of `slots` stages fed by one producer warp beside the
//              consumers and signalled by mbarriers, not block-wide
//              barriers.  The producer issues stage k -- one cp.async.bulk
//              per row interior, whose bytes the copy engine completes on
//              landed[s], and element cp.async for the ends, whose lanes
//              arrive on landed[s] through cp.async.mbarrier.arrive.noinc
//              -- then waits for stage k - 1 to land, pads its rows from
//              shared memory and arrives on full[s]; the consumers wait on
//              full[s] and each warp arrives on empty[s] when done, which
//              frees slot s for stage k + slots.  This route serves every
//              operand alignment: the forward operand's image b starts at
//              4b mod 16 bytes when N^2 is odd, the row_offset partials
//              have a (N - 2)*N batch stride.  The producer shares its
//              scheduler with ~4 consumer warps, so it must issue little
//              and never stall: copying the padding from global memory with
//              4-byte cp.async, or loading the ends synchronously, made it
//              set the pace of the rows.
//
// TMA tensor maps are not used: they need 16-byte global strides, and a
// row of N prime 4- or 8-byte values never has one.
//
// The block that owns row N (forward mode) has no items for it: its
// consumer warps share the staged rows, sum each with a shuffle reduction
// and write R(N, col) for the row's global position col straight to the
// output (each column once); the columns no row reaches are written zero
// at the end.  After the last stage every lane writes its valid outputs
// (d < N) once, applying the inverse epilogue.
//
// kCols and kItems are template constants per accumulator width (Shape
// below), so the item and column loops unroll into independent loads and
// adds on fixed registers; the host (kernels/tuning.py:stream_tile) holds
// the same constants, picks D, warps, stage_rows and slots from them and
// the budgets (65,536 registers and 227 KB of shared memory per SM, one
// block per SM at giant N), and this file checks the geometry it is given.
// stream_rows only caps stage_rows, m_block only caps D; integer results
// depend on neither.
//
// Integer rules that differ from JAX: signed overflow is undefined in C++
// while JAX wraps, so every integer sum runs in the unsigned type of the
// same width; C '/' rounds toward zero, so the inverse's divide is corrected
// to floor; C '%' takes the dividend's sign, so every index is built from
// non-negative terms (row_offset is reduced mod N on the host); offsets
// into g and out are 64-bit.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCore = 0;
constexpr int kForward = 1;
constexpr int kInverse = 2;
constexpr int kGrid = 0;
constexpr int kDma = 1;
// Consumer warps per block, at most: K5's 15 and its producer warp are 16
// warps, which leave ptxas 128 registers a thread (a 17th warp spills);
// K4, whose consumers also copy the stages, spills at 14 and 15 warps too
// (ptxas still allots 128) and takes 12.
template <int kImpl>
constexpr int kWarps = kImpl == kDma ? 15 : 12;
constexpr int kMaxSlots = 8;      // stages in K5's ring, at most
constexpr int kBarrierBytes = 3 * kMaxSlots * 8;  // landed[], full[], empty[]
constexpr size_t kSmemMax = 232448;  // 227 KB, a block's opt-in maximum

// The register tile per accumulator width: kCols columns per lane per item,
// kItems items per warp (kernels/tuning.py:STREAM_SHAPES holds the same).
template <int kBytes>
struct Shape;
template <>
struct Shape<4> {
  static constexpr int kCols = 13;
  static constexpr int kItems = 6;
};
template <>
struct Shape<8> {
  static constexpr int kCols = 7;
  static constexpr int kItems = 6;
};

// The arithmetic type: the unsigned type of the same width for integers
// (wrapping, defined), the type itself for floats.
template <typename T, bool = std::is_integral<T>::value>
struct Arith {
  using type = T;
};
template <typename T>
struct Arith<T, true> {
  using type = typename std::make_unsigned<T>::type;
};
template <typename T>
using arith_t = typename Arith<T>::type;

template <typename T>
__device__ __forceinline__ T divide_by_n(T total, int n) {
  if constexpr (std::is_integral<T>::value) {
    T q = total / static_cast<T>(n);
    if (q * static_cast<T>(n) != total && total < 0) q -= 1;  // floor
    return q;
  } else {
    return total / static_cast<T>(n);
  }
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Whether image b of `batch` sums exactly in 32 bits (see the head of the
// file): its values fit int32 and N (hi - lo) < 2^32.  The first two tests
// bound hi - lo to (-2^32, 2^32), so nothing overflows.
__device__ __forceinline__ bool narrow_fits(const int64_t* bounds, int b,
                                            int batch, int n) {
  const int64_t lo = bounds[b];
  const int64_t hi = bounds[batch + b];
  return lo >= INT32_MIN && hi <= INT32_MAX &&
         hi - lo <= static_cast<int64_t>(UINT32_MAX) / n;
}

// The type of the inverse's correction: the operand's, or int64 in the
// narrow variant.
template <typename T, bool kNarrow>
using corr_t = typename std::conditional<kNarrow, int64_t, T>::type;

// What the host decided (kernels/tuning.py:stream_tile) plus what follows
// from it; checked by stream_launch before any launch.
struct Geometry {
  long long g_bstride;
  long long row_offset;
  int rows, n, out_rows;
  int dirs;        // D, directions per block
  int n_dblocks;   // direction blocks per image
  int runs;        // column runs per direction, ceil(N / 32kCols)
  int warps;       // consumer warps per block
  int stage_rows;  // rows per stage
  int slots;       // stages in the ring (1 for K4)
  int row_bytes;   // bytes of one padded row slot, a multiple of 16
  int pad;         // padding columns after each staged row, 32kCols - 1
  int sign, mode, off_mod;
};

// ---------------------------------------------------------------------------
// mbarrier, bulk and element async copies (PTX, sm_90)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// Order this thread's generic-proxy accesses of shared memory (the
// producer's padding writes; the consumers' reads, seen through the empty
// barrier) before the async-proxy writes of a bulk copy that refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// One bulk copy global -> shared; the copy engine completes `bytes` on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// one staged row: where it lands and how it is copied
// ---------------------------------------------------------------------------
// Row `src` lands in its slot at the same address mod 16, so its interior
// [lo, hi) (16-byte aligned on both sides) is one aligned block; columns
// [0, lo) and [hi, N) are its ends (at most 16 bytes together).
template <typename T>
struct RowSplit {
  const T* src;
  T* dst;
  int lo, hi;
};
template <typename T>
__device__ __forceinline__ RowSplit<T> row_split(unsigned char* slot,
                                                 const T* src, int n) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  int lo = ((16 - mis) & 15) / static_cast<int>(sizeof(T));
  if (lo > n) lo = n;
  constexpr int kVec = 16 / sizeof(T);
  const int hi = lo + (n - lo) / kVec * kVec;
  return {src, reinterpret_cast<T*>(slot + mis), lo, hi};
}

// Copy the ends of rows [src, src + ht*n) into `slot` with cp.async,
// thread `tid` of `count` threads: a few elements a row.
template <typename T>
__device__ void copy_ends(unsigned char* slot, const T* src, int ht, int n,
                          int row_bytes, int tid, int count) {
  for (int i = 0; i < ht; ++i) {
    const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                    src + static_cast<long long>(i) * n, n);
    for (int e = tid; e < r.lo + (n - r.hi); e += count) {
      const int x = e < r.lo ? e : r.hi + (e - r.lo);
      cp_async<sizeof(T)>(r.dst + x, r.src + x);
    }
  }
}

// Fill the padding of the staged rows from the rows themselves, already in
// `slot`: column n + e is column e mod n, e < pad.  Each thread loads 16
// bytes of columns before it stores them, so its loads overlap; the modulus
// runs only when the padding is longer than the row (N < pad).
template <typename T>
__device__ void pad_rows(unsigned char* slot, const T* src, int ht, int n,
                         int row_bytes, int pad, int tid, int count) {
  for (int i = 0; i < ht; ++i) {
    T* row = reinterpret_cast<T*>(
        slot + static_cast<size_t>(i) * row_bytes +
        (reinterpret_cast<uintptr_t>(src + static_cast<long long>(i) * n) &
         15));
    if (pad > n) {
      for (int e = tid; e < pad; e += count) row[n + e] = row[e % n];
      continue;
    }
    constexpr int kBatch = 16 / sizeof(T);
    for (int e0 = tid; e0 < pad; e0 += kBatch * count) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (e0 + u * count < pad) v[u] = row[e0 + u * count];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (e0 + u * count < pad) row[n + e0 + u * count] = v[u];
      }
    }
  }
}

// K5's producer, first half: issue stage rows [src, src + ht*n) into
// `slot`.  Lane 0 expects the interiors' bytes on `landed` and bulk-copies
// them; the lanes copy the ends and arrive on `landed` once they land.
template <typename T>
__device__ void issue_stage(unsigned char* slot, const T* src, int ht, int n,
                            int row_bytes, uint64_t* landed, int lane) {
  if (lane == 0) {
    uint32_t bytes = 0;
    for (int i = 0; i < ht; ++i) {
      const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                      src + static_cast<long long>(i) * n, n);
      bytes += static_cast<uint32_t>((r.hi - r.lo) * sizeof(T));
    }
    fence_proxy_async();
    mbar_arrive_expect_tx(landed, bytes);
    for (int i = 0; i < ht; ++i) {
      const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                      src + static_cast<long long>(i) * n, n);
      if (r.hi > r.lo) {
        bulk_copy(r.dst + r.lo, r.src + r.lo,
                  static_cast<uint32_t>((r.hi - r.lo) * sizeof(T)), landed);
      }
    }
  }
  copy_ends(slot, src, ht, n, row_bytes, lane, 32);
  cp_async_arrive(landed);
}

// K4's load: the whole block copies stage rows [src, src + ht*n) into
// `slot` (16-byte cp.async over the interiors, element copies at the
// ends), waits for all of it, then pads the rows: load, wait, and only
// then sum, as the TPU grid kernel does.
template <typename T>
__device__ void load_stage(unsigned char* slot, const T* src, int ht, int n,
                           int row_bytes, int pad) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = 0; i < ht; ++i) {
    const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                    src + static_cast<long long>(i) * n, n);
    for (int v = threadIdx.x; v < (r.hi - r.lo) / kVec; v += blockDim.x) {
      cp_async<16>(r.dst + r.lo + v * kVec, r.src + r.lo + v * kVec);
    }
  }
  copy_ends(slot, src, ht, n, row_bytes, threadIdx.x, blockDim.x);
  cp_async_wait_all();
  __syncthreads();
  pad_rows(slot, src, ht, n, row_bytes, pad, threadIdx.x, blockDim.x);
}

// The consumers' inner loop over one stage: for each staged row, each of
// the warp's items adds kCols words of the padded row into its registers
// and steps its window base.  Dead items (step 0, window 0) run too: no
// test per item, and what they add is never stored.
template <typename T>
__device__ __forceinline__ void sum_stage(
    arith_t<T> (&acc)[Shape<sizeof(T)>::kItems][Shape<sizeof(T)>::kCols],
    int (&w)[Shape<sizeof(T)>::kItems],
    const int (&step)[Shape<sizeof(T)>::kItems], const unsigned char* slot,
    const T* src, int ht, int n, int row_bytes, int lane) {
  using U = arith_t<T>;
  constexpr int K = Shape<sizeof(T)>::kCols;
  constexpr int I = Shape<sizeof(T)>::kItems;
  for (int i = 0; i < ht; ++i) {
    const int mis = static_cast<int>(
        reinterpret_cast<uintptr_t>(src + static_cast<long long>(i) * n) & 15);
    const T* row = reinterpret_cast<const T*>(
                       slot + static_cast<size_t>(i) * row_bytes + mis) +
                   lane;
#pragma unroll
    for (int u = 0; u < I; ++u) {
      const T* q = row + w[u];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[u][j] += static_cast<U>(q[32 * j]);
      const int x = w[u] + step[u];
      w[u] = x >= n ? x - n : x;
    }
  }
}

// bounds: nullptr, or the (2, B) per-image least and largest values of the
// inverse's int64 operand, which gate the narrow variant (kNarrow) and the
// int64 instantiation (see the head of the file); tally: the count of
// images the narrow variant ran, one atomic add per image.
template <typename T, int kImpl, typename O = T, bool kNarrow = false>
__global__ void __launch_bounds__((kWarps<kImpl> + (kImpl == kDma ? 1 : 0)) *
                                      32,
                                  1)
stream_kernel(const T* __restrict__ g,
              const corr_t<T, kNarrow>* __restrict__ corr,
              O* __restrict__ out, const Geometry geo,
              const int64_t* __restrict__ bounds,
              unsigned long long* __restrict__ tally) {
  using U = arith_t<T>;
  constexpr int K = Shape<sizeof(T)>::kCols;
  constexpr int I = Shape<sizeof(T)>::kItems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* const landed = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* const full = landed + kMaxSlots;
  uint64_t* const empty = full + kMaxSlots;
  unsigned char* const ring = smem_raw + kBarrierBytes;

  const int n = geo.n;
  const int b = blockIdx.x / geo.n_dblocks;
  const int m0 = (blockIdx.x - b * geo.n_dblocks) * geo.dirs;
  // the gate: every thread of the block reads the same bounds, so the
  // whole block returns, before any barrier, copy or producer work
  if constexpr (kNarrow) {
    if (!narrow_fits(bounds, b, gridDim.x / geo.n_dblocks, n)) return;
    if (m0 == 0 && threadIdx.x == 0) atomicAdd(tally, 1ull);
  } else if constexpr (std::is_same<T, int64_t>::value) {
    if (bounds != nullptr &&
        narrow_fits(bounds, b, gridDim.x / geo.n_dblocks, n)) {
      return;  // the narrow variant summed this image
    }
  }
  const int m_count = min(geo.dirs, geo.out_rows - m0);
  const int m_skew = max(0, min(m_count, n - m0));  // rows m < N
  const bool owns_row_sums =
      (geo.mode == kForward) && (n >= m0) && (n < m0 + m_count);
  const T* gb = g + static_cast<long long>(b) * geo.g_bstride;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_stages = (geo.rows + geo.stage_rows - 1) / geo.stage_rows;
  const size_t slot_bytes =
      static_cast<size_t>(geo.stage_rows) * geo.row_bytes;

  if constexpr (kImpl == kDma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < geo.slots; ++s) {
        mbar_init(&landed[s], 33);  // lane 0's expect_tx + 32 copy arrivals
        mbar_init(&full[s], 32);   // every producer lane, once padded
        mbar_init(&empty[s], geo.warps);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (warp == geo.warps) {  // the producer warp: issue stage k, pad k - 1
      for (int k = 0; k <= n_stages; ++k) {
        if (k < n_stages) {
          const int s = k % geo.slots;
          if (k >= geo.slots) mbar_wait(&empty[s], ((k / geo.slots) - 1) & 1);
          const int t0 = k * geo.stage_rows;
          issue_stage(ring + s * slot_bytes,
                      gb + static_cast<long long>(t0) * n,
                      min(geo.stage_rows, geo.rows - t0), n, geo.row_bytes,
                      &landed[s], lane);
        }
        if (k > 0) {
          const int j = k - 1;
          const int s = j % geo.slots;
          const int t0 = j * geo.stage_rows;
          mbar_wait(&landed[s], (j / geo.slots) & 1);
          pad_rows(ring + s * slot_bytes, gb + static_cast<long long>(t0) * n,
                   min(geo.stage_rows, geo.rows - t0), n, geo.row_bytes,
                   geo.pad, lane, 32);
          fence_proxy_async();  // before a later bulk copy refills the slot
          mbar_arrive(&full[s]);
        }
      }
      return;
    }
  }

  // this warp's items: (direction m, column run c), consecutive in the
  // block; items past the block's last one are dead: step 0 and window 0,
  // so the loop reads inside the row for them and nothing is stored
  const int q0 = warp * I;
  const int live = max(0, min(I, m_skew * geo.runs - q0));
  U acc[I][K];
  int w[I];
  int step[I];
#pragma unroll
  for (int u = 0; u < I; ++u) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[u][j] = U(0);
    const int q = q0 + u;
    const int m = m0 + q / geo.runs;
    const int c = q - (q / geo.runs) * geo.runs;
    // <sign*m>_N, and the window at row_offset: <32K*c + step*off>_N; a
    // direction fits one block, so N < 2^16 and the products fit 32 bits
    const unsigned st =
        u < live ? static_cast<unsigned>((geo.sign > 0 || m == 0) ? m : n - m)
                 : 0u;
    step[u] = static_cast<int>(st);
    w[u] = static_cast<int>((static_cast<unsigned>(c * 32 * K) % n +
                             st * static_cast<unsigned>(geo.off_mod) % n) %
                            n) *
           (u < live);
  }

  for (int k = 0; k < n_stages; ++k) {
    const int s = kImpl == kDma ? k % geo.slots : 0;
    const int t0 = k * geo.stage_rows;
    const int ht = min(geo.stage_rows, geo.rows - t0);
    const T* src = gb + static_cast<long long>(t0) * n;
    unsigned char* const slot = ring + s * slot_bytes;
    if constexpr (kImpl == kDma) {
      mbar_wait(&full[s], (k / geo.slots) & 1);
    } else {
      load_stage(slot, src, ht, n, geo.row_bytes, geo.pad);
      __syncthreads();
    }
    if (live > 0) {
      sum_stage<T>(acc, w, step, slot, src, ht, n, geo.row_bytes, lane);
    }
    if (owns_row_sums) {  // row N: one warp per staged row
      for (int i = warp; i < ht; i += geo.warps) {
        const long long col = geo.row_offset + t0 + i;
        if (col < 0 || col >= n) continue;  // the whole warp skips
        const T* row = reinterpret_cast<const T*>(
            slot + static_cast<size_t>(i) * geo.row_bytes +
            (reinterpret_cast<uintptr_t>(src + static_cast<long long>(i) * n) &
             15));
        U sum = U(0);
        for (int x = lane; x < n; x += 32) sum += static_cast<U>(row[x]);
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_down_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          out[(static_cast<long long>(b) * geo.out_rows + n) * n + col] =
              static_cast<O>(static_cast<T>(sum));
        }
      }
    }
    if constexpr (kImpl == kDma) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    } else {
      __syncthreads();
    }
  }

  // the outputs, written once
  O* const ob = out + static_cast<long long>(b) * geo.out_rows * n;
#pragma unroll
  for (int u = 0; u < I; ++u) {
    if (u < live) {
      const int q = q0 + u;
      const int m = m0 + q / geo.runs;
      const int c = q - (q / geo.runs) * geo.runs;
      O* const orow = ob + static_cast<long long>(m) * n;
      if constexpr (kNarrow) {
        // the true sum from its low 32 bits, N lo_b + (uint32)(sum - N
        // lo_b), plus corr, in the wrapping 64-bit arithmetic of the int64
        // route (N lo_b fits: |lo_b| <= 2^31, N < 2^16)
        const uint64_t base =
            static_cast<uint64_t>(static_cast<int64_t>(n) * bounds[b]);
        const uint64_t lead =
            base +
            static_cast<uint64_t>(corr[static_cast<long long>(b) * n + m]);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int d = c * 32 * K + lane + 32 * j;
          if (d < n) {
            const uint32_t rise = acc[u][j] - static_cast<uint32_t>(base);
            orow[d] = divide_by_n(static_cast<int64_t>(lead + rise), n);
          }
        }
      } else {
        const U cm =
            geo.mode == kInverse
                ? static_cast<U>(corr[static_cast<long long>(b) * n + m])
                : U(0);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int d = c * 32 * K + lane + 32 * j;
          if (d < n) {
            orow[d] = static_cast<O>(
                geo.mode == kInverse
                    ? divide_by_n(static_cast<T>(acc[u][j] + cm), n)
                    : static_cast<T>(acc[u][j]));
          }
        }
      }
    }
  }
  if (owns_row_sums) {  // row N's columns that no image row reaches
    O* const orow = ob + static_cast<long long>(n) * n;
    for (int col = threadIdx.x; col < n; col += geo.warps * 32) {
      const long long t = col - geo.row_offset;
      if (t < 0 || t >= geo.rows) orow[col] = O(0);
    }
  }
}

template <typename T, int kImpl, typename O, bool kNarrow>
int launch(const void* g, const void* corr, void* out, int batch,
           Geometry geo, const void* bounds, void* tally,
           cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * geo.n_dblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBarrierBytes + static_cast<size_t>(geo.slots) *
                                          geo.stage_rows * geo.row_bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<T, kImpl, O, kNarrow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (geo.warps + (kImpl == kDma ? 1 : 0)) * 32;
  stream_kernel<T, kImpl, O, kNarrow>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          static_cast<const T*>(g),
          static_cast<const corr_t<T, kNarrow>*>(corr), static_cast<O*>(out),
          geo, static_cast<const int64_t*>(bounds),
          static_cast<unsigned long long*>(tally));
  return static_cast<int>(cudaGetLastError());
}

// Fill in what follows from the host's choice and check it against this
// instantiation's Shape and the budgets.
template <typename T, typename O = T, bool kNarrow = false>
int launch_checked(int impl, const void* g, long long g_bstride,
                   const void* corr, void* out, int batch, int rows, int n,
                   int out_rows, int dirs, int warps, int cols, int items,
                   int stage_rows, int slots, int sign, int mode,
                   long long row_offset, const void* bounds, void* tally,
                   cudaStream_t s) {
  constexpr int K = Shape<sizeof(T)>::kCols;
  constexpr int I = Shape<sizeof(T)>::kItems;
  Geometry geo;
  geo.g_bstride = g_bstride;
  geo.row_offset = row_offset;
  geo.rows = rows;
  geo.n = n;
  geo.out_rows = out_rows;
  geo.dirs = dirs;
  geo.n_dblocks = (out_rows + dirs - 1) / dirs;
  geo.runs = (n + 32 * K - 1) / (32 * K);
  geo.warps = warps;
  geo.stage_rows = stage_rows;
  geo.slots = slots;
  geo.pad = 32 * K - 1;
  geo.row_bytes = static_cast<int>(
      align16(static_cast<size_t>(n + geo.pad) * sizeof(T)) + 16);
  geo.sign = sign;
  geo.mode = mode;
  geo.off_mod = static_cast<int>(((row_offset % n) + n) % n);
  if (cols != K || items != I ||
      warps > (impl == kDma ? kWarps<kDma> : kWarps<kGrid>) ||
      static_cast<long long>(warps) * I <
          static_cast<long long>(dirs) * geo.runs ||
      slots > kMaxSlots || (impl == kGrid && slots != 1) ||
      (impl == kDma && slots < 2 && rows > stage_rows)) {
    // K5's producer pads stage k - 1 after issuing stage k, so a ring of
    // one slot holds one stage only
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (impl == kGrid) {
    return launch<T, kGrid, O, kNarrow>(g, corr, out, batch, geo, bounds,
                                        tally, s);
  }
  return launch<T, kDma, O, kNarrow>(g, corr, out, batch, geo, bounds, tally,
                                     s);
}

}  // namespace

// dtype, out_dtype: 0 int32, 1 int64, 2 float32, 3 float64, the operand's
// and the output's, equal or int32 -> int64; impl: 0 grid (K4), 1 dma
// (K5); dirs, warps, cols, items, stage_rows, slots: the tile of
// kernels/tuning.py:stream_tile.  bounds, tally: nullptr, or in inverse
// mode the (2, B) int64 bounds of the operand's images (see the head of
// the file): an int32 operand with an int64 output and int64 corr runs
// the narrow variant on the images that pass and adds them to *tally; an
// int64 operand runs the others.  int32 -> int64 outside the inverse mode
// takes no bounds.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int stream_launch(int impl, int dtype, int out_dtype,
                             const void* g, long long g_bstride,
                             const void* corr, void* out,
                             int batch, int rows, int n, int out_rows,
                             int dirs, int warps, int cols, int items,
                             int stage_rows, int slots, int sign, int mode,
                             long long row_offset, void* stream,
                             const void* bounds, void* tally) {
  if (batch < 1 || rows < 1 || n < 1 || dirs < 1 || warps < 1 ||
      stage_rows < 1 || slots < 1 || (impl != kGrid && impl != kDma) ||
      (sign != 1 && sign != -1) || mode < kCore || mode > kInverse ||
      (mode == kInverse && corr == nullptr) ||
      (bounds != nullptr &&
       (mode != kInverse || (dtype != 0 && dtype != 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != dtype) {
    if (dtype != 0 || out_dtype != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (mode == kInverse) {
      if (bounds == nullptr || tally == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_checked<int32_t, int64_t, true>(
          impl, g, g_bstride, corr, out, batch, rows, n, out_rows, dirs,
          warps, cols, items, stage_rows, slots, sign, mode, row_offset,
          bounds, tally, s);
    }
    return launch_checked<int32_t, int64_t>(
        impl, g, g_bstride, corr, out, batch, rows, n, out_rows, dirs, warps,
        cols, items, stage_rows, slots, sign, mode, row_offset, nullptr,
        nullptr, s);
  }
  if (bounds != nullptr && dtype != 1) {  // an int32 operand gated: int64 out
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return launch_checked<int32_t>(impl, g, g_bstride, corr, out, batch,
                                     rows, n, out_rows, dirs, warps, cols,
                                     items, stage_rows, slots, sign, mode,
                                     row_offset, nullptr, nullptr, s);
    case 1:
      return launch_checked<int64_t>(impl, g, g_bstride, corr, out, batch,
                                     rows, n, out_rows, dirs, warps, cols,
                                     items, stage_rows, slots, sign, mode,
                                     row_offset, bounds, nullptr, s);
    case 2:
      return launch_checked<float>(impl, g, g_bstride, corr, out, batch, rows,
                                   n, out_rows, dirs, warps, cols, items,
                                   stage_rows, slots, sign, mode, row_offset,
                                   nullptr, nullptr, s);
    case 3:
      return launch_checked<double>(impl, g, g_bstride, corr, out, batch,
                                    rows, n, out_rows, dirs, warps, cols,
                                    items, stage_rows, slots, sign, mode,
                                    row_offset, nullptr, nullptr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
