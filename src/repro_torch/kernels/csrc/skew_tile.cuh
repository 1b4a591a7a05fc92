// The register-tiled skew-sum on Hopper: device code that K1
// (sfdprt.cu), K2 and K3 (pipeline.cu) share.
//
// A skew-sum adds, for every output (m, d), one element of each of its
// rows: out[m, d] = sum_r row_r[<d + s_m * r>_N].  Here the sums live in
// registers for the whole row loop:
//
//   * an item is (direction m, column run c) with 32*K columns; lane L of
//     the warp that holds it owns the K outputs d = 32*K*c + L + 32*j,
//     j < K.  A warp holds I items, consecutive in (m, c) order; items
//     past the last one are dead (step 0, window 0): the loop runs them
//     without a test and nothing they add is stored;
//   * for each row every item adds row[w + L + 32*j] for j < K -- 32
//     consecutive words across the warp (no bank conflicts) at immediate
//     offsets from one address -- and steps its window base w by <s_m>_N,
//     subtracting N on wrap;
//   * every row is followed in shared memory by its first P = 32*K - 1
//     columns again (column x of the padded row is column x mod N), so the
//     window [w, w + 32K) never leaves the padded row and the inner loop
//     has no compare or select per element.
//
// K is a template constant from a small set chosen by N on the host
// (kernels/tuning.py:skew_cols), so that a run of 32*K columns wastes
// little (N = 251: K = 8, 256 columns, 98% used) and the item and column
// loops unroll onto fixed registers.
//
// Rows reach shared memory through a ring of `slots` stages of
// `stage_rows` padded rows, fed by one producer warp beside the consumer
// warps and signalled by mbarriers (landed, full, empty per slot), with
// slots - 1 stages in flight: the producer bulk-copies each row's
// 16-byte aligned interior
// (cp.async.bulk, completed on landed[s]), copies its <= 16 end bytes
// with cp.async (arriving on landed[s] when they land), waits for the
// stage, pads its rows from shared memory and arrives on full[s]; each
// consumer warp waits on full[s] and arrives on empty[s] when done, which
// frees the slot for the stage `slots` later.  A row lands at its
// source's address mod 16, so every operand alignment is served (image b
// of an (N, N) stack starts at 4b mod 16 bytes when N^2 is odd).  TMA
// tensor maps are not used: a row of N prime 4- or 8-byte values never
// has a 16-byte global stride.
//
// Integer rules that differ from JAX: signed overflow is undefined in C++
// while JAX wraps, so every integer sum and product runs in the unsigned
// type of the same width; C '/' rounds toward zero, so divide_by_n
// corrects to floor; C '%' takes the dividend's sign, so every index is
// built from non-negative terms.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace skew {

constexpr int kMaxSlots = 8;                      // stages in a ring, at most
constexpr int kBarrierBytes = 3 * kMaxSlots * 8;  // landed[], full[], empty[]
constexpr size_t kSmemMax = 232448;  // 227 KB, a block's opt-in maximum

// Items a K1 warp holds per accumulator width (kernels/tuning.py:
// SKEW_ITEMS holds the same): 8 x K <= 64 accumulator registers for
// 4-byte sums, 4 x K 8-byte sums.  K2 and K3 hold fewer (pipeline.cu).
template <int kBytes>
constexpr int kItems = kBytes == 4 ? 8 : 4;

// The run of consecutive outputs one lane owns in the conv of K2 and K3
// (kernels/tuning.py:conv_run): odd, so that the lanes' loads at stride
// R hit 32 different banks, and >= K, so that a direction's padded rc
// row fits where its operand window lay.
template <int K>
constexpr int kConvRun = K == 1 ? 1 : K + 1;

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

// ---------------------------------------------------------------------------
// mbarrier, bulk and element async copies, named barriers (PTX, sm_90)
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
// Order this thread's generic-proxy accesses of shared memory before the
// async-proxy writes of a bulk copy that refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
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
// A barrier of the block's consumer warps alone (the producer warp has
// left by then): named barrier 1 over `threads` threads.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// the ring: where a staged row lands, how the producer fills it
// ---------------------------------------------------------------------------
struct Ring {
  unsigned char* base;  // slot 0
  uint64_t* landed;
  uint64_t* full;
  uint64_t* empty;
  int stage_rows, slots, row_bytes, pad;

  __device__ unsigned char* slot(int s) const {
    return base + static_cast<size_t>(s) * stage_rows * row_bytes;
  }
};

// Initialise the ring's mbarriers (one thread) for `consumer_warps`.
__device__ __forceinline__ void ring_init(const Ring& r, int consumer_warps) {
  for (int s = 0; s < r.slots; ++s) {
    mbar_init(&r.landed[s], 33);  // lane 0's expect_tx + 32 copy arrivals
    mbar_init(&r.full[s], 32);    // every producer lane, once padded
    mbar_init(&r.empty[s], consumer_warps);
  }
  mbar_fence_init();
}

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

// The staged copy of row `src` (its slot's first column).
template <typename T>
__device__ __forceinline__ const T* staged_row(const unsigned char* slot,
                                               const T* src) {
  return reinterpret_cast<const T*>(
      slot + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Issue stage rows [src, src + ht*n) into `slot`, one warp: lane 0
// expects the interiors' bytes on `landed`, then each lane bulk-copies
// the interiors of its rows (i = lane, lane + 32, ...) and copies the
// ends of all rows with element cp.async, arriving on `landed` once they
// land.
template <typename T>
__device__ void issue_stage(unsigned char* slot, const T* src, int ht, int n,
                            int row_bytes, uint64_t* landed, int lane) {
  uint32_t bytes = 0;
  for (int i = lane; i < ht; i += 32) {
    const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                    src + static_cast<long long>(i) * n, n);
    bytes += static_cast<uint32_t>((r.hi - r.lo) * sizeof(T));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
  }
  fence_proxy_async();
  if (lane == 0) mbar_arrive_expect_tx(landed, bytes);
  __syncwarp();
  for (int i = lane; i < ht; i += 32) {
    const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                    src + static_cast<long long>(i) * n, n);
    if (r.hi > r.lo) {
      bulk_copy(r.dst + r.lo, r.src + r.lo,
                static_cast<uint32_t>((r.hi - r.lo) * sizeof(T)), landed);
    }
  }
  for (int i = 0; i < ht; ++i) {
    const RowSplit<T> r = row_split(slot + static_cast<size_t>(i) * row_bytes,
                                    src + static_cast<long long>(i) * n, n);
    for (int e = lane; e < r.lo + (n - r.hi); e += 32) {
      const int x = e < r.lo ? e : r.hi + (e - r.lo);
      cp_async<sizeof(T)>(r.dst + x, r.src + x);
    }
  }
  cp_async_arrive(landed);
}

// Fill the padding of the stage's `ht` rows, already in `slot`: column
// n + e of a row is column e mod n, e < pad.  Pass k copies columns
// [k*n, k*n + n) of every padded row, which the previous pass completed
// (a padding longer than the row, N < 32K - 1, takes several); each lane
// loads 16 bytes of columns before it stores them, so its loads overlap.
// One warp.
template <typename T>
__device__ void pad_stage(unsigned char* slot, const T* src, int ht, int n,
                          int row_bytes, int pad, int lane) {
  constexpr int kBatch = 16 / sizeof(T);
  for (int base = 0; base < pad; base += n) {
    const int cnt = min(n, pad - base);
    for (int i = 0; i < ht; ++i) {
      T* row = const_cast<T*>(
          staged_row(slot + static_cast<size_t>(i) * row_bytes,
                     src + static_cast<long long>(i) * n));
      for (int e0 = lane; e0 < cnt; e0 += kBatch * 32) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (e0 + u * 32 < cnt) v[u] = row[base + e0 + u * 32];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (e0 + u * 32 < cnt) row[n + base + e0 + u * 32] = v[u];
        }
      }
    }
    __syncwarp();
  }
}

// The producer warp's loop over the `rows` rows of one operand (rows
// contiguous from src): it keeps slots - 1 stages in flight.  Iteration
// k pads stage k - ahead once that has landed, then issues stage k into
// the slot the consumers free next, so a stage's copy has slots - 1 stage
// times to arrive and its padding is done before the consumers reach it.
// A stage is padded at least one iteration after it is issued (ahead >=
// 1): a ring of one slot, which holds a single stage, issues it and pads
// it in the next iteration.  Stages are numbered globally from k0, so
// that one ring can stream several operands in turn; returns the number
// after the last.
template <typename T>
__device__ int produce(const Ring& r, const T* src, int rows, int n, int k0,
                       int lane) {
  const int n_stages = (rows + r.stage_rows - 1) / r.stage_rows;
  const int ahead = r.slots > 1 ? r.slots - 1 : 1;
  for (int k = 0; k < n_stages + ahead; ++k) {
    if (k >= ahead) {
      const int j = k - ahead;
      const int kk = k0 + j;
      const int s = kk % r.slots;
      const int t0 = j * r.stage_rows;
      mbar_wait(&r.landed[s], (kk / r.slots) & 1);
      pad_stage(r.slot(s), src + static_cast<long long>(t0) * n,
                min(r.stage_rows, rows - t0), n, r.row_bytes, r.pad, lane);
      fence_proxy_async();  // before a later bulk copy refills the slot
      mbar_arrive(&r.full[s]);
    }
    if (k < n_stages) {
      const int kk = k0 + k;
      const int s = kk % r.slots;
      // the slot's previous stage was padded an iteration ago: wait until
      // the consumers are done with it
      if (kk >= r.slots) mbar_wait(&r.empty[s], ((kk / r.slots) - 1) & 1);
      const int t0 = k * r.stage_rows;
      issue_stage(r.slot(s), src + static_cast<long long>(t0) * n,
                  min(r.stage_rows, rows - t0), n, r.row_bytes, &r.landed[s],
                  lane);
    }
  }
  return k0 + n_stages;
}

// ---------------------------------------------------------------------------
// the register tile of one warp: I items x K columns
// ---------------------------------------------------------------------------
template <typename U, int K, int I>
struct Tile {
  U acc[I][K];
  int w[I];     // window base of each item at the current row
  int step[I];  // <sign * direction>_N, 0 for a dead item
};

// Zero the sums and set the windows of the warp's items q0 .. q0 + I - 1
// of which the first `live` exist: item q is direction dir0 + q / runs,
// column run q % runs; at the first row (global row `off`, reduced mod N)
// its window base is <32K*c + step*off>_N.  A direction fits one block,
// so N < 2^16 and the products fit 32 unsigned bits.
template <typename U, int K, int I>
__device__ __forceinline__ void tile_init(Tile<U, K, I>& t, int q0, int live,
                                          int dir0, int runs, int sign, int n,
                                          int off_mod) {
#pragma unroll
  for (int u = 0; u < I; ++u) {
#pragma unroll
    for (int j = 0; j < K; ++j) t.acc[u][j] = U(0);
    const int q = q0 + u;
    const int m = dir0 + q / runs;
    const int c = q - (q / runs) * runs;
    const unsigned st =
        u < live ? static_cast<unsigned>((sign > 0 || m == 0) ? m : n - m)
                 : 0u;
    t.step[u] = static_cast<int>(st);
    t.w[u] = static_cast<int>((static_cast<unsigned>(c * 32 * K) % n +
                               st * static_cast<unsigned>(off_mod) % n) %
                              n) *
             (u < live);
  }
}

// One row of the skew-sum: `row` is the padded row's column 0 plus the
// lane; every item adds its K words and steps its window.
template <typename U, int K, int I, typename E>
__device__ __forceinline__ void tile_add_row(Tile<U, K, I>& t,
                                             const E* __restrict__ row,
                                             int n) {
#pragma unroll
  for (int u = 0; u < I; ++u) {
    const E* q = row + t.w[u];
#pragma unroll
    for (int j = 0; j < K; ++j) t.acc[u][j] += static_cast<U>(q[32 * j]);
    const int x = t.w[u] + t.step[u];
    t.w[u] = x >= n ? x - n : x;
  }
}

// Hand every live output to `emit(dir, d, value)`: item u's direction
// dir0 + q / runs and columns 32K*c + lane + 32j below N.
template <typename U, int K, int I, typename F>
__device__ __forceinline__ void tile_emit(const Tile<U, K, I>& t, int q0,
                                          int live, int dir0, int runs, int n,
                                          int lane, F&& emit) {
#pragma unroll
  for (int u = 0; u < I; ++u) {
    if (u < live) {
      const int q = q0 + u;
      const int m = dir0 + q / runs;
      const int c = q - (q / runs) * runs;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = c * 32 * K + lane + 32 * j;
        if (d < n) emit(m, d, t.acc[u][j]);
      }
    }
  }
}

// The sum of one staged row (n values from `row`) across the warp,
// returned to every lane.
template <typename U, typename E>
__device__ __forceinline__ U warp_row_sum(const E* row, int n, int lane) {
  U sum = U(0);
  for (int x = lane; x < n; x += 32) sum += static_cast<U>(row[x]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// The consumer warps' loop over the `rows` rows of one operand streamed
// through the ring (stages numbered from k0, as by produce): each staged
// row goes through tile_add_row when the warp holds live items, and when
// `row_sums` is set the warps also share the staged rows, one warp per
// row, and hand each row's sum to `emit_sum(t, sum)` on lane 0 (t: the
// row's index in the operand).  Returns the stage number after the last.
template <typename T, typename U, int K, int I, typename F>
__device__ int consume(const Ring& r, Tile<U, K, I>& tile, bool items,
                       const T* src, int rows, int n, int k0, bool row_sums,
                       int warp, int warps, int lane, F&& emit_sum) {
  const int n_stages = (rows + r.stage_rows - 1) / r.stage_rows;
  for (int k = 0; k < n_stages; ++k) {
    const int kk = k0 + k;
    const int s = kk % r.slots;
    const int t0 = k * r.stage_rows;
    const int ht = min(r.stage_rows, rows - t0);
    const T* const rsrc = src + static_cast<long long>(t0) * n;
    const unsigned char* const slot = r.slot(s);
    mbar_wait(&r.full[s], (kk / r.slots) & 1);
    if (items) {
      // one row at a time: a row's I*K loads are independent already, and
      // unrolling rows would hold a second row's loads in registers
#pragma unroll 1
      for (int i = 0; i < ht; ++i) {
        const T* row =
            staged_row(slot + static_cast<size_t>(i) * r.row_bytes,
                       rsrc + static_cast<long long>(i) * n);
        tile_add_row(tile, row + lane, n);
      }
    }
    if (row_sums) {
      for (int i = warp; i < ht; i += warps) {
        const T* row =
            staged_row(slot + static_cast<size_t>(i) * r.row_bytes,
                       rsrc + static_cast<long long>(i) * n);
        const U sum = warp_row_sum<U>(row, n, lane);
        if (lane == 0) emit_sum(t0 + i, sum);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[s]);
  }
  return k0 + n_stages;
}

}  // namespace skew
