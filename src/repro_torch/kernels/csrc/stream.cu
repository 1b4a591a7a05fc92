// K4 and K5 on Hopper: the streamed SFDPRT kernel, one launch per call.
//
// Replaces the TPU kernels repro/kernels/sfdprt.py:_stream_grid_kernel (K4,
// stream_impl="grid") and _stream_dma_kernel (K5, stream_impl="dma"), both
// launched by _pallas_stream_call.  It computes what K1 computes, in the
// same three modes, for a (B, rows, N) operand g in the accumulator type T:
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
// is written exactly once.  K1 instead keeps its partial sums in the output
// between row tiles; at N = 4099 that round trip is ~80 GB per image.
//
// Design.  One thread block (1024 threads) per (image b, block of m_block
// output rows); the block owns all N columns of its rows, because output
// (m, d) reads g[i, <d + sign*m*(off+i)>_N], which can be any column, so a
// block must see whole rows.  Its m_block x N partial sums live in shared
// memory in the unsigned type of T's width (integers) or T (floats).  The
// image streams through two shared-memory stages of stage_rows rows each:
//
//   grid (K4)  each stage is loaded synchronously (load, __syncthreads,
//              compute) -- the strip loop of the TPU grid, inside the block;
//   dma (K5)   stage k+1 is copied with cp.async (commit/wait groups) while
//              stage k is summed: the double buffer of the TPU kernel.
//
// For each stage, each thread walks outputs (m, d), d fastest, so a warp
// reads neighbouring shared-memory words; it sums the stage's rows in a
// register (index stepped by sign*m mod N, minus N on wrap, as in K1) and
// adds that sum once into the shared accumulator.  A stage's start index
// per direction, <sign*m*(off + t0)>_N, is computed once per stage into a
// small shared table, so no modulus runs per output.  The block that owns
// row N (forward mode) sums each staged row with one warp and a shuffle
// reduction and adds it at the row's global column.  After the last stage
// the block applies the inverse epilogue and writes its rows once.
//
// Shared memory is bounded whatever N is: the caller (kernels/tuning.py:
// stream_tile) picks m_block and stage_rows so that accumulators, the
// per-direction table and two stages (one for grid) fit 227 KB, and raises
// when not one direction and one row do.  stream_rows only caps stage_rows:
// at N = 4099 int32 one row is 16,396 bytes, so a 256-row strip (4.2 MB)
// streams as stages of 3 rows beside 7 directions of accumulators.  Integer
// results do not depend on either.
//
// The reckoning at the main path's shape (N = 4099, B = 4, int32): 7
// directions per block, 586 blocks per image, 2,344 blocks in all, one per
// SM (213 KB of shared memory); each block reads the 67 MB image once, so
// each image is read 586 times (39 GB per image, 157 GB in all).  Blocks
// start in waves of 132 and walk the stages in step, so most of those
// reads hit L2; at the L2's several TB/s that is well under the time the
// adds take.  The work is B*N^3 = 2.75e11 int32 adds (16.4 ms at the
// card's 16.75e12 int32 adds/s), so operations bound it; each add here
// also costs a shared-memory load and an index step, and each stage an
// accumulator load and store per output.  Register tiling is later work.
//
// TMA is not used: a tensor map needs 16-byte row strides, and a row of N
// prime int32 values (4N bytes) never has one.  A stage is S consecutive
// rows, i.e. one contiguous run of S*N elements, so it is copied as 16-byte
// cp.async vectors over its aligned interior and element copies at the two
// ends; the stage sits in shared memory at the same address mod 16 as its
// source.  The last stage is shorter when stage_rows does not divide rows:
// it copies and sums only the rows that exist.
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
constexpr int kThreads = 1024;
constexpr size_t kSmemMax = 232448;  // 227 KB, a block's opt-in maximum

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

// Shared-memory layout, the same on host and device: accumulators, the
// per-direction start table, then `slots` stages with 16 bytes of slack
// each (a stage starts at its source's address mod 16).
template <typename T>
__host__ __device__ size_t acc_bytes(int m_block, int n) {
  return align16(static_cast<size_t>(m_block) * n * sizeof(arith_t<T>));
}
__host__ __device__ inline size_t table_bytes(int m_block) {
  return align16(static_cast<size_t>(m_block) * sizeof(int));
}
template <typename T>
__host__ __device__ size_t slot_bytes(int stage_rows, int n) {
  return align16(static_cast<size_t>(stage_rows) * n * sizeof(T) + 16);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where stage `src` lands in slot `slot`: the same address mod 16.
template <typename T>
__device__ __forceinline__ T* stage_dst(unsigned char* slot, const T* src) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return reinterpret_cast<T*>(slot + (a & 15));
}

// Copy count contiguous elements src -> dst asynchronously: element copies
// up to the first 16-byte boundary, 16-byte vectors, element copies after.
template <typename T>
__device__ void stage_async(T* dst, const T* src, long long count) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  long long head = static_cast<long long>(((16 - (a & 15)) & 15) / sizeof(T));
  if (head > count) head = count;
  const long long nvec = (count - head) / kVec;
  const long long tail = head + nvec * kVec;
  for (long long e = threadIdx.x; e < head; e += blockDim.x) {
    cp_async<sizeof(T)>(dst + e, src + e);
  }
  for (long long v = threadIdx.x; v < nvec; v += blockDim.x) {
    cp_async<16>(dst + head + v * kVec, src + head + v * kVec);
  }
  for (long long e = tail + threadIdx.x; e < count; e += blockDim.x) {
    cp_async<sizeof(T)>(dst + e, src + e);
  }
}

template <typename T, int kImpl>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ g, long long g_bstride,
              const T* __restrict__ corr, T* __restrict__ out, int rows,
              int n, int out_rows, int m_block, int n_mblocks, int stage_rows,
              int sign, int mode, int off_mod, long long row_offset) {
  using U = arith_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* acc = reinterpret_cast<U*>(smem_raw);
  int* start = reinterpret_cast<int*>(smem_raw + acc_bytes<T>(m_block, n));
  // stage k lives in slot k & 1 (dma) or always slot 0 (grid)
  unsigned char* const slot0 =
      smem_raw + acc_bytes<T>(m_block, n) + table_bytes(m_block);
  const size_t slot_stride =
      kImpl == kDma ? slot_bytes<T>(stage_rows, n) : 0;

  const int b = blockIdx.x / n_mblocks;
  const int m0 = (blockIdx.x - b * n_mblocks) * m_block;
  const int m_count = min(m_block, out_rows - m0);
  const int m_skew = max(0, min(m_count, n - m0));  // rows m < N
  const int work = m_count * n;
  const T* gb = g + static_cast<long long>(b) * g_bstride;
  const bool owns_row_sums = (mode == kForward) && (n >= m0) &&
                             (n < m0 + m_count);

  for (int w = threadIdx.x; w < work; w += blockDim.x) acc[w] = U(0);

  const int n_stages = (rows + stage_rows - 1) / stage_rows;
  if constexpr (kImpl == kDma) {
    const long long cnt = static_cast<long long>(min(stage_rows, rows)) * n;
    stage_async(stage_dst(slot0, gb), gb, cnt);
    cp_async_commit();
  }
  for (int k = 0; k < n_stages; ++k) {
    const int t0 = k * stage_rows;
    const int ht = min(stage_rows, rows - t0);
    const T* src = gb + static_cast<long long>(t0) * n;
    const T* tile = stage_dst(slot0 + (k & 1) * slot_stride, src);
    if constexpr (kImpl == kDma) {
      if (k + 1 < n_stages) {  // prefetch stage k+1 into the other slot
        const int t1 = t0 + stage_rows;
        const T* nsrc = gb + static_cast<long long>(t1) * n;
        stage_async(stage_dst(slot0 + ((k + 1) & 1) * slot_stride, nsrc),
                    nsrc,
                    static_cast<long long>(min(stage_rows, rows - t1)) * n);
        cp_async_commit();
        cp_async_wait<1>();  // stage k has landed
      } else {
        cp_async_wait<0>();
      }
    } else {
      T* dst = stage_dst(slot0, src);
      const long long cnt = static_cast<long long>(ht) * n;
      for (long long e = threadIdx.x; e < cnt; e += blockDim.x) dst[e] = src[e];
    }
    // start index of each direction at this stage's first global row
    const int r0 = (off_mod + t0) % n;
    for (int ml = threadIdx.x; ml < m_skew; ml += blockDim.x) {
      const int m = m0 + ml;
      const int step = (sign > 0 || m == 0) ? m : n - m;  // <sign*m>_N
      start[ml] = static_cast<int>((static_cast<long long>(step) * r0) % n);
    }
    __syncthreads();  // the stage and the table are visible to every thread

    const int skew_work = m_skew * n;
    int ml = threadIdx.x / n;
    int d = threadIdx.x - ml * n;
    for (int w = threadIdx.x; w < skew_work; w += blockDim.x) {
      const int m = m0 + ml;
      // <sign*m>_N without a modulus: this runs once per output per stage
      const int step = (sign > 0 || m == 0) ? m : n - m;
      int idx = d + start[ml];
      if (idx >= n) idx -= n;
      U s = U(0);
      const T* row = tile;
      for (int i = 0; i < ht; ++i, row += n) {
        s += static_cast<U>(row[idx]);
        idx += step;
        if (idx >= n) idx -= n;
      }
      acc[w] += s;
      d += blockDim.x;
      while (d >= n) {
        d -= n;
        ++ml;
      }
    }
    if (owns_row_sums) {  // row N: one warp per staged row
      const int warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      for (int r = warp; r < ht; r += blockDim.x >> 5) {
        const long long col = row_offset + t0 + r;
        if (col < 0 || col >= n) continue;  // the whole warp skips
        U s = U(0);
        const T* row = tile + static_cast<long long>(r) * n;
        for (int j = lane; j < n; j += 32) s += static_cast<U>(row[j]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0) acc[static_cast<long long>(n - m0) * n + col] += s;
      }
    }
    __syncthreads();  // every thread is done with this slot and the table
  }

  // the output, written once
  T* ob = out + (static_cast<long long>(b) * out_rows + m0) * n;
  for (int w = threadIdx.x; w < work; w += blockDim.x) {
    const U v = acc[w];
    if (mode == kInverse) {
      const int m = m0 + w / n;
      ob[w] = divide_by_n(
          static_cast<T>(v + static_cast<U>(
                                 corr[static_cast<long long>(b) * n + m])),
          n);
    } else {
      ob[w] = static_cast<T>(v);
    }
  }
}

template <typename T, int kImpl>
int launch(const void* g, long long g_bstride, const void* corr, void* out,
           int batch, int rows, int n, int out_rows, int m_block,
           int stage_rows, int sign, int mode, long long row_offset,
           cudaStream_t stream) {
  const int n_mblocks = (out_rows + m_block - 1) / m_block;
  const long long blocks = static_cast<long long>(batch) * n_mblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = acc_bytes<T>(m_block, n) + table_bytes(m_block) +
                      (kImpl == kDma ? 2 : 1) * slot_bytes<T>(stage_rows, n);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<T, kImpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int off_mod = static_cast<int>(((row_offset % n) + n) % n);
  stream_kernel<T, kImpl>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(g), g_bstride, static_cast<const T*>(corr),
          static_cast<T*>(out), rows, n, out_rows, m_block, n_mblocks,
          stage_rows, sign, mode, off_mod, row_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_impl(int impl, const void* g, long long g_bstride,
                const void* corr, void* out, int batch, int rows, int n,
                int out_rows, int m_block, int stage_rows, int sign, int mode,
                long long row_offset, cudaStream_t s) {
  if (impl == kGrid) {
    return launch<T, kGrid>(g, g_bstride, corr, out, batch, rows, n,
                            out_rows, m_block, stage_rows, sign, mode,
                            row_offset, s);
  }
  return launch<T, kDma>(g, g_bstride, corr, out, batch, rows, n, out_rows,
                         m_block, stage_rows, sign, mode, row_offset, s);
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; impl: 0 grid (K4), 1 dma
// (K5).  Returns a cudaError_t (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int stream_launch(int impl, int dtype, const void* g,
                             long long g_bstride, const void* corr, void* out,
                             int batch, int rows, int n, int out_rows,
                             int m_block, int stage_rows, int sign, int mode,
                             long long row_offset, void* stream) {
  if (batch < 1 || rows < 1 || n < 1 || m_block < 1 || stage_rows < 1 ||
      (impl != kGrid && impl != kDma) || (sign != 1 && sign != -1) ||
      mode < kCore || mode > kInverse ||
      (mode == kInverse && corr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_impl<int32_t>(impl, g, g_bstride, corr, out, batch,
                                        rows, n, out_rows, m_block,
                                        stage_rows, sign, mode, row_offset, s);
    case 1: return launch_impl<int64_t>(impl, g, g_bstride, corr, out, batch,
                                        rows, n, out_rows, m_block,
                                        stage_rows, sign, mode, row_offset, s);
    case 2: return launch_impl<float>(impl, g, g_bstride, corr, out, batch,
                                      rows, n, out_rows, m_block, stage_rows,
                                      sign, mode, row_offset, s);
    case 3: return launch_impl<double>(impl, g, g_bstride, corr, out, batch,
                                       rows, n, out_rows, m_block, stage_rows,
                                       sign, mode, row_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
