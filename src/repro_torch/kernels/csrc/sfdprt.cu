// K1 on Hopper: the fused, batched SFDPRT skew-sum kernel.
//
// Replaces the TPU kernel repro/kernels/sfdprt.py:_sfdprt_kernel (launched
// by _pallas_skew_call).  It computes what that kernel computes, in three
// modes, for a (B, rows, N) operand g in the accumulator type T:
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
// Design.  One thread block per (image b, block of m_block output rows).
// The image is staged through shared memory in tiles of tile_rows rows
// (the caller caps tile_rows at strip_rows and at what fits in the
// shared-memory budget: a whole 251 x 251 int32 image is 252 KB, more
// than the 227 KB a block can hold, so the main path streams it in
// tiles; integer results do not depend on the tile height).  The
// block's threads walk the (m, d) outputs it owns, d fastest, so a warp
// reads 32 neighbouring shared-memory words per row.  Each thread keeps
// the sum of one (m, d) output in a register over the tile's rows,
// reading tile[i][idx] and stepping idx by sign*m mod N, minus N on
// wrap -- the circular shift of the paper's Horner step, with no
// rotate+select ladder (a TPU layout device) and no modulus in the loop.
// Between tiles the partial sum lives in the output itself; each (m, d)
// belongs to exactly one thread, so nothing races.  Output rows past
// out_rows in the last m-block are never computed nor written.
//
// Bound on the H100: at the main path's shapes (B = 256, N = 251, int32)
// the kernel moves ~129 MB (39 us at 3.35 TB/s) but does B*N^3 = 4.0e9
// integer adds, so it is bound by operations, not bytes.  Each add here
// costs a shared-memory load and an index step as well; tiling d and
// m per thread to reuse loads is left to a later change.
//
// Integer rules that differ from JAX: signed overflow is undefined in C++
// while JAX wraps, so every integer sum (the skew-sum, the row-sum row and
// Z + corr before the divide) runs in the unsigned type of the same width
// and is cast back; C '/' rounds toward zero, so the inverse's divide is
// corrected to round toward minus infinity (JAX '//') on the signed value;
// C '%' takes the dividend's sign, so every index here is built from
// non-negative terms (the host reduces row_offset mod N first).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCore = 0;
constexpr int kForward = 1;
constexpr int kInverse = 2;
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
sfdprt_kernel(const T* __restrict__ g, long long g_bstride,
              const T* __restrict__ corr, T* __restrict__ out, int rows,
              int n, int out_rows, int m_block, int n_mblocks, int tile_rows,
              int sign, int mode, int off_mod, long long row_offset) {
  using U = arith_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x / n_mblocks;
  const int m0 = (blockIdx.x - b * n_mblocks) * m_block;
  const int m_count = min(m_block, out_rows - m0);
  const T* gb = g + static_cast<long long>(b) * g_bstride;
  T* ob = out + static_cast<long long>(b) * out_rows * n;
  const int work = m_count * n;

  for (int t0 = 0; t0 < rows; t0 += tile_rows) {
    const int ht = min(tile_rows, rows - t0);
    __syncthreads();  // every thread is done with the previous tile
    const T* src = gb + static_cast<long long>(t0) * n;
    for (int e = threadIdx.x; e < ht * n; e += blockDim.x) tile[e] = src[e];
    __syncthreads();

    const int r0 = (off_mod + t0) % n;  // first global row of the tile, mod N
    const bool first = (t0 == 0);
    const bool last = (t0 + ht >= rows);
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int ml = w / n;
      const int d = w - ml * n;
      const int m = m0 + ml;
      const long long o = static_cast<long long>(m) * n + d;
      U acc = first ? U(0) : static_cast<U>(ob[o]);
      if (m < n) {
        const int step = sign > 0 ? m : (n - m) % n;  // <sign*m>_N
        int idx = static_cast<int>((d + static_cast<long long>(step) * r0) % n);
        const T* row = tile;
        for (int i = 0; i < ht; ++i, row += n) {
          acc += static_cast<U>(row[idx]);
          idx += step;
          if (idx >= n) idx -= n;
        }
      } else if (mode == kForward) {  // m == n: the row-sum row
        const long long lr = static_cast<long long>(d) - row_offset - t0;
        if (lr >= 0 && lr < ht) {
          const T* row = tile + lr * n;
          for (int j = 0; j < n; ++j) acc += static_cast<U>(row[j]);
        }
      }
      if (last && mode == kInverse) {
        ob[o] = divide_by_n(
            static_cast<T>(acc + static_cast<U>(
                                     corr[static_cast<long long>(b) * n + m])),
            n);
      } else {
        ob[o] = static_cast<T>(acc);
      }
    }
  }
}

template <typename T>
int launch(const void* g, long long g_bstride, const void* corr, void* out,
           int batch, int rows, int n, int out_rows, int m_block,
           int tile_rows, int sign, int mode, long long row_offset,
           cudaStream_t stream) {
  const int n_mblocks = (out_rows + m_block - 1) / m_block;
  const long long blocks = static_cast<long long>(batch) * n_mblocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile_rows) * n * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sfdprt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int off_mod = static_cast<int>(((row_offset % n) + n) % n);
  sfdprt_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(g), g_bstride, static_cast<const T*>(corr),
      static_cast<T*>(out), rows, n, out_rows, m_block, n_mblocks, tile_rows,
      sign, mode, off_mod, row_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int sfdprt_launch(int dtype, const void* g, long long g_bstride,
                             const void* corr, void* out, int batch, int rows,
                             int n, int out_rows, int m_block, int tile_rows,
                             int sign, int mode, long long row_offset,
                             void* stream) {
  if (batch < 1 || rows < 1 || n < 1 || m_block < 1 || tile_rows < 1 ||
      (sign != 1 && sign != -1) || mode < kCore || mode > kInverse ||
      (mode == kInverse && corr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int32_t>(g, g_bstride, corr, out, batch, rows, n,
                                   out_rows, m_block, tile_rows, sign, mode,
                                   row_offset, s);
    case 1: return launch<int64_t>(g, g_bstride, corr, out, batch, rows, n,
                                   out_rows, m_block, tile_rows, sign, mode,
                                   row_offset, s);
    case 2: return launch<float>(g, g_bstride, corr, out, batch, rows, n,
                                 out_rows, m_block, tile_rows, sign, mode,
                                 row_offset, s);
    case 3: return launch<double>(g, g_bstride, corr, out, batch, rows, n,
                                  out_rows, m_block, tile_rows, sign, mode,
                                  row_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sfdprt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
