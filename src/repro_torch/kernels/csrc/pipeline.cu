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
// Design.  Kernel 1 (pipeline_kernel) runs one thread block per (image b,
// block of m_block directions), over ceil((N+1)/m_block) blocks, so the
// row-sum row N falls in the last block.  The block computes rf for its
// directions into shared memory, staging the image through a tile of
// tile_rows rows as K1 does (a 251 x 251 int32 image, 252 KB, does not
// fit the 227 KB a block can hold); for the image-form conv operand it
// computes rg the same way, for the projection form it copies its rows.
// The epilogue runs in shared memory: the conv is an O(N) loop per
// output over the operand row (rc goes to the tile area, free by then),
// mul and none work in place.  The block writes the aux rows it owns and
// then adds its directions' share of the inverse onto all N x N outputs.
// The blocks of one image run in parallel, so those partial sums are
// combined with atomicAdd into an output zeroed on the stream first:
// integer partials add in the unsigned type of the same width, which is
// exact, wraps as JAX does and does not depend on the order; float
// partials add in an order that changes from run to run, so floats agree
// with the plain version within a tolerance, never bit for bit.
// Kernel 2 (pipeline_finish_kernel), launched on the same stream after
// kernel 1, applies the correction and the floor divide once every block
// of the image is done: one block per (image, row band) reduces S from
// aux and rewrites its rows.  One pipeline call is a memset and these two
// launches.
//
// K3 (pipeline_tail_kernel, entry pipeline_tail_launch) replaces the same
// TPU kernel with source="proj", defer=True: the mesh pipeline's tail.
// Its input is one shard of already-summed projection rows whose first
// global direction is row_offset, so it drops the forward stage and runs
// the same device functions as kernel 1 from the epilogue on: the op
// against the operand's rows at the global directions, the aux rows
// where the shard holds directions 0 and N, and the inverse of the
// shard's directions < N added into Z with atomicAdd.  It launches no
// finish kernel: the correction needs Z and aux summed over every shard
// first, which the caller does after its collectives.
//
// Bound on the H100: at the main path's shapes (B = 256, N = 251, int32,
// conv) the call moves ~129 MB (~39 us at 3.35 TB/s) but does ~12.2e9
// integer adds and multiply-adds (forward, conv, inverse: ~4e9 each), so
// it is bound by operations.  Each of them here costs a shared-memory
// load and an index step as well; register tiling is left to a later
// change.
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

namespace {

constexpr int kNone = 0;
constexpr int kMul = 1;
constexpr int kConv = 2;
constexpr int kThreads = 256;
constexpr int kFinishRows = 16;  // output rows per block of kernel 2

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

// dst[ml * n + d] = R(m0 + ml, d) of the (n, n) image src for ml < mc:
// the skew-sum sum_i src[i, <d + m*i>_n] for m < n, the row sum
// R(n, d) = sum_j src[d, j] for m == n.  The image passes through
// `tile` in tiles of tile_rows rows; each output is owned by one thread
// and carries its partial sum in dst between tiles.
template <typename T>
__device__ void forward_rows(const T* __restrict__ src, T* tile,
                             arith_t<T>* dst, int n, int m0, int mc,
                             int tile_rows) {
  using U = arith_t<T>;
  const int work = mc * n;
  for (int t0 = 0; t0 < n; t0 += tile_rows) {
    const int ht = min(tile_rows, n - t0);
    __syncthreads();  // every thread is done with the previous tile
    const T* s = src + static_cast<long long>(t0) * n;
    for (int e = threadIdx.x; e < ht * n; e += blockDim.x) tile[e] = s[e];
    __syncthreads();
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int ml = w / n;
      const int d = w - ml * n;
      const int m = m0 + ml;
      U acc = (t0 == 0) ? U(0) : dst[w];
      if (m < n) {
        int idx = static_cast<int>((d + static_cast<long long>(m) * t0) % n);
        const T* row = tile;
        for (int i = 0; i < ht; ++i, row += n) {
          acc += static_cast<U>(row[idx]);
          idx += m;
          if (idx >= n) idx -= n;
        }
      } else {  // m == n: the row-sum row
        const int lr = d - t0;
        if (lr >= 0 && lr < ht) {
          const T* row = tile + static_cast<long long>(lr) * n;
          for (int j = 0; j < n; ++j) acc += static_cast<U>(row[j]);
        }
      }
      dst[w] = acc;
    }
  }
  __syncthreads();
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pipeline_kernel(const T* __restrict__ f, long long f_bstride,
                const T* __restrict__ w, long long w_bstride,
                T* __restrict__ out, T* __restrict__ aux, int n,
                int m_block, int n_mblocks, int tile_rows, int op,
                int operand_image) {
  using U = arith_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* rf = reinterpret_cast<U*>(smem_raw);
  U* rg = rf + static_cast<size_t>(m_block) * n;  // conv only
  U* work = op == kConv ? rg + static_cast<size_t>(m_block) * n : rg;
  T* tile = reinterpret_cast<T*>(work);  // image tiles, then rc for conv

  const int b = blockIdx.x / n_mblocks;
  const int m0 = (blockIdx.x - b * n_mblocks) * m_block;
  const int mc = min(m_block, n + 1 - m0);  // direction rows of this block

  forward_rows<T>(f + b * f_bstride, tile, rf, n, m0, mc, tile_rows);

  const T* wb = w == nullptr
                    ? nullptr
                    : w + b * w_bstride + static_cast<long long>(m0) * n;
  if (op == kConv) {
    if (operand_image) {
      forward_rows<T>(w + b * w_bstride, tile, rg, n, m0, mc, tile_rows);
    } else {
      load_rows<T>(rg, wb, n, mc);
    }
  }
  const U* rc = apply_op<T>(rf, rg, work, wb, n, mc, op);
  write_aux<T>(rc, aux + static_cast<long long>(b) * 2 * n, n, m0, mc);
  const int mi = min(mc, n - m0);  // rows m < n of this block
  if (mi > 0) {
    inverse_add<T>(rc, out + static_cast<long long>(b) * n * n, n, m0, mi);
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

template <typename T>
int launch(const void* f, long long f_bstride, const void* w,
           long long w_bstride, void* out, void* aux, int batch, int n,
           int m_block, int tile_rows, int op, int operand_image,
           cudaStream_t stream) {
  const int n_mblocks = (n + 1 + m_block - 1) / m_block;
  const long long blocks = static_cast<long long>(batch) * n_mblocks;
  const int n_rblocks = (n + kFinishRows - 1) / kFinishRows;
  const long long fblocks = static_cast<long long>(batch) * n_rblocks;
  if (blocks > INT_MAX || fblocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int work_rows = op == kConv ? max(tile_rows, m_block) : tile_rows;
  const int bufs = op == kConv ? 2 : 1;
  const size_t smem =
      static_cast<size_t>(bufs * m_block + work_rows) * n * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pipeline_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(batch) * n * n * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(f), f_bstride, static_cast<const T*>(w),
      w_bstride, static_cast<T*>(out), static_cast<T*>(aux), n, m_block,
      n_mblocks, tile_rows, op, operand_image);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pipeline_finish_kernel<T><<<static_cast<unsigned>(fblocks), kThreads, 0,
                              stream>>>(static_cast<T*>(out),
                                        static_cast<const T*>(aux), n,
                                        n_rblocks);
  return static_cast<int>(cudaGetLastError());
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
// out is (batch, n, n) and aux (batch, 2, n), both contiguous.  For conv,
// tile_rows < m_block is allowed: rc then uses m_block rows of the tile
// area.  Returns a cudaError_t (0 on success); the work is asynchronous
// on `stream`.
extern "C" int pipeline_launch(int dtype, const void* f, long long f_bstride,
                               const void* w, long long w_bstride, void* out,
                               void* aux, int batch, int n, int m_block,
                               int tile_rows, int op, int operand_image,
                               void* stream) {
  if (batch < 1 || n < 2 || m_block < 1 || m_block > n + 1 ||
      tile_rows < 1 || tile_rows > n || op < kNone || op > kConv ||
      (op == kNone) != (w == nullptr) || (operand_image && op != kConv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int32_t>(f, f_bstride, w, w_bstride, out, aux,
                                   batch, n, m_block, tile_rows, op,
                                   operand_image, s);
    case 1: return launch<int64_t>(f, f_bstride, w, w_bstride, out, aux,
                                   batch, n, m_block, tile_rows, op,
                                   operand_image, s);
    case 2: return launch<float>(f, f_bstride, w, w_bstride, out, aux,
                                 batch, n, m_block, tile_rows, op,
                                 operand_image, s);
    case 3: return launch<double>(f, f_bstride, w, w_bstride, out, aux,
                                  batch, n, m_block, tile_rows, op,
                                  operand_image, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
