// Dantzig pricing scan: one pass over A giving min_j e_j, its lowest index,
// and the first j with e_j < -eps, where e = y.A - c. e never reaches device
// memory in full.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, pricing_scan / _pricing_kernel
// (the pl.pallas_call at line 140).
//
// Bound on the H100: device-memory bandwidth. The pass reads A once
// (m * n * 4 bytes, 512 MiB at 8192 x 16384 fp32) and does 2 flops per
// element read, far below the card's ops-per-byte ridge.
//
// Design: the Pallas grid walks row tiles in order and carries a column
// accumulator; Hopper blocks run in no order, so that carry is replaced by
// a split over rows:
//   pass 1  grid (column tiles of 1024, row chunks). Each thread owns 4
//           neighbouring columns (one 16-byte load per row when aligned) and
//           sums y_i A_ij over its chunk's rows in row order, writing one
//           partial row of a (chunks, n) scratch. Splitting the rows gives
//           ~8 blocks per SM at n = 16384, where one column per thread would
//           fill only 64 blocks. Loads along A's rows are coalesced.
//   pass 2  one thread per column adds the chunk partials in chunk order,
//           subtracts c_j and reduces (min, lowest argmin, first index below
//           -eps) over its block.
//   pass 3  one block reduces the per-block results.
// Every sum runs in a fixed order and every reduction breaks ties to the
// lowest index, so the result is deterministic; no float atomics. A NaN in
// e wins the min (with its lowest index), as jnp.argmin / torch.argmin do.
// A may be fp32 or bf16 (upcast per element, accumulated in fp32), and a
// column range of a wider matrix: rows are lda elements apart, so segmented
// pricing scans a view of the shadow in place, without an O(mn/S) copy. The
// row chunks are a function of the range's (m, n) alone (the wrapper picks
// them), so a segment's result does not depend on the matrix around it.
//
// Signed mode (the bounded-variable rule, which the JAX package prices
// through XLA): given flip (the at-upper flag of each column, one byte) and
// the basis, pass 2 reduces s_j = (flip_j ? -e_j : e_j) + pen_j instead of
// e_j, where pen_j = 1e30 at the basic columns that fall in the range
// [base_col, base_col + n) and 0 elsewhere. pen is a scratch row, zeroed and
// marked by one small launch before pass 2. The bounded step thus prices
// fp32 A, the bf16 shadow or a segment view of either in one pass, without
// an fp32 copy of a bf16 A, and with the penalty made in the same call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIntMax = 0x7fffffff;
constexpr int kPartialThreads = 256;
constexpr int kColsPerBlock = 4 * kPartialThreads;
constexpr int kReduceThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBasicPenalty = 1e30f;  // kernels/ops.py BASIC_PENALTY
constexpr int kMarkThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// four neighbouring elements starting at p (16-byte aligned for fp32,
// 8-byte aligned for bf16; the launcher checks)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kPartialThreads)
pricing_partial_kernel(const float* __restrict__ y, const T* __restrict__ A,
                       int m, int n, size_t lda, int rows_per_chunk,
                       float* __restrict__ partial) {
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);
  const int j0 = blockIdx.x * kColsPerBlock;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (kVec) {
    const int j = j0 + 4 * threadIdx.x;  // n % 4 == 0, so j + 3 < n too
    if (j >= n) return;
#pragma unroll 4
    for (int i = r0; i < r1; ++i) {
      const float yi = y[i];
      float a[4];
      load4(A + i * lda + j, a);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(yi, a[k], acc[k]);
    }
    float4 out = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(partial + (size_t)chunk * n + j) = out;
  } else {
    int cols[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cols[k] = j0 + threadIdx.x + k * kPartialThreads;
#pragma unroll 4
    for (int i = r0; i < r1; ++i) {
      const float yi = y[i];
      const T* row = A + i * lda;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cols[k] < n) acc[k] = fmaf(yi, to_float(row[cols[k]]), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cols[k] < n) partial[(size_t)chunk * n + cols[k]] = acc[k];
  }
}

// pen[basis_i - base_col] = 1e30 for the basic columns inside the range
__global__ void __launch_bounds__(kMarkThreads)
pricing_mark_basic_kernel(const int* __restrict__ basis, int m_basis,
                          int base_col, int n, float* __restrict__ pen) {
  const int i = blockIdx.x * kMarkThreads + threadIdx.x;
  if (i >= m_basis) return;
  const int j = basis[i] - base_col;
  if (j >= 0 && j < n) pen[j] = kBasicPenalty;
}

// (value, index) order of the min: NaN first, then smaller value, then
// lower index
__device__ __forceinline__ bool min_before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ void warp_reduce(float& v, int& arg, int& neg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oa = __shfl_down_sync(kFull, arg, off);
    const int on = __shfl_down_sync(kFull, neg, off);
    if (min_before(ov, oa, v, arg)) { v = ov; arg = oa; }
    neg = min(neg, on);
  }
}

// reduces (v, arg, neg) over the block; the result is valid in thread 0.
// blockDim.x is a multiple of 32 and at most 1024.
__device__ __forceinline__ void block_reduce(float& v, int& arg, int& neg) {
  __shared__ float s_v[32];
  __shared__ int s_arg[32];
  __shared__ int s_neg[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(v, arg, neg);
  if (lane == 0) { s_v[warp] = v; s_arg[warp] = arg; s_neg[warp] = neg; }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? s_v[lane] : INFINITY;
    arg = lane < nwarps ? s_arg[lane] : kIntMax;
    neg = lane < nwarps ? s_neg[lane] : kIntMax;
    warp_reduce(v, arg, neg);
  }
}

__global__ void __launch_bounds__(kReduceThreads)
pricing_columns_kernel(const float* __restrict__ partial, int chunks,
                       const float* __restrict__ c,
                       const unsigned char* __restrict__ flip,
                       const float* __restrict__ pen, int n, float eps,
                       float* __restrict__ blk_min, int* __restrict__ blk_arg,
                       int* __restrict__ blk_neg) {
  const int j = blockIdx.x * kReduceThreads + threadIdx.x;
  float v = INFINITY;
  int arg = kIntMax;
  int neg = kIntMax;
  if (j < n) {
    float e = 0.f;
    for (int k = 0; k < chunks; ++k) e += partial[(size_t)k * n + j];
    e -= c[j];
    if (flip != nullptr && flip[j]) e = -e;
    if (pen != nullptr) e += pen[j];
    v = e;
    arg = j;
    if (e < -eps) neg = j;
  }
  block_reduce(v, arg, neg);
  if (threadIdx.x == 0) {
    blk_min[blockIdx.x] = v;
    blk_arg[blockIdx.x] = arg;
    blk_neg[blockIdx.x] = neg;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
pricing_final_kernel(const float* __restrict__ blk_min,
                     const int* __restrict__ blk_arg,
                     const int* __restrict__ blk_neg, int nblk,
                     float* __restrict__ out_min, int* __restrict__ out_arg,
                     int* __restrict__ out_neg) {
  float v = INFINITY;
  int arg = kIntMax;
  int neg = kIntMax;
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    if (min_before(blk_min[b], blk_arg[b], v, arg)) { v = blk_min[b]; arg = blk_arg[b]; }
    neg = min(neg, blk_neg[b]);
  }
  block_reduce(v, arg, neg);
  if (threadIdx.x == 0) {
    *out_min = v;
    *out_arg = arg == kIntMax ? 0 : arg;
    *out_neg = neg;
  }
}

template <typename T>
int launch(const float* y, const T* A, const float* c,
           const unsigned char* flip, const int* basis, int m_basis,
           int base_col, float* pen, int m, int n,
           size_t lda, float eps, int rows_per_chunk, int chunks, int vec,
           float* partial, float* blk_min, int* blk_arg, int* blk_neg, float* out_min,
           int* out_arg, int* out_neg, cudaStream_t stream) {
  cudaError_t err;
  if (flip != nullptr) {
    err = cudaMemsetAsync(pen, 0, (size_t)n * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    pricing_mark_basic_kernel<<<(m_basis + kMarkThreads - 1) / kMarkThreads,
                                kMarkThreads, 0, stream>>>(basis, m_basis, base_col, n, pen);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    pen = nullptr;
  }
  const dim3 grid1((n + kColsPerBlock - 1) / kColsPerBlock, chunks);
  if (vec)
    pricing_partial_kernel<T, true><<<grid1, kPartialThreads, 0, stream>>>(
        y, A, m, n, lda, rows_per_chunk, partial);
  else
    pricing_partial_kernel<T, false><<<grid1, kPartialThreads, 0, stream>>>(
        y, A, m, n, lda, rows_per_chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (n + kReduceThreads - 1) / kReduceThreads;
  pricing_columns_kernel<<<nblk, kReduceThreads, 0, stream>>>(
      partial, chunks, c, flip, pen, n, eps, blk_min, blk_arg, blk_neg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pricing_final_kernel<<<1, kFinalThreads, 0, stream>>>(
      blk_min, blk_arg, blk_neg, nblk, out_min, out_arg, out_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// a_dtype: 0 = fp32 A, 1 = bf16 A; lda: elements between rows of A (>= n).
// Signed mode: flip (n bytes), basis (m_basis int32, global column
// indices), base_col and pen (n fp32 scratch); flip null for plain pricing.
// vec (16-byte fp32 / 8-byte bf16 loads) needs n % 4 == 0, lda % 4 == 0 and
// an aligned A; the wrapper checks. Scratch: partial (chunks, n) fp32;
// blk_* (ceil(n / 256),). Returns the CUDA error code of the launches.
extern "C" int simplex_pricing_scan(int a_dtype, const void* y, const void* A,
                                    const void* c, const void* flip,
                                    const void* basis, int m_basis, int base_col,
                                    void* pen, int m, int n, long long lda,
                                    float eps, int rows_per_chunk, int chunks,
                                    int vec,
                                    void* partial, void* blk_min, void* blk_arg,
                                    void* blk_neg, void* out_min, void* out_arg,
                                    void* out_neg, void* stream) {
  const float* yf = static_cast<const float*>(y);
  const float* cf = static_cast<const float*>(c);
  const unsigned char* fl = static_cast<const unsigned char*>(flip);
  const int* bs = static_cast<const int*>(basis);
  float* pe = static_cast<float*>(pen);
  float* pf = static_cast<float*>(partial);
  float* bm = static_cast<float*>(blk_min);
  int* ba = static_cast<int*>(blk_arg);
  int* bn = static_cast<int*>(blk_neg);
  float* om = static_cast<float*>(out_min);
  int* oa = static_cast<int*>(out_arg);
  int* on = static_cast<int*>(out_neg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0)
    return launch(yf, static_cast<const float*>(A), cf, fl, bs, m_basis, base_col, pe, m, n, (size_t)lda,
                  eps, rows_per_chunk, chunks, vec, pf, bm, ba, bn, om, oa, on, s);
  return launch(yf, static_cast<const __nv_bfloat16*>(A), cf, fl, bs, m_basis, base_col, pe, m, n,
                (size_t)lda, eps, rows_per_chunk, chunks, vec, pf, bm, ba, bn, om, oa, on, s);
}
