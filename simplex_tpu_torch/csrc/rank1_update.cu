// Product-form update of the basis inverse, in place:
//   B_inv[i, j] += eta[i] * row[j]
// over a block of `rows` rows of an m-wide inverse: the whole (m, m)
// inverse, or one rank's (m / R, m) row block in the 2-D sharded solve.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, rank1_update / _rank1_kernel
// (the pl.pallas_call at line 374, which aliases B_inv input to output).
//
// Bound on the H100: device-memory bandwidth. It reads and writes B_inv
// once, 2 * rows * m * sizeof(T) bytes (512 MiB at rows = m = 8192 in fp32,
// 1 GiB in fp64), and does 2 flops an element (fp64 at 2 flops per 16 bytes
// is far below the card's fp64 rate too).
//
// Design: a 2-D grid of blocks, each 256 threads wide and 1024 columns by 8
// rows. A thread keeps its 4 entries of `row` in registers and walks the 8
// rows, issuing all 8 loads before any store so that 8 accesses per thread
// are in flight. The element type T is float or double (a dtype code picks
// the instantiation). Accesses are 16 bytes at a time (one float4, or two
// double2 for a thread's 4 doubles) when m % 4 == 0 and the pointers are
// 16-byte aligned, single elements otherwise; tails are masked. The update is in place, so `row` (row q of B_inv in the solver)
// must be a copy: the wrapper refuses a `row` or `eta` that overlaps
// B_inv, since blocks would otherwise read row q while others rewrite it.
// Each element is one multiply and one add, each rounded (no FMA), as the
// plain PyTorch expression computes it: the result equals it bit for bit.
//
// With the next pivot's ftran fused in (simplex_rank1_update_ftran, rows = m
// only; replaces no Pallas kernel: the JAX step runs the ftran as its own
// product), the same pass also computes alpha = B' a, B' the updated inverse
// and a the next entering column, from the updated values while they are in
// registers. The default step then reads B_inv once a pivot instead of twice
// (the update's read and write, and no separate GEMV read): same bound,
// 2 m^2 sizeof(T) bytes, plus 2 flops an element. Design: a CTA of 512
// threads owns one whole row; each thread loads 4 groups of 4 neighbouring
// elements (16-byte accesses, 2048 columns apart) before it stores any, so
// that 4 accesses per thread are in flight (at m = 8192 a row is one such
// round). The update of each element is the standalone kernel's, bit for
// bit. Each thread sums its elements' products in column order (FMA), then
// the CTA reduces the row in a fixed order: a butterfly in each warp, then
// the warps in order. No atomics and no order that depends on scheduling, so
// two calls, and a CUDA graph's replay, give the same alpha. Measured alone
// at m = 8192 on the H100, this layout took the standalone update's time
// (float32) or less (float64), where bands of 2 to 16 rows of the tile
// layout above took 1-12% more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4 * kThreads;
constexpr int kRows = 8;

__device__ __forceinline__ float upd(float b, float e, float r) {
  return __fadd_rn(b, __fmul_rn(e, r));
}
__device__ __forceinline__ double upd(double b, double e, double r) {
  return __dadd_rn(b, __dmul_rn(e, r));
}

// four neighbouring elements at p, 16-byte aligned (the launcher checks)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(T* __restrict__ B, const T* __restrict__ eta,
             const T* __restrict__ row, int rows, int m) {
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  const int nrows = min(kRows, rows - i0);
  if (kVec) {
    const int j = j0 + 4 * threadIdx.x;  // m % 4 == 0, so j + 3 < m too
    if (j >= m) return;
    T r[4];
    load4(row + j, r);
    T b[kRows][4];
    T e[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nrows) {
        load4(B + (size_t)(i0 + k) * m + j, b[k]);
        e[k] = eta[i0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nrows) {
#pragma unroll
        for (int u = 0; u < 4; ++u) b[k][u] = upd(b[k][u], e[k], r[u]);
        store4(B + (size_t)(i0 + k) * m + j, b[k]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j >= m) continue;
      const T r = row[j];
      T b[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < nrows) b[k] = B[(size_t)(i0 + k) * m + j];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < nrows) B[(size_t)(i0 + k) * m + j] = upd(b[k], eta[i0 + k], r);
    }
  }
}

__device__ __forceinline__ float mac(float acc, float b, float x) {
  return __fmaf_rn(b, x, acc);
}
__device__ __forceinline__ double mac(double acc, double b, double x) {
  return __fma_rn(b, x, acc);
}

constexpr int kFtranThreads = 512;
constexpr int kFtranGroups = 4;  // groups of 4 elements a thread loads before it stores

// The rank-1 update of a whole (m, m) inverse with the product alpha = B' a
// fused in: one CTA a row (the file's header).
template <typename T, bool kVec, bool kFtran>
__global__ void __launch_bounds__(kFtranThreads)
rank1_kernel(T* __restrict__ B, const T* __restrict__ eta, const T* __restrict__ row,
             const T* __restrict__ a, T* __restrict__ alpha, int m) {
  constexpr int kStride = 4 * kFtranThreads;  // columns between a thread's groups
  const int i = blockIdx.x;
  const T e = eta[i];
  T* Bi = B + (size_t)i * m;
  T acc = T(0);
  if (kVec) {
    for (int j0 = 4 * threadIdx.x; j0 < m; j0 += kFtranGroups * kStride) {
      T b[kFtranGroups][4], r[kFtranGroups][4], x[kFtranGroups][4];
#pragma unroll
      for (int g = 0; g < kFtranGroups; ++g) {
        const int j = j0 + g * kStride;  // m % 4 == 0: j + 3 < m too
        if (j < m) {
          load4(Bi + j, b[g]);
          load4(row + j, r[g]);
          load4(a + j, x[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kFtranGroups; ++g) {
        const int j = j0 + g * kStride;
        if (j < m) {
#pragma unroll
          for (int u = 0; u < 4; ++u) b[g][u] = upd(b[g][u], e, r[g][u]);
          store4(Bi + j, b[g]);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc = mac(acc, b[g][u], x[g][u]);
        }
      }
    }
  } else {
    for (int j0 = threadIdx.x; j0 < m; j0 += kFtranGroups * kFtranThreads) {
      T b[kFtranGroups];
#pragma unroll
      for (int g = 0; g < kFtranGroups; ++g) {
        const int j = j0 + g * kFtranThreads;
        if (j < m) b[g] = Bi[j];
      }
#pragma unroll
      for (int g = 0; g < kFtranGroups; ++g) {
        const int j = j0 + g * kFtranThreads;
        if (j < m) {
          b[g] = upd(b[g], e, row[j]);
          Bi[j] = b[g];
          acc = mac(acc, b[g], a[j]);
        }
      }
    }
  }
  // the row's sum in a fixed order: a butterfly in each warp, then the warps
  __shared__ T part[kFtranThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T sum = part[0];
#pragma unroll
    for (int w = 1; w < kFtranThreads / 32; ++w) sum += part[w];
    alpha[i] = sum;
  }
}

template <typename T>
int run_ftran(void* B, const void* eta, const void* row, const void* a, void* alpha, int m,
              int vec, cudaStream_t s) {
  const dim3 grid(m);
  T* Bt = static_cast<T*>(B);
  const T* et = static_cast<const T*>(eta);
  const T* rt = static_cast<const T*>(row);
  const T* at = static_cast<const T*>(a);
  T* out = static_cast<T*>(alpha);
  if (vec)
    rank1_kernel<T, true, true><<<grid, kFtranThreads, 0, s>>>(Bt, et, rt, at, out, m);
  else
    rank1_kernel<T, false, true><<<grid, kFtranThreads, 0, s>>>(Bt, et, rt, at, out, m);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* B, const void* eta, const void* row, int rows, int m, int vec,
        cudaStream_t s) {
  const dim3 grid((m + kCols - 1) / kCols, (rows + kRows - 1) / kRows);
  T* Bt = static_cast<T*>(B);
  const T* et = static_cast<const T*>(eta);
  const T* rt = static_cast<const T*>(row);
  if (vec)
    rank1_kernel<T, true><<<grid, kThreads, 0, s>>>(Bt, et, rt, rows, m);
  else
    rank1_kernel<T, false><<<grid, kThreads, 0, s>>>(Bt, et, rt, rows, m);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, the type T of every operand. B (rows, m)
// T row-major, updated in place; eta (rows,), row (m,) T.
extern "C" int simplex_rank1_update(int dtype, void* B, const void* eta, const void* row,
                                    int rows, int m, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(B, eta, row, rows, m, vec, s);
  if (dtype == 1) return run<double>(B, eta, row, rows, m, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The same update of a whole (m, m) inverse, then alpha (m,) T = B' a, a (m,)
// T, from the updated values: one launch.
extern "C" int simplex_rank1_update_ftran(int dtype, void* B, const void* eta, const void* row,
                                          const void* a, void* alpha, int m, int vec,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_ftran<float>(B, eta, row, a, alpha, m, vec, s);
  if (dtype == 1) return run_ftran<double>(B, eta, row, a, alpha, m, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* simplex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
