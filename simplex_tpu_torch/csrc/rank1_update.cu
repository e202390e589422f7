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

extern "C" const char* simplex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
