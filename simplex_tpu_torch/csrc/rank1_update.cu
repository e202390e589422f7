// Product-form update of the basis inverse, in place:
//   B_inv[i, j] += eta[i] * row[j]
// over a block of `rows` rows of an m-wide inverse: the whole (m, m)
// inverse, or one rank's (m / R, m) row block in the 2-D sharded solve.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, rank1_update / _rank1_kernel
// (the pl.pallas_call at line 374, which aliases B_inv input to output).
//
// Bound on the H100: device-memory bandwidth. It reads and writes B_inv
// once, 2 * rows * m * 4 bytes (512 MiB at rows = m = 8192), and does 2
// flops an element.
//
// Design: a 2-D grid of blocks, each 256 threads wide and 1024 columns by 8
// rows. A thread keeps its 4 entries of `row` in registers and walks the 8
// rows, issuing all 8 loads before any store so that 8 accesses per thread
// are in flight. Accesses are 16 bytes a thread (float4) when m % 4 == 0
// and the pointers are 16-byte aligned, plain floats otherwise; tails are
// masked. The update is in place, so `row` (row q of B_inv in the solver)
// must be a copy: the wrapper refuses a `row` or `eta` that overlaps
// B_inv, since blocks would otherwise read row q while others rewrite it.
// Each element is one multiply and one add, each rounded (no FMA), as the
// plain PyTorch expression computes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4 * kThreads;
constexpr int kRows = 8;

__device__ __forceinline__ float upd(float b, float e, float r) {
  return __fadd_rn(b, __fmul_rn(e, r));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(float* __restrict__ B, const float* __restrict__ eta,
             const float* __restrict__ row, int rows, int m) {
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  const int nrows = min(kRows, rows - i0);
  if (kVec) {
    const int j = j0 + 4 * threadIdx.x;  // m % 4 == 0, so j + 3 < m too
    if (j >= m) return;
    const float4 r = *reinterpret_cast<const float4*>(row + j);
    float4 b[kRows];
    float e[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nrows) {
        b[k] = *reinterpret_cast<const float4*>(B + (size_t)(i0 + k) * m + j);
        e[k] = eta[i0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < nrows) {
        float4 v = b[k];
        v.x = upd(v.x, e[k], r.x);
        v.y = upd(v.y, e[k], r.y);
        v.z = upd(v.z, e[k], r.z);
        v.w = upd(v.w, e[k], r.w);
        *reinterpret_cast<float4*>(B + (size_t)(i0 + k) * m + j) = v;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + threadIdx.x + c * kThreads;
      if (j >= m) continue;
      const float r = row[j];
      float b[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < nrows) b[k] = B[(size_t)(i0 + k) * m + j];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < nrows) B[(size_t)(i0 + k) * m + j] = upd(b[k], eta[i0 + k], r);
    }
  }
}

}  // namespace

// B (rows, m) fp32 row-major, updated in place; eta (rows,), row (m,) fp32.
extern "C" int simplex_rank1_update(void* B, const void* eta, const void* row,
                                    int rows, int m, int vec, void* stream) {
  const dim3 grid((m + kCols - 1) / kCols, (rows + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* Bf = static_cast<float*>(B);
  const float* ef = static_cast<const float*>(eta);
  const float* rf = static_cast<const float*>(row);
  if (vec)
    rank1_kernel<true><<<grid, kThreads, 0, s>>>(Bf, ef, rf, rows, m);
  else
    rank1_kernel<false><<<grid, kThreads, 0, s>>>(Bf, ef, rf, rows, m);
  return (int)cudaGetLastError();
}

extern "C" const char* simplex_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
