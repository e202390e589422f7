// Batched product-form update of the basis inverses, in place:
//   B_inv[i, r, c] += eta[i, r] * row[i, c]   for every instance i with take[i]
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, rank1_update / _rank1_kernel
// (the pl.pallas_call at line 374) as simplex_tpu/batch/vmapped.py runs it:
// vmap gives the call a batch grid axis, one update of every instance a
// batch step.
//
// Bound on the H100: device-memory bandwidth. It reads and writes every
// B_inv[i] once: 2 * B * m^2 * 4 bytes (128 MiB at 4096 x 64 x 64; 8 GiB at
// the warm re-solve's 256 x 2048 x 2048), 2 flops an element.
//
// Design: a 2-D grid, (tiles of 4096 elements of one inverse, instances).
// A block of 256 threads reads its instance's take flag on the device
// first and returns at once when it is 0, so the host never learns which
// instances pivoted, and an instance that did not is not touched (bit for
// bit, -0.0 included). Otherwise each thread updates 4 runs of 4
// consecutive elements (16 bytes a thread, float4 when m % 4 == 0 and the
// pointers are 16-byte aligned), all loads before any store. Each element
// is one multiply and one add, each rounded (no FMA), as the plain
// version computes it. `row` must not alias B_inv.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 4;
constexpr int kTile = kThreads * 4 * kRuns;  // elements a block

__device__ __forceinline__ float upd(float b, float e, float r) {
  return __fadd_rn(b, __fmul_rn(e, r));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
batch_rank1_kernel(float* __restrict__ B, const float* __restrict__ eta,
                   const float* __restrict__ row, const unsigned char* __restrict__ take,
                   int m) {
  const int inst = blockIdx.y;
  if (!take[inst]) return;
  const size_t mm = (size_t)m * m;
  float* Bi = B + (size_t)inst * mm;
  const float* ei = eta + (size_t)inst * m;
  const float* ri = row + (size_t)inst * m;
  const size_t base = (size_t)blockIdx.x * kTile;
  if (kVec) {
    float4 v[kRuns];
    size_t at[kRuns];
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      at[k] = base + ((size_t)k * kThreads + threadIdx.x) * 4;
      if (at[k] < mm) v[k] = *reinterpret_cast<const float4*>(Bi + at[k]);
    }
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      if (at[k] >= mm) continue;
      // m % 4 == 0: the 4 elements share a row
      const int r = (int)(at[k] / m), c = (int)(at[k] % m);
      const float e = ei[r];
      const float4 rw = *reinterpret_cast<const float4*>(ri + c);
      float4 o = v[k];
      o.x = upd(o.x, e, rw.x);
      o.y = upd(o.y, e, rw.y);
      o.z = upd(o.z, e, rw.z);
      o.w = upd(o.w, e, rw.w);
      *reinterpret_cast<float4*>(Bi + at[k]) = o;
    }
  } else {
    float v[kRuns * 4];
#pragma unroll
    for (int k = 0; k < kRuns * 4; ++k) {
      const size_t at = base + (size_t)k * kThreads + threadIdx.x;
      if (at < mm) v[k] = Bi[at];
    }
#pragma unroll
    for (int k = 0; k < kRuns * 4; ++k) {
      const size_t at = base + (size_t)k * kThreads + threadIdx.x;
      if (at < mm) Bi[at] = upd(v[k], ei[at / m], ri[at % m]);
    }
  }
}

}  // namespace

// B (batch, m, m) fp32 row-major, updated in place; eta, row (batch, m)
// fp32; take (batch,) bool bytes. batch <= 65535.
extern "C" int simplex_batch_rank1(void* B, const void* eta, const void* row,
                                   const void* take, int batch, int m, int vec,
                                   void* stream) {
  const size_t mm = (size_t)m * m;
  const dim3 grid((unsigned)((mm + kTile - 1) / kTile), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* Bf = static_cast<float*>(B);
  const float* ef = static_cast<const float*>(eta);
  const float* rf = static_cast<const float*>(row);
  const unsigned char* tk = static_cast<const unsigned char*>(take);
  if (vec)
    batch_rank1_kernel<true><<<grid, kThreads, 0, s>>>(Bf, ef, rf, tk, m);
  else
    batch_rank1_kernel<false><<<grid, kThreads, 0, s>>>(Bf, ef, rf, tk, m);
  return (int)cudaGetLastError();
}
