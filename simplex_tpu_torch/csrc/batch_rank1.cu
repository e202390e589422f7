// Batched product-form update of the basis inverses, in place:
//   B_inv[i, r, c] += eta[i, r] * row[i, c]   for every instance i with take[i]
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, rank1_update / _rank1_kernel
// (the pl.pallas_call at line 374) as simplex_tpu/batch/vmapped.py runs it:
// vmap gives the call a batch grid axis, one update of every instance a
// batch step.
//
// Bound on the H100: device-memory bandwidth. It reads and writes every
// B_inv[i] once: 2 * B * m^2 * sizeof(T) bytes (128 MiB at 4096 x 64 x 64 in
// fp32, 256 MiB in fp64; 8 GiB at the warm re-solve's 256 x 2048 x 2048 in
// fp32, 16 GiB in fp64), 2 flops an element.
//
// Design: a 2-D grid, (tiles of 4096 elements of one inverse, instances).
// A block of 256 threads reads its instance's take flag on the device
// first and returns at once when it is 0, so the host never learns which
// instances pivoted, and an instance that did not is not touched (bit for
// bit, -0.0 included). Otherwise each thread updates 4 runs of 4
// consecutive elements, all loads before any store: 16 bytes a run in
// fp32 (one float4), 32 in fp64 (two double2), when m % 4 == 0 and the
// pointers are 16-byte aligned; single elements otherwise. The element
// type T is float or double (a dtype code picks the instantiation). Each
// element is one multiply and one add, each rounded (no FMA), as the plain
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
batch_rank1_kernel(T* __restrict__ B, const T* __restrict__ eta,
                   const T* __restrict__ row, const unsigned char* __restrict__ take,
                   int m) {
  const int inst = blockIdx.y;
  if (!take[inst]) return;
  const size_t mm = (size_t)m * m;
  T* Bi = B + (size_t)inst * mm;
  const T* ei = eta + (size_t)inst * m;
  const T* ri = row + (size_t)inst * m;
  const size_t base = (size_t)blockIdx.x * kTile;
  if (kVec) {
    T v[kRuns][4];
    size_t at[kRuns];
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      at[k] = base + ((size_t)k * kThreads + threadIdx.x) * 4;
      if (at[k] < mm) load4(Bi + at[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      if (at[k] >= mm) continue;
      // m % 4 == 0: the 4 elements share a row
      const int r = (int)(at[k] / m), c = (int)(at[k] % m);
      const T e = ei[r];
      T rw[4];
      load4(ri + c, rw);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[k][u] = upd(v[k][u], e, rw[u]);
      store4(Bi + at[k], v[k]);
    }
  } else {
    T v[kRuns * 4];
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

template <typename T>
int run(void* B, const void* eta, const void* row, const void* take, int batch, int m,
        int vec, cudaStream_t s) {
  const size_t mm = (size_t)m * m;
  const dim3 grid((unsigned)((mm + kTile - 1) / kTile), batch);
  T* Bt = static_cast<T*>(B);
  const T* et = static_cast<const T*>(eta);
  const T* rt = static_cast<const T*>(row);
  const unsigned char* tk = static_cast<const unsigned char*>(take);
  if (vec)
    batch_rank1_kernel<T, true><<<grid, kThreads, 0, s>>>(Bt, et, rt, tk, m);
  else
    batch_rank1_kernel<T, false><<<grid, kThreads, 0, s>>>(Bt, et, rt, tk, m);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, the type T of B, eta and row. B (batch,
// m, m) T row-major, updated in place; eta, row (batch, m) T; take (batch,)
// bool bytes. batch <= 65535.
extern "C" int simplex_batch_rank1(int dtype, void* B, const void* eta, const void* row,
                                   const void* take, int batch, int m, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(B, eta, row, take, batch, m, vec, s);
  if (dtype == 1) return run<double>(B, eta, row, take, batch, m, vec, s);
  return (int)cudaErrorInvalidValue;
}
