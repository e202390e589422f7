// Classic masked ratio test: theta_i = max(x_b_i, 0) / alpha_i over the rows
// with alpha_i > pivot_tol; q is the lowest-index argmin of theta, or under
// Bland's rule the row with the smallest basis index among rows at the exact
// minimum; unbounded when no row is eligible.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, ratio_argmin / _ratio_kernel
// (the pl.pallas_call at line 212).
//
// Bound on the H100: latency. At m = 8192 it reads 96 KB and writes 9 bytes,
// so its time is the launch plus the block's reduction steps.
//
// Design: one block of 1024 threads, two loops over the rows.
//   loop 1  min theta and any(alpha > tol), reduced over the block;
//   loop 2  with theta recomputed bit for bit: the lowest row at the min
//           (classic) and the smallest (basis, row) pair at the min (Bland);
//   thread 0 picks q (INT_MAX maps to 0), theta_q and the unbounded flag.
// The Pallas kernel needs m % 128 == 0 and falls back to XLA otherwise; this
// one takes any m. Each theta is one IEEE division (__fdiv_rn) and every
// reduction breaks ties to the lowest index, so the result equals the plain
// PyTorch version (kernels/ops.py ratio_argmin) bit for bit, NaN included:
// a NaN theta wins the min, and its lowest row is q, as torch.argmin gives.
// use_bland is read on the device and the results stay there, so a caller
// needs no host sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  float f;  // value
  int i;    // primary integer key
  int j;    // secondary integer key
};

// NaN-propagating min of values (torch.min semantics)
struct MinValue {
  __device__ bool operator()(const Cand& a, const Cand& b) const {
    return (isnan(a.f) && !isnan(b.f)) || a.f < b.f;
  }
};
// smallest (i, j) pair
struct MinPair {
  __device__ bool operator()(const Cand& a, const Cand& b) const {
    return a.i < b.i || (a.i == b.i && a.j < b.j);
  }
};

__device__ __forceinline__ Cand shfl_down(const Cand& v, int off) {
  Cand o;
  o.f = __shfl_down_sync(kFull, v.f, off);
  o.i = __shfl_down_sync(kFull, v.i, off);
  o.j = __shfl_down_sync(kFull, v.j, off);
  return o;
}

// Reduces v over the block; every thread gets the result.
template <typename Before>
__device__ Cand block_reduce(Cand v, const Cand identity, Before before,
                             Cand* smem /* 33 entries */) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_down(v, off);
    if (before(o, v)) v = o;
  }
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : identity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Cand o = shfl_down(v, off);
      if (before(o, v)) v = o;
    }
    if (lane == 0) smem[32] = v;
  }
  __syncthreads();
  const Cand r = smem[32];
  __syncthreads();  // smem may be reused by the next reduction
  return r;
}

// max(x, 0) that keeps a NaN (torch.clamp_min semantics)
__device__ __forceinline__ float pos(float x) { return x < 0.f ? 0.f : x; }

__global__ void __launch_bounds__(kThreads)
ratio_argmin_kernel(const float* __restrict__ x_b,
                    const float* __restrict__ alpha,
                    const int* __restrict__ basis,
                    const int* __restrict__ use_bland, int m, float pivot_tol,
                    int* __restrict__ q_out, float* __restrict__ theta_out,
                    bool* __restrict__ unb_out) {
  __shared__ Cand smem[33];

  // loop 1: min theta, any eligible row
  Cand tmin{INFINITY, 0, 0};
  int any = 0;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    if (a > pivot_tol) {
      const Cand t{__fdiv_rn(pos(x_b[r]), a), 0, 0};
      if (MinValue()(t, tmin)) tmin = t;
      any = 1;
    }
  }
  tmin = block_reduce(tmin, Cand{INFINITY, 0, 0}, MinValue(), smem);
  const bool unbounded = !__syncthreads_or(any);

  // loop 2: lowest row at the min (classic), smallest (basis, row) at the
  // exact min (Bland)
  Cand best_c{0.f, kIntMax, 0};        // (-, row)
  Cand best_b{0.f, kIntMax, kIntMax};  // (-, basis, row)
  const bool tmin_nan = isnan(tmin.f);
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    const float theta = a > pivot_tol ? __fdiv_rn(pos(x_b[r]), a) : INFINITY;
    if ((theta == tmin.f || (tmin_nan && isnan(theta))) && r < best_c.i) best_c.i = r;
    if (theta == tmin.f) {
      const Cand b{0.f, basis[r], r};
      if (MinPair()(b, best_b)) best_b = b;
    }
  }
  best_c = block_reduce(best_c, Cand{0.f, kIntMax, 0}, MinPair(), smem);
  best_b = block_reduce(best_b, Cand{0.f, kIntMax, kIntMax}, MinPair(), smem);

  if (threadIdx.x == 0) {
    int q = *use_bland != 0 ? best_b.j : best_c.i;
    if (q == kIntMax) q = 0;
    *q_out = q;
    *theta_out = unbounded ? INFINITY : tmin.f;
    *unb_out = unbounded;
  }
}

}  // namespace

// use_bland: one int32 on the device (0 or 1). Outputs: q int32, theta_q
// fp32, unbounded bool (one byte).
extern "C" int simplex_ratio_argmin(const void* x_b, const void* alpha,
                                    const void* basis, const void* use_bland,
                                    int m, float pivot_tol, void* q,
                                    void* theta_q, void* unbounded,
                                    void* stream) {
  ratio_argmin_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_b), static_cast<const float*>(alpha),
      static_cast<const int*>(basis), static_cast<const int*>(use_bland), m,
      pivot_tol, static_cast<int*>(q), static_cast<float*>(theta_q),
      static_cast<bool*>(unbounded));
  return (int)cudaGetLastError();
}
