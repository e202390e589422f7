// Fused ratio test + eta vector + x_b step, in one launch.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, ratio_eta / _ratio_eta_kernel
// (the pl.pallas_call at line 323).
//
// Bound on the H100: latency. At m = 8192 it reads about 100 KB and writes
// 64 KB, so its time is launch latency plus the block's reduction steps,
// not bandwidth.
//
// Design: one block of 1024 threads loops over the m rows three times.
//   loop 1  min theta, min theta_rel (Harris pass 1), any(alpha > tol);
//   loop 2  over rows with the same theta recomputed bit for bit:
//           Harris: largest alpha among rows with theta <= theta_max
//           (lowest index on ties); classic: lowest index of the min theta;
//           Bland: smallest basis index among rows with theta == min theta;
//   thread 0 picks q (INT_MAX maps to 0), theta_q and alpha_q;
//   loop 3  after __syncthreads, every thread writes eta and x_b_new.
// Every reduction breaks ties to the lowest index, so the result is the one
// the plain PyTorch version (kernels/ops.py ratio_eta) gives, bit for bit:
// each arithmetic step is one IEEE round-to-nearest op (the __f*_rn
// intrinsics keep nvcc from contracting them into FMAs). use_bland is read
// on the device and q / theta_q / unbounded stay on the device, so the
// pivot step needs no host sync here.

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

// NaN-propagating min of values (jnp.min / torch.min semantics)
struct MinValue {
  __device__ bool operator()(const Cand& a, const Cand& b) const {
    return (isnan(a.f) && !isnan(b.f)) || a.f < b.f;
  }
};
// largest value, then lowest index (i)
struct MaxValueLowIndex {
  __device__ bool operator()(const Cand& a, const Cand& b) const {
    return a.f > b.f || (a.f == b.f && a.i < b.i);
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
ratio_eta_kernel(const float* __restrict__ x_b, const float* __restrict__ alpha,
                 const int* __restrict__ basis, const int* __restrict__ use_bland,
                 int m, float pivot_tol, float feas_tol, int harris,
                 int* __restrict__ q_out, float* __restrict__ theta_out,
                 bool* __restrict__ unb_out, float* __restrict__ eta,
                 float* __restrict__ x_b_new) {
  __shared__ Cand smem[33];
  __shared__ int s_q;
  __shared__ float s_inv, s_th;

  // loop 1: min theta, min relaxed theta, any eligible row
  Cand tmin{INFINITY, 0, 0}, tmax{INFINITY, 0, 0};
  int any = 0;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    if (a > pivot_tol) {
      const float xp = pos(x_b[r]);
      const Cand t{__fdiv_rn(xp, a), 0, 0};
      const Cand rel{__fdiv_rn(__fadd_rn(xp, feas_tol), a), 0, 0};
      if (MinValue()(t, tmin)) tmin = t;
      if (MinValue()(rel, tmax)) tmax = rel;
      any = 1;
    }
  }
  const Cand inf_c{INFINITY, 0, 0};
  tmin = block_reduce(tmin, inf_c, MinValue(), smem);
  tmax = block_reduce(tmax, inf_c, MinValue(), smem);
  const bool unbounded = !__syncthreads_or(any);

  // loop 2: Harris / classic / Bland candidates
  Cand best_h{-INFINITY, kIntMax, 0};  // (alpha, row)
  Cand best_c{0.f, kIntMax, 0};        // (-, row)
  Cand best_b{0.f, kIntMax, kIntMax};  // (-, basis, row)
  const bool tmin_nan = isnan(tmin.f);
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    const bool mk = a > pivot_tol;
    const float theta = mk ? __fdiv_rn(pos(x_b[r]), a) : INFINITY;
    if (mk && theta <= tmax.f) {
      const Cand h{a, r, 0};
      if (MaxValueLowIndex()(h, best_h)) best_h = h;
    }
    if ((theta == tmin.f || (tmin_nan && isnan(theta))) && r < best_c.i) best_c.i = r;
    if (theta == tmin.f) {
      const Cand b{0.f, basis[r], r};
      if (MinPair()(b, best_b)) best_b = b;
    }
  }
  best_h = block_reduce(best_h, Cand{-INFINITY, kIntMax, 0}, MaxValueLowIndex(), smem);
  best_c = block_reduce(best_c, Cand{0.f, kIntMax, 0}, MinPair(), smem);
  best_b = block_reduce(best_b, Cand{0.f, kIntMax, kIntMax}, MinPair(), smem);

  if (threadIdx.x == 0) {
    const bool bland = *use_bland != 0;
    int q = bland ? best_b.j : (harris ? best_h.i : best_c.i);
    if (q == kIntMax) q = 0;
    const float a_q = alpha[q];
    const float theta_at_q = a_q > pivot_tol ? __fdiv_rn(pos(x_b[q]), a_q) : INFINITY;
    const float theta_q = unbounded ? INFINITY : (bland ? tmin.f : theta_at_q);
    const bool live = !unbounded && isfinite(theta_q);
    s_q = q;
    s_inv = __fdiv_rn(1.f, live ? a_q : 1.f);
    s_th = live ? theta_q : 0.f;
    *q_out = q;
    *theta_out = theta_q;
    *unb_out = unbounded;
  }
  __syncthreads();

  // loop 3: eta and the stepped x_b
  const int q = s_q;
  const float inv = s_inv;
  const float th = s_th;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    if (r == q) {
      eta[r] = __fsub_rn(inv, 1.f);
      x_b_new[r] = th;
    } else {
      eta[r] = __fmul_rn(-a, inv);
      x_b_new[r] = __fsub_rn(x_b[r], __fmul_rn(th, a));
    }
  }
}

}  // namespace

// use_bland: one int32 on the device (0 or 1). Outputs: q int32, theta_q
// fp32, unbounded bool (one byte), eta and x_b_new (m,) fp32.
extern "C" int simplex_ratio_eta(const void* x_b, const void* alpha,
                                 const void* basis, const void* use_bland,
                                 int m, float pivot_tol, float feas_tol,
                                 int harris, void* q, void* theta_q,
                                 void* unbounded, void* eta, void* x_b_new,
                                 void* stream) {
  ratio_eta_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_b), static_cast<const float*>(alpha),
      static_cast<const int*>(basis), static_cast<const int*>(use_bland), m,
      pivot_tol, feas_tol, harris, static_cast<int*>(q),
      static_cast<float*>(theta_q), static_cast<bool*>(unbounded),
      static_cast<float*>(eta), static_cast<float*>(x_b_new));
  return (int)cudaGetLastError();
}
