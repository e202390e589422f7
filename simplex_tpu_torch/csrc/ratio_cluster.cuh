// What the ratio-test kernels share (ratio_eta.cu, ratio_argmin.cu): the
// records of the two reduction rounds, the reduction over a thread block
// cluster, the cluster launch, and the arithmetic on the element type T
// (float or double; each step one IEEE round-to-nearest op, so nvcc cannot
// contract a product and a sum into an FMA that the plain version lacks).
//
// A kernel here runs as ONE cluster of 1..8 blocks of 1024 threads, sized by
// m (one row a thread up to 8192 rows, a stride loop beyond). A record is
// reduced by warp shuffles, then through shared memory across the block's
// warps, then through distributed shared memory across the cluster: every
// block writes its record to a slot of its own shared memory,
// cluster.sync(), and lane b of warp 0 of every block reads block b's slot
// through map_shared_rank. Every merge is a min / max whose ties break to the
// lowest index (NaN first where torch.min puts it first), so the result does
// not depend on how the rows are split over blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ratio_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// one rounding an op, in float or in double
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// NaN-propagating min (torch.min semantics)
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return ((isnan(b) && !isnan(a)) || b < a) ? b : a;
}

// max(x, 0) that keeps a NaN (torch.clamp_min semantics)
template <typename T>
__device__ __forceinline__ T pos(T x) { return x < T(0) ? T(0) : x; }

// round 1: min theta, min relaxed theta (Harris pass 1; +inf when the test is
// classic), any eligible row. Two T and an int: 12 bytes in float, 24 in
// double (padded), well inside a shared-memory exchange slot either way.
template <typename T>
struct Pass1 {
  T tmin, trel;
  int any;
  __device__ static Pass1 identity() { return Pass1{T(INFINITY), T(INFINITY), 0}; }
  __device__ Pass1 shfl(int off) const {
    Pass1 o;
    o.tmin = __shfl_down_sync(kFull, tmin, off);
    o.trel = __shfl_down_sync(kFull, trel, off);
    o.any = __shfl_down_sync(kFull, any, off);
    return o;
  }
  __device__ void merge(const Pass1& o) {
    tmin = nan_min(tmin, o.tmin);
    trel = nan_min(trel, o.trel);
    any |= o.any;
  }
};

// round 2: Harris (largest alpha, then lowest row), classic (lowest row of
// the minimum), Bland (smallest basis index, then lowest row)
template <typename T>
struct Pass2 {
  T h_alpha;
  int h_row, c_row, b_basis, b_row;
  __device__ static Pass2 identity() {
    return Pass2{T(-INFINITY), kIntMax, kIntMax, kIntMax, kIntMax};
  }
  __device__ Pass2 shfl(int off) const {
    Pass2 o;
    o.h_alpha = __shfl_down_sync(kFull, h_alpha, off);
    o.h_row = __shfl_down_sync(kFull, h_row, off);
    o.c_row = __shfl_down_sync(kFull, c_row, off);
    o.b_basis = __shfl_down_sync(kFull, b_basis, off);
    o.b_row = __shfl_down_sync(kFull, b_row, off);
    return o;
  }
  __device__ void harris(T a, int r) {
    if (a > h_alpha || (a == h_alpha && r < h_row)) { h_alpha = a; h_row = r; }
  }
  __device__ void bland(int b, int r) {
    if (b < b_basis || (b == b_basis && r < b_row)) { b_basis = b; b_row = r; }
  }
  __device__ void merge(const Pass2& o) {
    harris(o.h_alpha, o.h_row);
    c_row = min(c_row, o.c_row);
    bland(o.b_basis, o.b_row);
  }
};

static_assert(sizeof(Pass1<double>) <= 32 && sizeof(Pass2<double>) <= 32,
              "a record must stay small: 33 of each round sit in shared memory");

template <typename T>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v.merge(v.shfl(off));
  return v;
}

// Reduces v over the cluster; every thread of every block gets the result.
// red: 33 entries of this block's shared memory; slot: this block's exchange
// record, read by the other blocks (a different slot for each round, so a
// block that runs ahead cannot overwrite a record still being read). A
// kernel that calls this ends with cluster.sync(), so that no block exits
// while another still reads its slot.
template <typename T>
__device__ T cluster_reduce(T v, T* red, T* slot, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const unsigned blocks = cluster.num_blocks();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : T::identity();
    v = warp_reduce(v);
    if (lane == 0) { red[32] = v; *slot = v; }
  }
  if (blocks > 1) {
    cluster.sync();  // every block's slot is written
    if (warp == 0) {
      v = T::identity();
      if (lane < (int)blocks) v = *cluster.map_shared_rank(slot, lane);
      v = warp_reduce(v);
      if (lane == 0) red[32] = v;
    }
  }
  __syncthreads();
  return red[32];
}

// Launches `kernel` as one cluster of cluster_blocks blocks of kThreads.
template <typename Kernel, typename Arg>
int launch_cluster(Kernel kernel, const Arg& arg, int cluster_blocks,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace ratio_cluster
