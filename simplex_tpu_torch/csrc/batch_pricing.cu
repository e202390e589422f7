// Batched pricing: for every instance i of a batch, the masked reduced
// costs e = y[i] . A[i] - c[i] (the basic columns + 1e30; in the signed
// mode, -e at the at-upper columns first) and the choice of its entering
// column: the lowest-index argmin (Dantzig), or under Bland's rule the
// first column with e < -eps (0 when none), with min e beside it. e never
// reaches memory.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, pricing_scan /
// _pricing_kernel (the pl.pallas_call at line 140) as
// simplex_tpu/batch/vmapped.py runs it: vmap gives that call a batch grid
// axis, one pricing pass of each instance's own A a batch step.
//
// A and c are per instance, or one A (m, n) / one c (n,) that every
// instance shares (a_shared / c_shared: the instance stride is 0), as the
// warm re-solve's primal clean-up has them; y, basis, at_upper and the
// Bland flags are always per instance.
//
// Bound on the H100: device-memory bandwidth. It reads every A[i] once:
// B * m * n * 4 bytes (160 MiB at 4096 x 64 x 160; the bf16 shadow half),
// and does 2 flops an element. A shared A is read from memory once and
// B times from L2: 2 B m n flops bound it (4.3 GFLOP at 256 x 2048 x 4096).
//
// Design: a 2-D grid, (column chunks, instances). A block of 256 threads
// owns 256 columns of one instance, one column a thread: it walks the m
// rows, neighbouring threads on neighbouring columns (coalesced), and sums
// y[r] * A[r, j] with fmaf in row order. At 64 x 160 one block holds an
// instance whole, so a batch step is 4096 blocks of one pass each. The
// basic columns of the chunk are marked in shared memory from the
// instance's basis row first. The block reduces (min e, lowest argmin, NaN
// first as torch.argmin puts it; lowest index with e < -eps) by warp
// shuffles and shared memory. One chunk covering n: the block writes the
// instance's choice; wider instances write one record a chunk, and a
// second launch reduces each instance's records (one block an instance) in
// chunk order, so the result does not depend on the order blocks run in.
// The plain PyTorch version sums through a batched matrix product, in
// another order: e agrees to rounding, the picks where no two columns tie.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPenalty = 1e30f;

struct Rec {
  float v;  // the minimum
  int i;    // its lowest index
  int neg;  // the lowest index with e < -eps, kIntMax when none
};

// a before b: NaN first (torch.min / argmin), then smaller, then lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ Rec merge(Rec a, const Rec& b) {
  if (before(b.v, b.i, a.v, a.i)) { a.v = b.v; a.i = b.i; }
  a.neg = min(a.neg, b.neg);
  return a;
}

__device__ __forceinline__ Rec warp_merge(Rec r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Rec o;
    o.v = __shfl_down_sync(kFull, r.v, off);
    o.i = __shfl_down_sync(kFull, r.i, off);
    o.neg = __shfl_down_sync(kFull, r.neg, off);
    r = merge(r, o);
  }
  return r;
}

// thread 0 gets the block's record
__device__ Rec block_merge(Rec r, Rec* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r = warp_merge(r);
  if (lane == 0) red[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = lane < (int)(blockDim.x >> 5) ? red[lane] : Rec{INFINITY, kIntMax, kIntMax};
    r = warp_merge(r);
  }
  return r;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void choose(const Rec& r, bool bland, int* p_out,
                                       float* min_out, int i) {
  p_out[i] = bland ? (r.neg == kIntMax ? 0 : r.neg) : r.i;
  min_out[i] = r.v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ y, const T* __restrict__ A,
            const float* __restrict__ c, const unsigned char* __restrict__ at_upper,
            const int* __restrict__ basis, const unsigned char* __restrict__ use_bland,
            int m, int n, size_t a_stride, size_t c_stride, float eps, int chunks,
            Rec* __restrict__ recs,
            int* __restrict__ p_out, float* __restrict__ min_out) {
  __shared__ unsigned char basic[kThreads];
  __shared__ Rec red[32];
  const int inst = blockIdx.y;
  const int lo = blockIdx.x * kThreads;
  const int j = lo + (int)threadIdx.x;
  basic[threadIdx.x] = 0;
  __syncthreads();
  const int* bi = basis + (size_t)inst * m;
  for (int r = threadIdx.x; r < m; r += kThreads) {
    const int b = bi[r] - lo;
    if (b >= 0 && b < kThreads) basic[b] = 1;
  }
  __syncthreads();

  Rec rec{INFINITY, kIntMax, kIntMax};
  if (j < n) {
    const float* yi = y + (size_t)inst * m;
    const T* col = A + (size_t)inst * a_stride + j;
    float acc = 0.f;
    int r = 0;
    for (; r + 4 <= m; r += 4) {
      const float a0 = load(col + (size_t)r * n), a1 = load(col + (size_t)(r + 1) * n);
      const float a2 = load(col + (size_t)(r + 2) * n), a3 = load(col + (size_t)(r + 3) * n);
      acc = fmaf(__ldg(yi + r), a0, acc);
      acc = fmaf(__ldg(yi + r + 1), a1, acc);
      acc = fmaf(__ldg(yi + r + 2), a2, acc);
      acc = fmaf(__ldg(yi + r + 3), a3, acc);
    }
    for (; r < m; ++r) acc = fmaf(__ldg(yi + r), load(col + (size_t)r * n), acc);
    float e = __fsub_rn(acc, c[(size_t)inst * c_stride + j]);
    if (at_upper != nullptr && at_upper[(size_t)inst * n + j]) e = -e;
    if (basic[threadIdx.x]) e = __fadd_rn(e, kPenalty);
    rec = Rec{e, j, e < -eps ? j : kIntMax};
  }
  rec = block_merge(rec, red);
  if (threadIdx.x == 0) {
    if (chunks == 1)
      choose(rec, use_bland[inst] != 0, p_out, min_out, inst);
    else
      recs[(size_t)inst * chunks + blockIdx.x] = rec;
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const Rec* __restrict__ recs, const unsigned char* __restrict__ use_bland,
              int chunks, int* __restrict__ p_out, float* __restrict__ min_out) {
  __shared__ Rec red[32];
  const int inst = blockIdx.x;
  Rec rec{INFINITY, kIntMax, kIntMax};
  for (int k = threadIdx.x; k < chunks; k += kThreads)
    rec = merge(rec, recs[(size_t)inst * chunks + k]);
  rec = block_merge(rec, red);
  if (threadIdx.x == 0) choose(rec, use_bland[inst] != 0, p_out, min_out, inst);
}

}  // namespace

// a_dtype 0: A fp32, 1: bf16. y (B, m), c (B, n) fp32; A (B, m, n) row-major;
// a_shared: A is one (m, n) for every instance; c_shared: c is one (n,);
// at_upper (B, n) bool bytes or null (the unsigned mode); basis (B, m)
// int32; use_bland (B,) bool bytes. Scratch: recs, `chunks` 12-byte records
// an instance (unused when one chunk covers n). Outputs: p (B,) int32,
// min_e (B,) fp32.
extern "C" int simplex_batch_pricing(int a_dtype, const void* y, const void* A,
                                     const void* c, const void* at_upper,
                                     const void* basis, const void* use_bland,
                                     int batch, int m, int n, int a_shared,
                                     int c_shared, float eps,
                                     void* recs, void* p, void* min_e,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (n + kThreads - 1) / kThreads;
  const dim3 grid(chunks, batch);
  const size_t a_step = a_shared ? 0 : (size_t)m * n, c_step = c_shared ? 0 : (size_t)n;
  const float* yf = static_cast<const float*>(y);
  const float* cf = static_cast<const float*>(c);
  const unsigned char* up = static_cast<const unsigned char*>(at_upper);
  const int* bas = static_cast<const int*>(basis);
  const unsigned char* bl = static_cast<const unsigned char*>(use_bland);
  Rec* rc = static_cast<Rec*>(recs);
  int* po = static_cast<int*>(p);
  float* mo = static_cast<float*>(min_e);
  if (a_dtype == 0)
    scan_kernel<float><<<grid, kThreads, 0, s>>>(
        yf, static_cast<const float*>(A), cf, up, bas, bl, m, n, a_step, c_step, eps, chunks, rc, po, mo);
  else
    scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        yf, static_cast<const __nv_bfloat16*>(A), cf, up, bas, bl, m, n, a_step, c_step, eps, chunks, rc, po, mo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  reduce_kernel<<<batch, kThreads, 0, s>>>(rc, bl, chunks, po, mo);
  return (int)cudaGetLastError();
}

// the size of one chunk record, for the wrapper's scratch
extern "C" int simplex_batch_pricing_record_bytes() { return (int)sizeof(Rec); }
