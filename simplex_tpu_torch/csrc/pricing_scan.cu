// Dantzig pricing in one call: one pass over A giving min_j e_j, its lowest
// index, the first j with e_j < -eps and the entering column chosen from
// them, where e = y.A - c with the basic columns masked. e never reaches
// device memory in full.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, pricing_scan / _pricing_kernel
// (the pl.pallas_call at line 140) with choose_entering around it, and the
// basic-column mask the step builds before it (mask_basic).
//
// Bound on the H100: device-memory bandwidth for a full pass (A read once:
// m * n * 4 bytes, 512 MiB at 8192 x 16384 fp32, 2 flops per element, far
// below the card's ops-per-byte ridge); launch latency for a column segment
// (32 MiB at 8192 x 2048 bf16 is 10 us of traffic, a launch costs a few).
// So the design keeps the full pass's inner loop and spends as few launches
// and host steps around it as it can: two launches a call (one where a
// single row chunk covers m: the second launch then sums its own columns),
// no memset, no scratch made per call, no torch op before or after.
//
// Design: the Pallas grid walks row tiles in order and carries a column
// accumulator; Hopper blocks run in no order, so that carry is replaced by
// a split over rows:
//   launch 1  grid (column tiles of 1024, row chunks). Each thread owns 4
//             neighbouring columns (one 16-byte load per row when aligned)
//             and sums y_i A_ij over its chunk's rows in row order, writing
//             one partial row of a (chunks, n) scratch. Splitting the rows
//             gives ~8 blocks per SM at n = 16384, where one column per
//             thread would fill only 64 blocks. Loads along A's rows are
//             coalesced.
//   launch 2  one thread adds each column's partials in chunk order (from
//             device memory, a block owning 256 columns; up to 8192
//             columns, where that would leave most SMs idle behind long
//             dependent load chains, from a (chunks, 32) tile that the
//             block's warps stage in shared memory with many loads in
//             flight), subtracts c_j, flips the sign of an at-upper
//             column (signed mode) and adds 1e30 at a basic column; the block
//             reduces (min, lowest argmin, first index below -eps). Which
//             columns are basic the block finds itself: it scans the basis
//             (m int32, L2-resident) for entries in its own columns and
//             flags them in shared memory, so no penalty row is zeroed and
//             marked beforehand and nothing can go stale between calls.
//             Then the block takes a ticket (atomicAdd after
//             __threadfence()); the block that draws the last one reduces
//             the per-block results, reads use_bland on the device, writes
//             min, argmin, first-below and the chosen column (Dantzig's
//             argmin, or Bland's first improving index, 0 when none; plus
//             p_offset, so a segment's pick comes out as a global column),
//             and resets the ticket for the next call.
// Every sum runs in a fixed order and every reduction breaks ties to the
// lowest index, so the result is deterministic; no float atomics. A NaN in
// e wins the min (with its lowest index), as jnp.argmin / torch.argmin do.
// The working type T of y, c, the partial sums and the results is float or
// double; A is T or the bf16 shadow (upcast per element, accumulated in T,
// as the plain version casts A to c's dtype). In double a full pass moves
// twice the bytes (1 GiB at 8192 x 16384) and stays bound by them: 2 fp64
// flops per 8 bytes is far below the card's fp64 rate. A is also a
// column range of a wider matrix: rows are lda elements apart, so segmented
// pricing scans a view of the shadow in place, without an O(mn/S) copy. The
// row chunks are a function of the range's (m, n) alone (the wrapper picks
// them), so a segment's result does not depend on the matrix around it.
// The scratch (partials, per-block results, ticket) belongs to the wrapper's
// cached workspace; one stream orders the calls that share it.
//
// Float64 A with float64 vectors has a second layout, "stream", at the end
// of this file: pass 2 folded into a persistent pass 1, one launch, the
// same sums to the bit. This two-launch layout ("split") keeps every other
// pair of types and the shapes the stream layout does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIntMax = 0x7fffffff;
constexpr int kPartialThreads = 256;
constexpr int kColsPerBlock = 4 * kPartialThreads;
constexpr int kReduceThreads = 256;
constexpr int kTileWarps = kReduceThreads / 32;
constexpr int kTileCols = 32;        // columns a block of pass 2 owns when tiled
constexpr int kTileBytes = 32768;    // the staged tile of partial rows
// pass 2 is tiled up to this many columns: 256-column blocks would then
// occupy at most 32 of the card's 132 SMs
constexpr int kTiledMaxCols = 8192;
constexpr int kLoadBatch = 8;
constexpr int kScanBatch = 8;
constexpr unsigned kFull = 0xffffffffu;
// kernels/ops.py BASIC_PENALTY as the plain version adds it: a float32
// constant, widened to T
constexpr float kBasicPenalty = 1e30f;

// partial rows staged in shared memory at a time: 256 in float, 128 in double
template <typename T>
__host__ __device__ constexpr int tile_chunks() { return kTileBytes / (kTileCols * (int)sizeof(T)); }

template <typename T> __device__ __forceinline__ T widen(float v) { return (T)v; }
template <typename T> __device__ __forceinline__ T widen(double v) { return (T)v; }
template <typename T> __device__ __forceinline__ T widen(__nv_bfloat16 v) {
  return (T)__bfloat162float(v);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// four neighbouring elements starting at p, widened to T (16-byte aligned
// for fp32 and fp64, 8-byte aligned for bf16; the launcher checks)
template <typename T>
__device__ __forceinline__ void load4(const float* p, T v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <typename T>
__device__ __forceinline__ void load4(const double* p, T v[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
template <typename T>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, T v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename TA, typename T, bool kVec>
__global__ void __launch_bounds__(kPartialThreads)
pricing_partial_kernel(const T* __restrict__ y, const TA* __restrict__ A,
                       int m, int n, size_t lda, int rows_per_chunk,
                       T* __restrict__ partial) {
  const int chunk = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);
  const int j0 = blockIdx.x * kColsPerBlock;
  T acc[4] = {0, 0, 0, 0};
  if (kVec) {
    const int j = j0 + 4 * threadIdx.x;  // n % 4 == 0, so j + 3 < n too
    if (j >= n) return;
#pragma unroll 4
    for (int i = r0; i < r1; ++i) {
      const T yi = y[i];
      T a[4];
      load4(A + i * lda + j, a);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fma_rn(yi, a[k], acc[k]);
    }
    store4(partial + (size_t)chunk * n + j, acc);
  } else {
    int cols[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cols[k] = j0 + threadIdx.x + k * kPartialThreads;
#pragma unroll 4
    for (int i = r0; i < r1; ++i) {
      const T yi = y[i];
      const TA* row = A + i * lda;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cols[k] < n) acc[k] = fma_rn(yi, widen<T>(row[cols[k]]), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cols[k] < n) partial[(size_t)chunk * n + cols[k]] = acc[k];
  }
}

// (value, index) order of the min: NaN first, then smaller value, then
// lower index
template <typename T>
__device__ __forceinline__ bool min_before(T a, int ia, T b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

template <typename T>
__device__ __forceinline__ void warp_reduce(T& v, int& arg, int& neg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(kFull, v, off);
    const int oa = __shfl_down_sync(kFull, arg, off);
    const int on = __shfl_down_sync(kFull, neg, off);
    if (min_before(ov, oa, v, arg)) { v = ov; arg = oa; }
    neg = min(neg, on);
  }
}

// reduces (v, arg, neg) over the block; the result is valid in thread 0.
// blockDim.x is a multiple of 32 and at most 1024.
template <typename T>
__device__ __forceinline__ void block_reduce(T& v, int& arg, int& neg) {
  __shared__ T s_v[32];
  __shared__ int s_arg[32];
  __shared__ int s_neg[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(v, arg, neg);
  if (lane == 0) { s_v[warp] = v; s_arg[warp] = arg; s_neg[warp] = neg; }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? s_v[lane] : T(INFINITY);
    arg = lane < nwarps ? s_arg[lane] : kIntMax;
    neg = lane < nwarps ? s_neg[lane] : kIntMax;
    warp_reduce(v, arg, neg);
  }
}

// The output block: min_e as a T in its first sizeof(T) bytes (so a double
// is 8-byte aligned), then int32 words argmin, first below -eps, the choice.
template <typename T>
struct Out {
  enum { kArg = sizeof(T) / 4, kNeg, kP, kWords };
};

// Pass 2, in one of two layouts the launcher picks from n alone.
// Wide ranges (``tiled`` false): a thread owns a column and adds its chunk
// partials straight from device memory, 16 loads in flight; a block owns 256
// columns. Narrow ranges (n <= kTiledMaxCols: a 2048-column segment has 256
// chunks and would leave 8 such blocks on the card, each waiting out 16
// rounds of L2 latency): a block owns 32 columns, its 8 warps stage a
// (tile_chunks, 32) tile of partials in shared memory, warp w taking chunk
// rows w, w + 8, ... with 8 independent loads in flight a thread, and warp 0
// adds each column's partials from there. Either way a column's partials are
// added by one thread in chunk order, so the result is the same to the bit.
// A is null when the partial sums are in ``partial``; where one chunk covers
// all m rows the launcher skips pass 1 and a column's thread sums over the
// rows of A (the same fma chain in row order).
template <typename TA, typename T>
__global__ void __launch_bounds__(kReduceThreads)
pricing_columns_kernel(const T* __restrict__ partial, int chunks, int tiled,
                       const T* __restrict__ y, const TA* __restrict__ A,
                       int m, size_t lda, const T* __restrict__ c,
                       const unsigned char* __restrict__ flip,
                       const int* __restrict__ basis, int m_basis, int base_col,
                       int n, T neg_eps, const void* __restrict__ use_bland,
                       int bland_is_byte, int p_offset, T* blk_min,
                       int* blk_arg, int* blk_neg, unsigned int* ticket,
                       int* __restrict__ out) {
  constexpr int kTileChunks = tile_chunks<T>();
  __shared__ T s_part[kTileChunks][kTileCols];
  __shared__ unsigned char s_basic[kReduceThreads];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols = tiled ? kTileCols : kReduceThreads;  // this block's columns
  const int j0 = blockIdx.x * cols;
  const int k_own = tiled ? lane : threadIdx.x;  // this thread's column in the block
  const int j = j0 + k_own;
  const bool owner = (!tiled || warp == 0) && j < n;  // holds column j's value
  T e = 0;
  if (A != nullptr) {
    if (owner) {
#pragma unroll 4
      for (int i = 0; i < m; ++i) e = fma_rn(y[i], widen<T>(A[i * lda + j]), e);
    }
  } else if (!tiled) {
    if (owner) {
#pragma unroll 16
      for (int k = 0; k < chunks; ++k) e += partial[(size_t)k * n + j];
    }
  } else {
    for (int k0 = 0; k0 < chunks; k0 += kTileChunks) {
      const int kn = min(kTileChunks, chunks - k0);
      if (k0 > 0) __syncthreads();  // the previous tile is summed
      if (j < n) {
        for (int kk = warp; kk < kn; kk += kLoadBatch * kTileWarps) {
          T v[kLoadBatch];
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            const int k = kk + u * kTileWarps;
            v[u] = k < kn ? partial[(size_t)(k0 + k) * n + j] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            const int k = kk + u * kTileWarps;
            if (k < kn) s_part[k][lane] = v[u];
          }
        }
      }
      __syncthreads();
      if (owner) {
#pragma unroll 8
        for (int k = 0; k < kn; ++k) e += s_part[k][lane];
      }
    }
  }
  if (basis != nullptr) {
    // flag the basic columns among this block's own
    s_basic[threadIdx.x] = 0;
    __syncthreads();
    // kScanBatch independent loads in flight per thread, then the tests
    const int first = base_col + j0;
    for (int i0 = threadIdx.x; i0 < m_basis; i0 += kScanBatch * kReduceThreads) {
      int col[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int i = i0 + u * kReduceThreads;
        col[u] = i < m_basis ? basis[i] : first - 1;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int k = col[u] - first;
        if (k >= 0 && k < cols) s_basic[k] = 1;
      }
    }
    __syncthreads();
  }
  T v = T(INFINITY);
  int arg = kIntMax;
  int neg = kIntMax;
  if (owner) {
    e -= c[j];
    if (flip != nullptr && flip[j]) e = -e;
    if (basis != nullptr && s_basic[k_own]) e += (T)kBasicPenalty;
    v = e;
    arg = j;
    if (e < neg_eps) neg = j;
  }
  block_reduce(v, arg, neg);
  if (threadIdx.x == 0) {
    blk_min[blockIdx.x] = v;
    blk_arg[blockIdx.x] = arg;
    blk_neg[blockIdx.x] = neg;
    __threadfence();  // the results are visible before the ticket is
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block to finish reduces the per-block results
  __threadfence();
  v = T(INFINITY);
  arg = kIntMax;
  neg = kIntMax;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kReduceThreads) {
    const T bv = __ldcg(blk_min + b);
    const int ba = __ldcg(blk_arg + b);
    if (min_before(bv, ba, v, arg)) { v = bv; arg = ba; }
    neg = min(neg, __ldcg(blk_neg + b));
  }
  __syncthreads();  // block_reduce's shared memory is free again
  block_reduce(v, arg, neg);
  if (threadIdx.x == 0) {
    bool bland = false;
    if (use_bland != nullptr)
      bland = bland_is_byte ? *static_cast<const unsigned char*>(use_bland) != 0
                            : *static_cast<const int*>(use_bland) != 0;
    const int p_dantzig = arg == kIntMax ? 0 : arg;
    const int p_bland = neg == kIntMax ? 0 : neg;
    *reinterpret_cast<T*>(out) = v;
    out[Out<T>::kArg] = p_dantzig;
    out[Out<T>::kNeg] = neg;
    out[Out<T>::kP] = (bland ? p_bland : p_dantzig) + p_offset;
    *ticket = 0;  // ready for the next call on this workspace
  }
}

// The untyped arguments of one call; launch<TA, T> types them.
struct Args {
  const void *y, *A, *c;
  const unsigned char* flip;
  const int* basis;
  int m_basis, base_col, m, n;
  size_t lda;
  double eps;
  int rows_per_chunk, chunks, vec;
  const void* use_bland;
  int bland_is_byte, p_offset;
  void *partial, *blk_min;
  int *blk_arg, *blk_neg;
  unsigned int* ticket;
  int* out;
};

template <typename TA, typename T>
int launch(const Args& a, cudaStream_t stream) {
  const T* y = static_cast<const T*>(a.y);
  const TA* A = static_cast<const TA*>(a.A);
  T* partial = static_cast<T*>(a.partial);
  const int n = a.n;
  const bool direct = a.chunks == 1;  // one launch: no partial sums to add up
  if (!direct) {
    const dim3 grid1((n + kColsPerBlock - 1) / kColsPerBlock, a.chunks);
    if (a.vec)
      pricing_partial_kernel<TA, T, true><<<grid1, kPartialThreads, 0, stream>>>(
          y, A, a.m, n, a.lda, a.rows_per_chunk, partial);
    else
      pricing_partial_kernel<TA, T, false><<<grid1, kPartialThreads, 0, stream>>>(
          y, A, a.m, n, a.lda, a.rows_per_chunk, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int tiled = !direct && n <= kTiledMaxCols;
  const int cols = tiled ? kTileCols : kReduceThreads;
  pricing_columns_kernel<TA, T><<<(n + cols - 1) / cols, kReduceThreads, 0, stream>>>(
      partial, a.chunks, tiled, y, direct ? A : nullptr, a.m, a.lda,
      static_cast<const T*>(a.c), a.flip, a.basis, a.m_basis, a.base_col, n,
      (T)(-a.eps), a.use_bland, a.bland_is_byte, a.p_offset,
      static_cast<T*>(a.blk_min), a.blk_arg, a.blk_neg, a.ticket, a.out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- stream layout
//
// Float64 A with float64 vectors (layout 1, "stream"). The split layout
// above runs pass 1 as 1,056 blocks of 256 threads, then pass 2 as a second
// launch whose 64 blocks of 256 columns at n = 16384 each wait out 66
// rounds of dependent loads and scan the whole basis: 11.4-11.8 of its
// 360-374 device us, on the critical path after pass 1. Here pass 2 is
// folded into pass 1, and pass 1 is a persistent grid (the wrapper's plan:
// kStreamCtas CTAs an SM) walking work items (column tile of kStreamCols,
// row chunk) chunk by chunk: item w is chunk w / col_tiles, tile w %
// col_tiles, for w = blockIdx.x, + gridDim.x, ..., so that at any time the
// CTAs read whole rows of A (every DRAM channel) a few chunks apart. A
// thread owns two adjacent columns and keeps kStreamRows 16-byte loads
// (read-only path) in flight, loaded before their FMAs, down the chunk's
// rows: the same ascending fma chain from 0 as the split layout, so a
// partial is its partial to the bit; it is stored into the same (chunks, n)
// scratch. The CTA that finishes a tile's last chunk (a counter a tile,
// taken after __threadfence) adds the tile's partials in chunk order,
// masks, flips and reduces it, with its loads in batches of 32, while the
// other CTAs stream on; the CTA that finishes the last tile (the ticket)
// reduces the tiles' records and writes the choice. So min_e, argmin,
// first-below and the choice equal the split layout's bit for bit, in one
// launch. Measured on the H100: a ring of bulk tensor copies (TMA) fed by
// a producer warp streamed A on the same schedule at 2.93 TB/s with its
// consumers idle, below these loads' rate, so TMA is not used here; and
// evict-first loads, no slower alone, left the pivot's next kernel (the
// ftran's GEMV) 6 us slower.
constexpr int kStreamThreads = 128;
constexpr int kStreamCols = 2 * kStreamThreads;    // a tile: two columns a thread (hopper._PRICING_STREAM_COLS)
constexpr int kStreamCtas = 3;                     // CTAs an SM (hopper._PRICING_STREAM_CTAS)
constexpr int kStreamRows = 16;                    // rows of loads in flight a thread
// loads in flight a thread in a tile's pass 2: its columns' partials (66
// chunks in three rounds), then the basis (8192 rows in two)
constexpr int kStreamSumBatch = 32;
constexpr int kStreamScanBatch = 32;

struct StreamArgs {
  const double *y, *c;
  const unsigned char* flip;
  const int* basis;
  int m_basis, base_col, m, n, rows_per_chunk, chunks, col_tiles;
  double neg_eps;
  const void* use_bland;
  int bland_is_byte, p_offset;
  double *partial, *blk_min;
  int *blk_arg, *blk_neg;
  unsigned int* ticket;  // [0] the tiles' ticket, [1 + t] tile t's chunks done; 0 between calls
  int* out;
};

// reduces (v, arg, neg) over the CTA; valid in thread 0
__device__ __forceinline__ void stream_reduce(double& v, int& arg, int& neg) {
  constexpr int kWarps = kStreamThreads / 32;
  __shared__ double s_v[kWarps];
  __shared__ int s_arg[kWarps];
  __shared__ int s_neg[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(v, arg, neg);
  if (lane == 0) { s_v[warp] = v; s_arg[warp] = arg; s_neg[warp] = neg; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_v[lane] : INFINITY;
    arg = lane < kWarps ? s_arg[lane] : kIntMax;
    neg = lane < kWarps ? s_neg[lane] : kIntMax;
    warp_reduce(v, arg, neg);
  }
  __syncthreads();  // the buffers are free again
}

// pass 2 of column tile `tile`, by the CTA that finished its last chunk;
// the CTA that finishes the last tile also writes the choice
__device__ void stream_tile(const StreamArgs& P, int tile) {
  __shared__ unsigned char s_basic[kStreamCols];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int j0 = tile * kStreamCols;
  const int j = j0 + 2 * tid;  // n is even: j + 1 < n with j
  __threadfence();  // the other CTAs' partials, published before their counts
  double e0 = 0, e1 = 0;
  if (j < P.n) {
    for (int k0 = 0; k0 < P.chunks; k0 += kStreamSumBatch) {
      double2 p[kStreamSumBatch];
#pragma unroll
      for (int u = 0; u < kStreamSumBatch; ++u)
        p[u] = k0 + u < P.chunks
                   ? __ldcg(reinterpret_cast<const double2*>(P.partial + (size_t)(k0 + u) * P.n + j))
                   : make_double2(0.0, 0.0);
#pragma unroll
      for (int u = 0; u < kStreamSumBatch; ++u)
        if (k0 + u < P.chunks) { e0 += p[u].x; e1 += p[u].y; }
    }
  }
  if (P.basis != nullptr) {
    s_basic[2 * tid] = s_basic[2 * tid + 1] = 0;
    __syncthreads();
    const int first = P.base_col + j0;
    for (int i0 = tid; i0 < P.m_basis; i0 += kStreamScanBatch * kStreamThreads) {
      int col[kStreamScanBatch];
#pragma unroll
      for (int u = 0; u < kStreamScanBatch; ++u) {
        const int i = i0 + u * kStreamThreads;
        col[u] = i < P.m_basis ? __ldg(P.basis + i) : first - 1;
      }
#pragma unroll
      for (int u = 0; u < kStreamScanBatch; ++u) {
        const int k = col[u] - first;
        if (k >= 0 && k < kStreamCols) s_basic[k] = 1;
      }
    }
    __syncthreads();
  }
  double v = INFINITY;
  int arg = kIntMax;
  int neg = kIntMax;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int jq = j + q;
    if (jq < P.n) {
      double e = q ? e1 : e0;
      e -= P.c[jq];
      if (P.flip != nullptr && P.flip[jq]) e = -e;
      if (P.basis != nullptr && s_basic[2 * tid + q]) e += (double)kBasicPenalty;
      if (min_before(e, jq, v, arg)) { v = e; arg = jq; }
      if (e < P.neg_eps) neg = min(neg, jq);
    }
  }
  stream_reduce(v, arg, neg);
  if (tid == 0) {
    P.blk_min[tile] = v;
    P.blk_arg[tile] = arg;
    P.blk_neg[tile] = neg;
    P.ticket[1 + tile] = 0;  // every chunk of this call is counted: ready for the next call
    __threadfence();  // the record is visible before the ticket is
    s_last = atomicAdd(P.ticket, 1u) == (unsigned)P.col_tiles - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  v = INFINITY;
  arg = kIntMax;
  neg = kIntMax;
  for (int b = tid; b < P.col_tiles; b += kStreamThreads) {
    const double bv = __ldcg(P.blk_min + b);
    const int ba = __ldcg(P.blk_arg + b);
    if (min_before(bv, ba, v, arg)) { v = bv; arg = ba; }
    neg = min(neg, __ldcg(P.blk_neg + b));
  }
  stream_reduce(v, arg, neg);
  if (tid == 0) {
    bool bland = false;
    if (P.use_bland != nullptr)
      bland = P.bland_is_byte ? *static_cast<const unsigned char*>(P.use_bland) != 0
                              : *static_cast<const int*>(P.use_bland) != 0;
    const int p_dantzig = arg == kIntMax ? 0 : arg;
    const int p_bland = neg == kIntMax ? 0 : neg;
    *reinterpret_cast<double*>(P.out) = v;
    P.out[Out<double>::kArg] = p_dantzig;
    P.out[Out<double>::kNeg] = neg;
    P.out[Out<double>::kP] = (bland ? p_bland : p_dantzig) + P.p_offset;
    *P.ticket = 0;  // ready for the next call on this workspace
  }
}

__global__ void __launch_bounds__(kStreamThreads, kStreamCtas)
pricing_stream_kernel(const StreamArgs P, const double* __restrict__ A, size_t lda) {
  __shared__ bool s_done;
  const int tid = threadIdx.x;
  const int items = P.col_tiles * P.chunks;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int chunk = w / P.col_tiles, tile = w - chunk * P.col_tiles;
    const int r0 = chunk * P.rows_per_chunk;
    const int r1 = min(P.m, r0 + P.rows_per_chunk);
    const int j = tile * kStreamCols + 2 * tid;
    if (j < P.n) {
      double acc0 = 0, acc1 = 0;
      const double* a = A + (size_t)r0 * lda + j;
      int i = r0;
      for (; i + kStreamRows <= r1; i += kStreamRows, a += kStreamRows * lda) {
        double2 v[kStreamRows];
        double yv[kStreamRows];
#pragma unroll
        for (int u = 0; u < kStreamRows; ++u) {
          v[u] = __ldg(reinterpret_cast<const double2*>(a + u * lda));
          yv[u] = __ldg(P.y + i + u);
        }
#pragma unroll
        for (int u = 0; u < kStreamRows; ++u) {
          acc0 = __fma_rn(yv[u], v[u].x, acc0);
          acc1 = __fma_rn(yv[u], v[u].y, acc1);
        }
      }
      if (i < r1) {  // the chunk's last rows, their loads in flight together
        double2 v[kStreamRows];
        double yv[kStreamRows];
#pragma unroll
        for (int u = 0; u < kStreamRows; ++u) {
          if (i + u < r1) {
            v[u] = __ldg(reinterpret_cast<const double2*>(a + u * lda));
            yv[u] = __ldg(P.y + i + u);
          }
        }
#pragma unroll
        for (int u = 0; u < kStreamRows; ++u) {
          if (i + u < r1) {
            acc0 = __fma_rn(yv[u], v[u].x, acc0);
            acc1 = __fma_rn(yv[u], v[u].y, acc1);
          }
        }
      }
      *reinterpret_cast<double2*>(P.partial + (size_t)chunk * P.n + j) = make_double2(acc0, acc1);
    }
    __threadfence();  // the partials are visible before the count is
    __syncthreads();
    if (tid == 0) s_done = atomicAdd(P.ticket + 1 + tile, 1u) == (unsigned)P.chunks - 1;
    __syncthreads();
    if (s_done) stream_tile(P, tile);
  }
}

int launch_stream(const Args& a, int grid, int col_tiles, cudaStream_t stream) {
  if (grid <= 0 || col_tiles != (a.n + kStreamCols - 1) / kStreamCols) return (int)cudaErrorInvalidValue;
  StreamArgs P = {};
  P.y = static_cast<const double*>(a.y);
  P.c = static_cast<const double*>(a.c);
  P.flip = a.flip;
  P.basis = a.basis;
  P.m_basis = a.m_basis;
  P.base_col = a.base_col;
  P.m = a.m;
  P.n = a.n;
  P.rows_per_chunk = a.rows_per_chunk;
  P.chunks = a.chunks;
  P.col_tiles = col_tiles;
  P.neg_eps = -a.eps;
  P.use_bland = a.use_bland;
  P.bland_is_byte = a.bland_is_byte;
  P.p_offset = a.p_offset;
  P.partial = static_cast<double*>(a.partial);
  P.blk_min = static_cast<double*>(a.blk_min);
  P.blk_arg = a.blk_arg;
  P.blk_neg = a.blk_neg;
  P.ticket = a.ticket;
  P.out = a.out;
  pricing_stream_kernel<<<grid, kStreamThreads, 0, stream>>>(P, static_cast<const double*>(a.A), a.lda);
  return (int)cudaGetLastError();
}

}  // namespace

// layout: 0 = split (pass 1 over a (column tiles, row chunks) grid, then
// pass 2's launch: every pair of types), 1 = stream (float64 A and vectors
// only: one persistent launch of `grid` CTAs over col_tiles = ceil(n / 256)
// column tiles, the wrapper's plan; needs vec and chunks > 1, and a ticket
// of 1 + col_tiles words).
// a_dtype: 0 = fp32 A, 1 = bf16 A, 2 = fp64 A; v_dtype: 0 = fp32, 1 = fp64,
// the type T of y, c, the scratch and min_e (A is T or bf16; another pair
// returns cudaErrorInvalidValue). lda: elements between rows of A (>= n).
// basis (m_basis int32, global column indices; null for no mask) with
// base_col, the global index of A's first column; flip (n bytes, the
// at-upper flags; null outside the signed mode); use_bland (one bool byte or
// one int32 on the device; null for Dantzig) and p_offset, added to the
// chosen column. eps is rounded to T. vec (16-byte fp32 / fp64 and 8-byte
// bf16 loads) needs n % 4 == 0, lda % 4 == 0 and an aligned A; the wrapper
// checks. Scratch: partial (chunks, n) T; blk_min T and blk_arg, blk_neg
// int32 (ceil(n / 32) each, room for either layout of pass 2 and the
// stream layout's tiles); ticket, uint32 words that are 0 between calls. out: min_e as a T, then 3 int32 words
// (argmin, first below -eps or INT_MAX, the chosen column). Returns the CUDA
// error code of the launches.
extern "C" int simplex_pricing_scan(int layout, int a_dtype, int v_dtype, const void* y, const void* A,
                                    const void* c, const void* flip,
                                    const void* basis, int m_basis, int base_col,
                                    int m, int n, long long lda, double eps,
                                    int rows_per_chunk, int chunks, int vec,
                                    const void* use_bland, int bland_is_byte,
                                    int p_offset, void* partial, void* blk_min,
                                    void* blk_arg, void* blk_neg, void* ticket,
                                    void* out, int grid, int col_tiles, void* stream) {
  Args a = {};
  a.y = y;
  a.A = A;
  a.c = c;
  a.flip = static_cast<const unsigned char*>(flip);
  a.basis = static_cast<const int*>(basis);
  a.m_basis = m_basis;
  a.base_col = base_col;
  a.m = m;
  a.n = n;
  a.lda = (size_t)lda;
  a.eps = eps;
  a.rows_per_chunk = rows_per_chunk;
  a.chunks = chunks;
  a.vec = vec;
  a.use_bland = use_bland;
  a.bland_is_byte = bland_is_byte;
  a.p_offset = p_offset;
  a.partial = partial;
  a.blk_min = blk_min;
  a.blk_arg = static_cast<int*>(blk_arg);
  a.blk_neg = static_cast<int*>(blk_neg);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.out = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 1)
    return v_dtype == 1 && a_dtype == 2 && vec && chunks > 1 ? launch_stream(a, grid, col_tiles, s)
                                                             : (int)cudaErrorInvalidValue;
  if (layout != 0) return (int)cudaErrorInvalidValue;
  if (v_dtype == 0 && a_dtype == 0) return launch<float, float>(a, s);
  if (v_dtype == 0 && a_dtype == 1) return launch<__nv_bfloat16, float>(a, s);
  if (v_dtype == 1 && a_dtype == 2) return launch<double, double>(a, s);
  if (v_dtype == 1 && a_dtype == 1) return launch<__nv_bfloat16, double>(a, s);
  return (int)cudaErrorInvalidValue;
}
