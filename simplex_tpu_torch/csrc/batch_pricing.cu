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
// axis, one pricing pass of each instance's own A a batch step, or of one
// A that every instance shares (the warm re-solve's primal clean-up,
// simplex_tpu/core/dual.py _warm_jit under vmap with A unbatched).
//
// Every e is the sum over the rows, in ascending row order, of fmaf(y[r],
// A[r, j], acc) from 0, then one subtraction of c[j]: both layouts below
// compute it so, so a shared A gives bit for bit the records of the same A
// expanded per instance. The plain PyTorch version sums through a matrix
// product, in another order: e agrees to rounding, the picks where no two
// columns tie.
//
// 1. Per-instance A (B, m, n), fp32 or the bf16 shadow. Bound on the H100:
// device-memory bandwidth, every A[i] read once: B * m * n * 4 bytes (160
// MiB at 4096 x 64 x 160; the bf16 shadow half). A 2-D grid, (column
// chunks of 256, instances): a block owns one instance's chunk, walks its
// m rows (neighbouring threads on neighbouring columns, coalesced) and
// keeps each column's sum in a register. fp32: one column a thread, 256
// threads. bf16 (n % 4 == 0): four adjacent columns a thread from one
// 8-byte load a row, 64 threads, eight rows in flight, so that a warp asks
// for 256 bytes a row and not 64. Both load eight rows before their FMAs:
// left to itself the compiler interleaves them and keeps fewer loads in
// flight. The chunk's basic columns are marked in shared memory from the
// instance's basis row first.
//
// 2. One A (m, n) for the whole batch: the (B, m) x (m, n) product Y . A
// with the masked choice in its epilogue. Bound: 2 B m n fp32 operations
// (4.3 GFLOP at 256 x 2048 x 4096, 0.064 ms at 67 TFLOP/s); the tensor
// cores take fp32 only as TF32, which the numerics contract forbids, so
// this is an SGEMM on the CUDA cores. CTA tile 64 instances x 128 columns,
// 256 threads, 4 x 8 sums a thread in registers (a warp: 32 instances x 32
// columns); the K-loop walks the rows 32 at a time through a 3-stage ring
// of dynamic shared memory filled by 16-byte cp.async copies whose sources
// each thread works out once (synchronous element loads where m, n or the
// alignment do not allow copies), zero-filled past B, m and n: an added
// fmaf(0, 0, acc) leaves acc as it is (acc is never -0). A is read from
// device memory once and from L2 once for each 64 instances. The sum order
// rules out a split of the rows over blocks (cuBLAS splits them at this
// shape), so the card holds one chain a sum: 1 M sums at 256 x 4096 are 8
// warps an SM, and the product runs at about half the FMA peak. A first
// launch writes the basic columns as a (B, ceil(n/32)) bit mask (one block
// an instance), which the epilogue reads; every (instance, column tile)
// leaves one record.
//
// 3. A window (segmented pricing, simplex_tpu/core/step.py's lax.switch
// over static column segments, under vmap every segment for every
// instance): instance i prices columns [lo_i, lo_i + w), lo_i = (seg[i] mod
// S) * w with seg (the iteration counts) read on the device, the row stride
// still n. The per-instance kernels of 1 run it as template instances of
// their own (WIN), so the unwindowed code is what it was: a grid of
// ceil(w / 256) chunks an instance, each chunk's columns offset by lo_i, the
// pick global. The result is bit for bit the unwindowed call on each
// instance's contiguous slice A[i][:, lo_i : lo_i + w] with lo_i added to
// the index (the records merge as a minimum under one total order, so the
// chunking does not matter). A shared A takes the same scan with an
// instance stride of 0 (instances of one 64-instance tile of layout 2 may
// sit in different windows): B * m * w reads that hit L2 after the first
// instance of each window, instead of the tiled product's one read of A.
// Bound: the bytes of the windows, B * m * w * 4 (per instance) or m * n
// * 4 and the 2 B m w operations (shared).
//
// Records: (min e, lowest argmin, NaN first as torch.argmin puts it;
// lowest index with e < -eps), merged by warp shuffles and shared memory.
// Where one chunk / tile covers n the kernel writes the instance's choice;
// wider instances write one record a chunk, and a last launch reduces each
// instance's records (one block an instance) in chunk order, so the result
// does not depend on the order blocks run in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;      // columns a per-instance block
constexpr int kCols = 4;         // columns a thread of the bf16 per-instance path
constexpr int kRows = 8;         // rows of A a per-instance thread loads at once
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPenalty = 1e30f;

// the shared layout's tile (hopper.py _BP_TILE_B / _BP_TILE_N mirror them)
constexpr int kTileB = 64;   // instances a CTA
constexpr int kTileN = 128;  // columns a CTA
constexpr int kTileK = 32;   // rows of A a stage
constexpr int kTileM = 4;    // y rows a thread
constexpr int kStages = 3;
constexpr int kProdThreads = kTileB * kTileN / (8 * kTileM);  // 256
constexpr int kMaskChunk = 4096;  // mask words a block holds at a time

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

__device__ __forceinline__ Rec shfl_down(const Rec& r, int off) {
  return Rec{__shfl_down_sync(kFull, r.v, off), __shfl_down_sync(kFull, r.i, off),
             __shfl_down_sync(kFull, r.neg, off)};
}

__device__ __forceinline__ Rec warp_merge(Rec r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) r = merge(r, shfl_down(r, off));
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

// e of column j from its sum: - c, signed, the basic penalty; its record
__device__ __forceinline__ Rec column_rec(float acc, float c, bool upper, bool basic, int j,
                                          float eps) {
  float e = __fsub_rn(acc, c);
  if (upper) e = -e;
  if (basic) e = __fadd_rn(e, kPenalty);
  return Rec{e, j, e < -eps ? j : kIntMax};
}

// lo: the instance's first column (under Bland's rule with no eligible
// column the pick is lo, the unwindowed call's 0 on the slice)
__device__ __forceinline__ void choose(const Rec& r, bool bland, int* p_out,
                                       float* min_out, int i, int lo) {
  p_out[i] = bland ? (r.neg == kIntMax ? lo : r.neg) : r.i;
  min_out[i] = r.v;
}

// the basic columns of [lo, lo + kChunk) of one instance, in shared memory
__device__ __forceinline__ void mark_chunk(unsigned char* basic, const int* bi, int m, int lo) {
  for (int k = threadIdx.x; k < kChunk; k += blockDim.x) basic[k] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const int b = bi[r] - lo;
    if (b >= 0 && b < kChunk) basic[b] = 1;
  }
  __syncthreads();
}

// the block's record: the instance's choice, or its chunk's record
__device__ __forceinline__ void finish_chunk(Rec rec, Rec* red, const unsigned char* use_bland,
                                             int inst, int chunks, Rec* recs, int* p_out,
                                             float* min_out, int lo) {
  rec = block_merge(rec, red);
  if (threadIdx.x == 0) {
    if (chunks == 1)
      choose(rec, use_bland[inst] != 0, p_out, min_out, inst, lo);
    else
      recs[(size_t)inst * chunks + blockIdx.x] = rec;
  }
}

struct Args {
  const float* y;                  // (B, m)
  const void* A;                   // (B, m, n), or (m, n) shared
  const float* c;                  // (B, n), or (n,) at c_stride 0
  const unsigned char* at_upper;   // (B, n) or null
  const int* basis;                // (B, m)
  const unsigned char* use_bland;  // (B,)
  int batch, m, n;
  size_t c_stride;
  float eps;
  int chunks;                      // records an instance (1: no reduce launch)
  unsigned* mask;                  // (B, words): the shared layout's basic columns
  int words;
  Rec* recs;
  int* p_out;
  float* min_out;
  // the window (WIN kernels only): width, segments, the (B,) segment
  // counters, and the elements between two instances' A (0: shared)
  int win, win_s;
  const int* win_seg;
  size_t a_stride;
};

// instance inst's first column, (seg mod S) * w with a non-negative mod
__device__ __forceinline__ int window_lo(const Args& P, int inst) {
  int s = P.win_seg[inst] % P.win_s;
  if (s < 0) s += P.win_s;
  return s * P.win;
}

// ---------------------------------------------------------------- per instance

template <typename T, bool WIN>
__global__ void __launch_bounds__(kThreads) batch_pricing_scan_kernel(const Args P) {
  __shared__ unsigned char basic[kChunk];
  __shared__ Rec red[32];
  const int inst = blockIdx.y;
  const int base = WIN ? window_lo(P, inst) : 0;
  const int lo = base + blockIdx.x * kChunk;
  const int j = lo + (int)threadIdx.x;
  const int m = P.m, n = P.n;
  const int end = WIN ? base + P.win : n;
  mark_chunk(basic, P.basis + (size_t)inst * m, m, lo);

  Rec rec{INFINITY, kIntMax, kIntMax};
  if (j < end) {
    const float* yi = P.y + (size_t)inst * m;
    const T* col = static_cast<const T*>(P.A) +
                   (WIN ? (size_t)inst * P.a_stride : (size_t)inst * m * n) + j;
    float acc = 0.f;
    int r = 0;
    for (; r + kRows <= m; r += kRows) {
      // every load of the group first: a warp keeps kRows rows in flight
      float a[kRows], yr[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        a[u] = load(col + (size_t)(r + u) * n);
        yr[u] = __ldg(yi + r + u);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc = fmaf(yr[u], a[u], acc);
    }
    for (; r < m; ++r) acc = fmaf(__ldg(yi + r), load(col + (size_t)r * n), acc);
    const size_t cn = (size_t)inst * n + j;
    rec = column_rec(acc, P.c[(size_t)inst * P.c_stride + j],
                     P.at_upper != nullptr && P.at_upper[cn], basic[threadIdx.x], j, P.eps);
  }
  finish_chunk(rec, red, P.use_bland, inst, P.chunks, P.recs, P.p_out, P.min_out, base);
}

// the bf16 shadow at n % 4 == 0: four adjacent columns a thread from one
// 8-byte load a row, eight rows in flight (a bf16 is the top half of its
// fp32 value, so the shifts convert exactly). Windowed: w % 4 == 0, so
// every window starts on a 4-column boundary.
template <bool WIN>
__global__ void __launch_bounds__(kChunk / kCols) batch_pricing_bf16x4_kernel(const Args P) {
  __shared__ unsigned char basic[kChunk];
  __shared__ Rec red[32];
  const int inst = blockIdx.y;
  const int base = WIN ? window_lo(P, inst) : 0;
  const int lo = base + blockIdx.x * kChunk;
  const int tc = kCols * (int)threadIdx.x;
  const int j = lo + tc;
  const int m = P.m, n = P.n;
  const int end = WIN ? base + P.win : n;
  mark_chunk(basic, P.basis + (size_t)inst * m, m, lo);

  Rec rec{INFINITY, kIntMax, kIntMax};
  if (j < end) {  // n % 4 == 0 (and w % 4 == 0): the four columns are all in
    const float* yi = P.y + (size_t)inst * m;
    const size_t step = (size_t)(n / kCols);  // 8-byte words a row
    const uint2* col = static_cast<const uint2*>(P.A) +
                       (WIN ? (size_t)inst * (P.a_stride / kCols) : (size_t)inst * m * step) +
                       j / kCols;
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    auto fma4 = [&](float yr, uint2 v) {
      acc[0] = fmaf(yr, __uint_as_float(v.x << 16), acc[0]);
      acc[1] = fmaf(yr, __uint_as_float(v.x & 0xffff0000u), acc[1]);
      acc[2] = fmaf(yr, __uint_as_float(v.y << 16), acc[2]);
      acc[3] = fmaf(yr, __uint_as_float(v.y & 0xffff0000u), acc[3]);
    };
    int r = 0;
    for (; r + kRows <= m; r += kRows) {
      uint2 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) v[u] = __ldg(col + (size_t)(r + u) * step);
#pragma unroll
      for (int u = 0; u < kRows; ++u) fma4(__ldg(yi + r + u), v[u]);
    }
    for (; r < m; ++r) fma4(__ldg(yi + r), __ldg(col + (size_t)r * step));
    const float* ci = P.c + (size_t)inst * P.c_stride;
    const size_t cn = (size_t)inst * n + j;
    const bool up = P.at_upper != nullptr;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      rec = merge(rec, column_rec(acc[q], ci[j + q], up && P.at_upper[cn + q], basic[tc + q],
                                  j + q, P.eps));
  }
  finish_chunk(rec, red, P.use_bland, inst, P.chunks, P.recs, P.p_out, P.min_out, base);
}

// ---------------------------------------------------------------- shared A

// bit j % 32 of word j / 32 of row i: column j is basic in instance i
__global__ void __launch_bounds__(kThreads) batch_pricing_mask_kernel(const Args P) {
  __shared__ unsigned w[kMaskChunk];
  const int inst = blockIdx.x;
  const int* bi = P.basis + (size_t)inst * P.m;
  unsigned* out = P.mask + (size_t)inst * P.words;
  for (int w0 = 0; w0 < P.words; w0 += kMaskChunk) {
    const int nw = min(kMaskChunk, P.words - w0);
    for (int k = threadIdx.x; k < nw; k += kThreads) w[k] = 0u;
    __syncthreads();
    for (int r = threadIdx.x; r < P.m; r += kThreads) {
      const int b = bi[r];
      const int k = b - w0 * 32;
      if (b >= 0 && b < P.n && k >= 0 && k < nw * 32) atomicOr(&w[k >> 5], 1u << (k & 31));
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nw; k += kThreads) out[w0 + k] = w[k];
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zeros where !in (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
struct Stage {
  // instance-major, rows padded by 4 floats: the float4 a thread reads (4
  // rows of one y) sits in other banks for each of 8 consecutive instances
  float y[kTileB][kTileK + 4];
  T a[kTileK][kTileN];
};

// Fills stages: rows [k0, k0 + kTileK) of the tile's y rows and A columns,
// by the block's threads. VEC: 16-byte copies (m % 4 == 0, n a multiple of
// 16 bytes, aligned bases), each thread's sources and bounds worked out
// once; else element loads and stores.
template <typename T, bool VEC>
struct Loader {
  static constexpr int kPer = 16 / sizeof(T);       // elements a copy
  static constexpr int kRowCopies = kTileN / kPer;  // copies a row of A's tile
  static constexpr int kYRow = kTileK / 4;                       // copies a row of y's tile
  static constexpr int kY = kTileB * kYRow / kProdThreads;       // copies of y a thread
  static constexpr int kA = kTileK * kRowCopies / kProdThreads;  // copies of A a thread
  static_assert(kY * kProdThreads == kTileB * kYRow && kA * kProdThreads == kTileK * kRowCopies,
                "every thread makes the same number of copies");
  const float* ysrc[VEC ? kY : 1];
  const T* asrc[VEC ? kA : 1];
  int yk[VEC ? kY : 1], ak[VEC ? kA : 1];  // the row offset of each copy (past m: out)
  bool yin[VEC ? kY : 1], ain[VEC ? kA : 1];

  __device__ __forceinline__ Loader(const Args& P, const T* A, int b0, int j0) {
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = threadIdx.x + u * kProdThreads, b = b0 + idx / kYRow;
        yk[u] = (idx % kYRow) * 4;
        yin[u] = b < P.batch;
        ysrc[u] = P.y + (size_t)(yin[u] ? b : 0) * P.m + yk[u];
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = threadIdx.x + u * kProdThreads, j = j0 + (idx % kRowCopies) * kPer;
        ak[u] = idx / kRowCopies;
        ain[u] = j < P.n;
        asrc[u] = A + (size_t)ak[u] * P.n + (ain[u] ? j : 0);
      }
    }
  }

  __device__ __forceinline__ void load(Stage<T>& s, const Args& P, const T* A, int b0,
                                       int j0, int k0) const {
    const int t = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = t + u * kProdThreads;
        const bool in = yin[u] && k0 + yk[u] < P.m;
        cp_async16(&s.y[idx / kYRow][yk[u]], in ? ysrc[u] + k0 : P.y, in);
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = t + u * kProdThreads;
        const bool in = ain[u] && k0 + ak[u] < P.m;
        cp_async16(&s.a[ak[u]][(idx % kRowCopies) * kPer], in ? asrc[u] + (size_t)k0 * P.n : A,
                   in);
      }
    } else {
      for (int idx = t; idx < kTileB * kTileK; idx += kProdThreads) {
        const int bi = idx / kTileK, kr = idx % kTileK;
        const int b = b0 + bi, k = k0 + kr;
        s.y[bi][kr] = (b < P.batch && k < P.m) ? P.y[(size_t)b * P.m + k] : 0.f;
      }
      for (int idx = t; idx < kTileK * kTileN; idx += kProdThreads) {
        const int kr = idx / kTileN, jc = idx % kTileN;
        const int k = k0 + kr, j = j0 + jc;
        s.a[kr][jc] = (k < P.m && j < P.n) ? A[(size_t)k * P.n + j] : T(0);
      }
    }
  }
};

// columns c0 + [0, 4) and c0 + 16 + [0, 4) of one row of the stage
__device__ __forceinline__ void load_a8(const float (&row)[kTileN], int c0, float (&a)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(&row[c0]);
  const float4 hi = *reinterpret_cast<const float4*>(&row[c0 + 16]);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}
// the bf16 tile is kept as raw 16-bit words
__device__ __forceinline__ void load_a8(const uint16_t (&row)[kTileN], int c0, float (&a)[8]) {
  const uint2 lo = *reinterpret_cast<const uint2*>(&row[c0]);
  const uint2 hi = *reinterpret_cast<const uint2*>(&row[c0 + 16]);
  const unsigned u[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    a[2 * h] = __uint_as_float(u[h] << 16);
    a[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
  }
}

// grid (column tiles, instance tiles). kTileM rows of y a thread (8 apart)
// and 8 columns: a warp holds 8 x 4 lanes, 32 instances x 32 columns (a
// warp's load of A is 4 distinct float4, of y 8 on 8 consecutive rows, in
// distinct banks); the 64 x 128 tile takes 2 x 4 warps.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kProdThreads) batch_pricing_product_kernel(const Args P) {
  constexpr int kWarpsN = kTileN / 32;
  using S = Stage<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  S* st = reinterpret_cast<S*>(smem);
  Rec(*red)[kTileB] = reinterpret_cast<Rec(*)[kTileB]>(smem + kStages * sizeof(S));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % kWarpsN, wb = warp / kWarpsN;
  const int lx = lane & 3, ly = lane >> 2;
  const int row0 = wb * 8 * kTileM + ly;  // this thread's y rows: row0 + 8 i
  const int col0 = wn * 32 + lx * 4;  // and columns: col0 + [0, 4), col0 + 16 + [0, 4)
  const int j0 = blockIdx.x * kTileN, b0 = blockIdx.y * kTileB;
  const T* A = static_cast<const T*>(P.A);
  const int k_tiles = (P.m + kTileK - 1) / kTileK;
  const Loader<T, VEC> ld(P, A, b0, j0);

  float acc[kTileM][8];
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) ld.load(st[s], P, A, b0, j0, s * kTileK);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every thread is done with tile kt - 1
    const int nt = kt + kStages - 1;
    if (nt < k_tiles) ld.load(st[nt % kStages], P, A, b0, j0, nt * kTileK);
    cp_async_commit();
    const S& s = st[kt % kStages];
#pragma unroll
    for (int k4 = 0; k4 < kTileK; k4 += 4) {
      float yv[kTileM][4];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&s.y[row0 + 8 * i][k4]);
        yv[i][0] = v.x; yv[i][1] = v.y; yv[i][2] = v.z; yv[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[8];
        load_a8(s.a[k4 + kk], col0, a);
#pragma unroll
        for (int i = 0; i < kTileM; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(yv[i][kk], a[jj], acc[i][jj]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: each instance's record over the warp's 32 columns (the 4
  // lanes of one ly), then over the tile's 4 warps of columns
#pragma unroll
  for (int i = 0; i < kTileM; ++i) {
    const int b = b0 + row0 + 8 * i;
    Rec rec{INFINITY, kIntMax, kIntMax};
    if (b < P.batch) {
      const float* cb = P.c + (size_t)b * P.c_stride;
      const unsigned* mb = P.mask + (size_t)b * P.words;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + col0 + (jj < 4 ? jj : 12 + jj);
        if (j < P.n) {
          const bool up = P.at_upper != nullptr && P.at_upper[(size_t)b * P.n + j];
          const bool basic = (mb[j >> 5] >> (j & 31)) & 1u;
          rec = merge(rec, column_rec(acc[i][jj], cb[j], up, basic, j, P.eps));
        }
      }
    }
    // merge is commutative: every lane of the four ends with the same record
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const Rec o{__shfl_xor_sync(kFull, rec.v, off), __shfl_xor_sync(kFull, rec.i, off),
                  __shfl_xor_sync(kFull, rec.neg, off)};
      rec = merge(rec, o);
    }
    if (lx == 0) red[wn][row0 + 8 * i] = rec;
  }
  __syncthreads();
  if (threadIdx.x < kTileB) {
    const int b = b0 + threadIdx.x;
    Rec rec = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) rec = merge(rec, red[w][threadIdx.x]);
    if (b < P.batch) {
      if (P.chunks == 1)
        choose(rec, P.use_bland[b] != 0, P.p_out, P.min_out, b, 0);
      else
        P.recs[(size_t)b * P.chunks + blockIdx.x] = rec;
    }
  }
}

// one launch of the product: the ring and the records in dynamic shared
// memory (78 KB in fp32, above the 48 KB a launch gets without asking)
template <typename T, bool VEC>
cudaError_t launch_product(const Args& P, cudaStream_t s) {
  constexpr size_t smem = kStages * sizeof(Stage<T>) + (kTileN / 32) * kTileB * sizeof(Rec);
  auto kernel = batch_pricing_product_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P.chunks, (P.batch + kTileB - 1) / kTileB);
  kernel<<<grid, kProdThreads, smem, s>>>(P);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- records

template <bool WIN>
__global__ void __launch_bounds__(kThreads) batch_pricing_reduce_kernel(const Args P) {
  __shared__ Rec red[32];
  const int inst = blockIdx.x;
  Rec rec{INFINITY, kIntMax, kIntMax};
  for (int k = threadIdx.x; k < P.chunks; k += kThreads)
    rec = merge(rec, P.recs[(size_t)inst * P.chunks + k]);
  rec = block_merge(rec, red);
  if (threadIdx.x == 0)
    choose(rec, P.use_bland[inst] != 0, P.p_out, P.min_out, inst, WIN ? window_lo(P, inst) : 0);
}

}  // namespace

// layout 0: per-instance A (B, m, n), a column a thread; 1: per-instance
// bf16, four columns a thread (n % 4 == 0, A 8-byte aligned); 2: one shared
// A (m, n), 16-byte copies (m % 4 == 0, n * elem % 16 == 0, y and A 16-byte
// aligned); 3: one shared A, element loads.
// a_dtype 0: A fp32, 1: bf16. y (B, m) fp32; c (B, n) fp32, or one (n,)
// with c_shared; at_upper (B, n) bool bytes or null (the unsigned mode);
// basis (B, m) int32; use_bland (B,) bool bytes. chunks: records an
// instance, ceil(n / 256) (layouts 0, 1) or ceil(n / 128) (2, 3); words:
// ceil(n / 32) (2, 3; else 0). Scratch: mask, B * words uint32 (2, 3);
// recs, B * chunks 12-byte records where chunks > 1. Outputs: p (B,) int32,
// min_e (B,) fp32. The window: win = 0 prices every column; win > 0 (layouts
// 0 and 1 only, chunks = ceil(win / 256), win * win_s <= n, layout 1 also
// win % 4 == 0) prices [(win_seg[i] mod win_s) * win, + win) of instance i,
// win_seg (B,) int32; a_shared (windowed only): one A (m, n) for every
// instance. Returns a cudaError_t; an inconsistent plan is
// cudaErrorInvalidValue.
extern "C" int simplex_batch_pricing(int layout, int a_dtype, const void* y, const void* A,
                                     const void* c, const void* at_upper, const void* basis,
                                     const void* use_bland, int batch, int m, int n,
                                     int c_shared, float eps, int chunks, int words,
                                     void* mask, void* recs, void* p, void* min_e, int win,
                                     int win_s, const void* win_seg, int a_shared,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = layout >= 2;
  const bool windowed = win > 0;
  const int tile = shared ? kTileN : kChunk;
  const int span = windowed ? win : n;
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y), aa = reinterpret_cast<uintptr_t>(A);
  const bool copies16 = m % 4 == 0 && (n * (a_dtype == 1 ? 2 : 4)) % 16 == 0 && ya % 16 == 0 &&
                        aa % 16 == 0;
  if (layout < 0 || layout > 3 || a_dtype < 0 || a_dtype > 1 || batch < 1 || m < 1 || n < 1 ||
      win < 0 || chunks != (span + tile - 1) / tile || words != (shared ? (n + 31) / 32 : 0) ||
      (layout == 1 && (a_dtype != 1 || n % kCols != 0 || aa % 8 != 0 ||
                       (windowed && win % kCols != 0))) ||
      (layout == 2 && !copies16) || (shared && mask == nullptr) ||
      (chunks > 1 && recs == nullptr) || (a_shared && !windowed) ||
      (windowed && (shared || win_s < 1 || (long long)win * win_s > n || win_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args P;
  P.y = static_cast<const float*>(y);
  P.A = A;
  P.c = static_cast<const float*>(c);
  P.at_upper = static_cast<const unsigned char*>(at_upper);
  P.basis = static_cast<const int*>(basis);
  P.use_bland = static_cast<const unsigned char*>(use_bland);
  P.batch = batch;
  P.m = m;
  P.n = n;
  P.c_stride = c_shared ? 0 : (size_t)n;
  P.eps = eps;
  P.chunks = chunks;
  P.mask = static_cast<unsigned*>(mask);
  P.words = words;
  P.recs = static_cast<Rec*>(recs);
  P.p_out = static_cast<int*>(p);
  P.min_out = static_cast<float*>(min_e);
  P.win = win;
  P.win_s = win_s;
  P.win_seg = static_cast<const int*>(win_seg);
  P.a_stride = a_shared ? 0 : (size_t)m * n;
  const bool bf16 = a_dtype == 1;
  if (!shared) {
    const dim3 grid(chunks, batch);
    if (windowed) {
      if (layout == 1)
        batch_pricing_bf16x4_kernel<true><<<grid, kChunk / kCols, 0, s>>>(P);
      else if (bf16)
        batch_pricing_scan_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(P);
      else
        batch_pricing_scan_kernel<float, true><<<grid, kThreads, 0, s>>>(P);
    } else if (layout == 1) {
      batch_pricing_bf16x4_kernel<false><<<grid, kChunk / kCols, 0, s>>>(P);
    } else if (bf16) {
      batch_pricing_scan_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(P);
    } else {
      batch_pricing_scan_kernel<float, false><<<grid, kThreads, 0, s>>>(P);
    }
  } else {
    batch_pricing_mask_kernel<<<batch, kThreads, 0, s>>>(P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (layout == 2 && bf16)
      err = launch_product<uint16_t, true>(P, s);
    else if (layout == 2)
      err = launch_product<float, true>(P, s);
    else if (bf16)
      err = launch_product<uint16_t, false>(P, s);
    else
      err = launch_product<float, false>(P, s);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  if (windowed)
    batch_pricing_reduce_kernel<true><<<batch, kThreads, 0, s>>>(P);
  else
    batch_pricing_reduce_kernel<false><<<batch, kThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}

// the size of one chunk record, for the wrapper's scratch
extern "C" int simplex_batch_pricing_record_bytes() { return (int)sizeof(Rec); }
