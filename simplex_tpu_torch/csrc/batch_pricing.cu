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
// Every e is the sum over the rows, in ascending row order, of fma(y[r],
// A[r, j], acc) from 0, then one subtraction of c[j]: every layout below
// computes it so (in double on the shared layouts through the FP64 tensor
// cores, whose mma equals that chain: 4), so a shared A gives bit for bit
// the records of the same A expanded per instance, and a window bit for bit
// those of the call on the instance's slice. The plain PyTorch version sums
// through a matrix product, in another order: e agrees to rounding, the
// picks where no two columns tie.
//
// Element types. The vectors y, c, the sums, eps and min e are of one type
// V, float or double; A is of V's own type or the bf16 shadow (each element
// widened exactly). A dtype code for each picks the instantiation; eps
// arrives as a double and is rounded to V once. In double the basic
// penalty is the float 1e30 widened (as the plain version builds it), a
// record holds a double, and every byte count below doubles; the
// per-instance layouts run DFMA on the CUDA cores (16 rows of 2 KB a box
// of the window's tensor map), the shared ones the FP64 tensor cores (4).
//
// 1. Per-instance A (B, m, n), fp32 or the bf16 shadow. Bound on the H100:
// device-memory bandwidth, every A[i] read once: B * m * n * 4 bytes (160
// MiB at 4096 x 64 x 160; the bf16 shadow half, fp64 twice). A 2-D grid, (column
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
// with the masked choice in its epilogue. Bound: 2 B m n operations (4.3
// GFLOP at 256 x 2048 x 4096, 0.064 ms at 67 TFLOP/s: fp32 on the CUDA
// cores, fp64 on the tensor cores). In fp32 the tensor cores take fp32 only
// as TF32, which the numerics contract forbids, so this is an SGEMM on the
// CUDA cores (fp64: 4). CTA tile 64 instances x 128 columns,
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
// still n; the pick is global. The result is bit for bit the unwindowed
// call on each instance's contiguous slice A[i][:, lo_i : lo_i + w] with
// lo_i added to the index (the records merge as a minimum under one total
// order, so the chunking does not matter).
//
// 3a. Per-instance A, "window_tma". Bound: the windows' bytes, B * m * w *
// 4 (64 MiB, 0.020 ms at 64 x 512 x 4096, w = 512; bf16 half). The grid is
// (ceil(w / 256) chunks, B), one CTA an SM at that shape, so each CTA has
// to keep its SM's share of the bandwidth in flight by itself: a producer
// warp streams the chunk's rows into a ring of 4 shared-memory stages, a
// stage one box of a 3-D tensor map of A (n, m, B) (32 rows of 1 KB in
// fp32, 64 rows of 512 B in bf16; rows past m land as zeros) and one bulk
// copy of the rows' y, both completing on the stage's full mbarrier by
// bytes: 128 KB in flight a CTA (a bulk copy a row cost about 50 ns each
// and held the bf16 scan at half the rate of one box a stage). The
// consumer warps (a column a thread in fp32, four in bf16) run the same
// ascending fmaf chain out of shared memory and release a stage through its
// empty mbarrier, one arrival a warp. Up to 8 chunks of an instance run as
// one thread block cluster, and its block 0 merges their records through
// distributed shared memory: one launch. The copies need 16-byte-aligned
// sources, strides and sizes (m % 4 == 0, n * elem and w * elem multiples
// of 16, y and A 16-byte aligned); elsewhere the per-instance kernels of 1
// run the window as template instances of their own (WIN: "scan",
// "bf16x4"), a grid of ceil(w / 256) chunks an instance.
//
// 3b. One A shared by the batch, "window_group": instances of one tile of
// layout 2 may sit in different windows, so the launch before the product
// groups them on the device. Its block 0 sorts the instances by window s =
// seg mod S (a stable counting sort: a permutation, ascending instance
// inside each window) and writes a table of instance tiles, each inside
// one window; the other blocks write the bit mask as in 2. The grid of the
// product comes from host-known B, S and w: ceil(B / 16) + S - 1 instance
// tiles (fp64: ceil(B / 32) + S - 1) can exist over all windows, and the
// surplus CTAs return at once.
// Bound: 2 B m w operations (0.0080 ms at 256 x 2048 x 4096 with S = 8)
// or the distinct windows' bytes (fp64: 4). In fp32 a window holds about 32
// instances, 1 M sums in all, each a 2,048-row chain: about 1,000 sums an
// SM. A thread of 4 x 4 sums reads 8 floats out of shared memory for 16
// FMAs a row, but leaves 2 or 3 warps an SM, one a scheduler, which run
// at about half a warp instruction a cycle; a thread of 2 x 4 sums reads 6
// floats for 8 FMAs and gives twice the warps. A CTA is 2 warps: 16
// grouped instances (y rows gathered through the permutation) x 32 columns
// of their window (A's columns at lo_s + the tile), on layout 2's cp.async
// ring (4 stages of 32 rows) and zero fill: about 320 CTAs at that shape.
// More than 1024 windows (S) take the scan at an instance stride of 0.
//
// 4. The shared layouts in double (2 and 3b with V = double: A double or
// the bf16 shadow, widened between shared memory and the fragment) run
// their product on the FP64 tensor cores, mma.sync m16n8k4 .f64 (wgmma has
// no f64 form). csrc/dmma_probe.cu holds every f64 mma shape against the
// ascending chain acc = fma(a_k, b_k, acc) from C on 1.5 M tiles a shape,
// random and adversarial (cancellation, 2^+-500, subnormal products,
// overflow, +-0, inf, NaN): on the H100 each output of m8n8k4, m16n8k4,
// m16n8k8 and m16n8k16 equals it bit for bit. So an accumulator that starts
// at 0 and takes one mma a k-step, the steps ascending from row 0, sums as
// the per-instance DFMA chain does: no split of the rows over CTAs, no
// atomics, and every bit-for-bit check above stands in fp64 too. Zero fill
// past m, B and n (w) as in fp32: an added fma(0, 0, acc) leaves acc.
// Fragments come out of shared memory as 8-byte loads (ldmatrix has no
// 64-bit form) from rows padded so that the 16 lanes of each phase of a
// fragment load (4 rows x 4 columns) fall in distinct banks: y rows of 36
// doubles, A rows of TN + 4 doubles (TN + 8 bf16 words, each word's pair
// read together); 32 rows a stage. A warp holds 32 x 32 (or 16 x 16)
// accumulators: one 8-byte load a lane for each mma (1.5 for 16 x 16).
// Shared product (2): CTA 128 instances x 64 columns, 8 mma warps of 32 x
// 32 and a producer warp that streams the stages by bulk tensor copies
// (one box of y's tensor map, 36 x 128, and one of A's, 68 x 32, a stage;
// zeros past m, n and B come from the copy) into a ring of 3 full / empty
// mbarrier pairs (163 KB): 128 CTAs at 256 x 2048 x 4096, one an SM. A CTA
// reads 8 m (TB + TN) bytes, 403 MB at that shape. Measured on the H100
// against this design's variants (PERF.md section 6): the same tile fed by
// cp.async and block barriers took 110 device us, 64 x 64 tiles two CTAs
// an SM (537 MB) 105-107, warps of 32 x 16 or 16 x 32 (1.5 loads an mma)
// 117, m16n8k8 / k16 for k4 114 / 123; the bulk copies 89-97.
// Grouped window (5): the grouping launch as in fp32, its table in tiles of
// 32 instances (two m16 row blocks); a CTA is a tile x 64 of its window's
// columns, 8 warps of 16 x 16, fed by layout 2's cp.async ring of 4 stages
// (106 KB), since its y rows are gathered through the permutation (a bulk
// copy a row took twice as long). Bound: the windows' bytes, 0.0219 ms at
// 256 x 2048 x 4096 with S = 8; each of a window's one or two instance
// tiles reads its columns from L2 again. Element loads (3, 6) run the same
// tiles through the same ring by plain loads and stores.
//
// Records: (min e, lowest argmin, NaN first as torch.argmin puts it;
// lowest index with e < -eps), merged by warp shuffles and shared memory.
// Where one chunk / tile covers n (or w) the kernel writes the instance's
// choice; wider instances write one record a chunk, and a last launch
// reduces each instance's records (one block an instance) in chunk order,
// so the result does not depend on the order blocks run in.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
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
constexpr float kPenalty = 1e30f;  // widened to double in fp64, as the plain version's

// the shared layout's tile (hopper.py _BP_TILE_B / _BP_TILE_N mirror them)
constexpr int kTileB = 64;   // instances a CTA
constexpr int kTileN = 128;  // columns a CTA
constexpr int kTileM = 4;    // y rows a thread
constexpr int kStages = 3;
constexpr int kProdThreads = kTileB * kTileN / (8 * kTileM);  // 256
constexpr int kMaskChunk = 4096;  // mask words a block holds at a time

// the window's bulk-copy scan (hopper.py _BP_TMA_* mirror it): columns a
// chunk, stages; an instance's chunks up to kTmaClusterMax run as one
// thread block cluster and merge their records through distributed shared
// memory (no reduction launch)
constexpr int kTmaChunk = 256;
constexpr int kTmaStages = 4;
constexpr int kTmaClusterMax = 8;
// the grouped window (hopper.py _BP_GROUP_* mirror it): at most this many
// windows; a CTA of 2 warps along the instances, a warp 8 instances x 32
// columns, a thread 2 instances (4 apart) x 4 adjacent columns; its ring
constexpr int kGroupBins = 1024;
constexpr int kGroupWarps = 2;
constexpr int kGroupTM = 2;
constexpr int kGroupB = 4 * kGroupTM * kGroupWarps, kGroupN = 32;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGroupStages = 4;

// rows of A a stage of the shared product and of the grouped window: 128
// bytes of y a row of a stage (32 floats, 16 doubles)
template <typename V>
__host__ __device__ constexpr int tile_k() { return 128 / (int)sizeof(V); }
// rows of a box of the window's tensor map: 1 KB a row in fp32, 512 B in
// bf16, 2 KB in fp64, so a stage is 32 KB in each
template <typename T>
__host__ __device__ constexpr int tma_rows() { return 128 / (int)sizeof(T); }

template <typename V>
struct Rec {
  V v;      // the minimum
  int i;    // its lowest index
  int neg;  // the lowest index with e < -eps, kIntMax when none
};

template <typename V>
__device__ __forceinline__ Rec<V> rec_none() {
  return Rec<V>{V(INFINITY), kIntMax, kIntMax};
}

// an instance tile of the grouped window: instances perm[start, start +
// count), all in window s (count 0: a surplus tile)
struct Group {
  int s, start, count;
};

// one rounding an op, in float or in double
__device__ __forceinline__ float fma_v(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_v(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sub_v(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_v(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_v(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_v(double a, double b) { return __dadd_rn(a, b); }

// a before b: NaN first (torch.min / argmin), then smaller, then lower index
template <typename V>
__device__ __forceinline__ bool before(V a, int ia, V b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

template <typename V>
__device__ __forceinline__ Rec<V> merge(Rec<V> a, const Rec<V>& b) {
  if (before(b.v, b.i, a.v, a.i)) { a.v = b.v; a.i = b.i; }
  a.neg = min(a.neg, b.neg);
  return a;
}

template <typename V>
__device__ __forceinline__ Rec<V> shfl_down(const Rec<V>& r, int off) {
  return Rec<V>{__shfl_down_sync(kFull, r.v, off), __shfl_down_sync(kFull, r.i, off),
                __shfl_down_sync(kFull, r.neg, off)};
}

template <typename V>
__device__ __forceinline__ Rec<V> shfl_xor(const Rec<V>& r, int off) {
  return Rec<V>{__shfl_xor_sync(kFull, r.v, off), __shfl_xor_sync(kFull, r.i, off),
                __shfl_xor_sync(kFull, r.neg, off)};
}

template <typename V>
__device__ __forceinline__ Rec<V> warp_merge(Rec<V> r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) r = merge(r, shfl_down(r, off));
  return r;
}

// thread 0 gets the block's record
template <typename V>
__device__ Rec<V> block_merge(Rec<V> r, Rec<V>* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r = warp_merge(r);
  if (lane == 0) red[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = lane < (int)(blockDim.x >> 5) ? red[lane] : rec_none<V>();
    r = warp_merge(r);
  }
  return r;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// e of column j from its sum: - c, signed, the basic penalty; its record
template <typename V>
__device__ __forceinline__ Rec<V> column_rec(V acc, V c, bool upper, bool basic, int j, V eps) {
  V e = sub_v(acc, c);
  if (upper) e = -e;
  if (basic) e = add_v(e, V(kPenalty));
  return Rec<V>{e, j, e < -eps ? j : kIntMax};
}

// lo: the instance's first column (under Bland's rule with no eligible
// column the pick is lo, the unwindowed call's 0 on the slice)
template <typename V>
__device__ __forceinline__ void choose(const Rec<V>& r, bool bland, int* p_out, void* min_out,
                                       int i, int lo) {
  p_out[i] = bland ? (r.neg == kIntMax ? lo : r.neg) : r.i;
  static_cast<V*>(min_out)[i] = r.v;
}

// the basic columns of [lo, lo + C) of one instance, in shared memory
template <int C = kChunk>
__device__ __forceinline__ void mark_chunk(unsigned char* basic, const int* bi, int m, int lo) {
  for (int k = threadIdx.x; k < C; k += blockDim.x) basic[k] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const int b = bi[r] - lo;
    if (b >= 0 && b < C) basic[b] = 1;
  }
  __syncthreads();
}

struct Args {
  const void* y;                   // (B, m) V
  const void* A;                   // (B, m, n), or (m, n) shared: V or bf16
  const void* c;                   // (B, n) V, or (n,) at c_stride 0
  const unsigned char* at_upper;   // (B, n) or null
  const int* basis;                // (B, m)
  const unsigned char* use_bland;  // (B,)
  int batch, m, n;
  size_t c_stride;
  float eps_f;                     // eps rounded to float, and as the double it came as
  double eps_d;
  int chunks;                      // records an instance (1: no reduce launch)
  unsigned* mask;                  // (B, words): the shared layouts' basic columns
  int words;
  void* recs;                      // (B, chunks) Rec<V>
  int* p_out;
  void* min_out;                   // (B,) V
  // the window (WIN kernels only): width, segments, the (B,) segment
  // counters, and the elements between two instances' A (0: shared)
  int win, win_s;
  const int* win_seg;
  size_t a_stride;
  // the grouped window: the permutation (B), each window's first place in
  // it (S + 1), the instance tiles (group_tiles) and their instances each
  int* perm;
  int* win_off;
  Group* groups;
  int group_tiles;
};

template <typename V>
__device__ __forceinline__ const V* y_of(const Args& P) { return static_cast<const V*>(P.y); }
template <typename V>
__device__ __forceinline__ const V* c_of(const Args& P) { return static_cast<const V*>(P.c); }
template <typename V>
__device__ __forceinline__ Rec<V>* recs_of(const Args& P) { return static_cast<Rec<V>*>(P.recs); }
__device__ __forceinline__ float eps_of(const Args& P, float) { return P.eps_f; }
__device__ __forceinline__ double eps_of(const Args& P, double) { return P.eps_d; }

// the block's record: the instance's choice, or its chunk's record
template <typename V>
__device__ __forceinline__ void finish_chunk(Rec<V> rec, Rec<V>* red, const Args& P, int inst,
                                             int lo) {
  rec = block_merge(rec, red);
  if (threadIdx.x == 0) {
    if (P.chunks == 1)
      choose(rec, P.use_bland[inst] != 0, P.p_out, P.min_out, inst, lo);
    else
      recs_of<V>(P)[(size_t)inst * P.chunks + blockIdx.x] = rec;
  }
}

// instance inst's window, seg mod S with a non-negative mod
__device__ __forceinline__ int window_of(const Args& P, int inst) {
  int s = P.win_seg[inst] % P.win_s;
  if (s < 0) s += P.win_s;
  return s;
}

// instance inst's first column, (seg mod S) * w
__device__ __forceinline__ int window_lo(const Args& P, int inst) {
  return window_of(P, inst) * P.win;
}

// ---------------------------------------------------------------- per instance

// T: A's element (float, double, __nv_bfloat16); V: the vectors'
template <typename T, typename V, bool WIN>
__global__ void __launch_bounds__(kThreads) batch_pricing_scan_kernel(const Args P) {
  __shared__ unsigned char basic[kChunk];
  __shared__ Rec<V> red[32];
  const int inst = blockIdx.y;
  const int base = WIN ? window_lo(P, inst) : 0;
  const int lo = base + blockIdx.x * kChunk;
  const int j = lo + (int)threadIdx.x;
  const int m = P.m, n = P.n;
  const int end = WIN ? base + P.win : n;
  mark_chunk(basic, P.basis + (size_t)inst * m, m, lo);

  Rec<V> rec = rec_none<V>();
  if (j < end) {
    const V* yi = y_of<V>(P) + (size_t)inst * m;
    const T* col = static_cast<const T*>(P.A) +
                   (WIN ? (size_t)inst * P.a_stride : (size_t)inst * m * n) + j;
    V acc = V(0);
    int r = 0;
    for (; r + kRows <= m; r += kRows) {
      // every load of the group first: a warp keeps kRows rows in flight
      V a[kRows], yr[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        a[u] = load(col + (size_t)(r + u) * n);
        yr[u] = __ldg(yi + r + u);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc = fma_v(yr[u], a[u], acc);
    }
    for (; r < m; ++r) acc = fma_v(__ldg(yi + r), (V)load(col + (size_t)r * n), acc);
    const size_t cn = (size_t)inst * n + j;
    rec = column_rec<V>(acc, c_of<V>(P)[(size_t)inst * P.c_stride + j],
                        P.at_upper != nullptr && P.at_upper[cn], basic[threadIdx.x], j, eps_of(P, V()));
  }
  finish_chunk(rec, red, P, inst, base);
}

// the bf16 shadow at n % 4 == 0: four adjacent columns a thread from one
// 8-byte load a row, eight rows in flight (a bf16 is the top half of its
// fp32 value, so the shifts widen it exactly). Windowed: w % 4 == 0, so
// every window starts on a 4-column boundary.
template <typename V, bool WIN>
__global__ void __launch_bounds__(kChunk / kCols) batch_pricing_bf16x4_kernel(const Args P) {
  __shared__ unsigned char basic[kChunk];
  __shared__ Rec<V> red[32];
  const int inst = blockIdx.y;
  const int base = WIN ? window_lo(P, inst) : 0;
  const int lo = base + blockIdx.x * kChunk;
  const int tc = kCols * (int)threadIdx.x;
  const int j = lo + tc;
  const int m = P.m, n = P.n;
  const int end = WIN ? base + P.win : n;
  mark_chunk(basic, P.basis + (size_t)inst * m, m, lo);

  Rec<V> rec = rec_none<V>();
  if (j < end) {  // n % 4 == 0 (and w % 4 == 0): the four columns are all in
    const V* yi = y_of<V>(P) + (size_t)inst * m;
    const size_t step = (size_t)(n / kCols);  // 8-byte words a row
    const uint2* col = static_cast<const uint2*>(P.A) +
                       (WIN ? (size_t)inst * (P.a_stride / kCols) : (size_t)inst * m * step) +
                       j / kCols;
    V acc[kCols] = {V(0), V(0), V(0), V(0)};
    auto fma4 = [&](V yr, uint2 v) {
      acc[0] = fma_v(yr, (V)__uint_as_float(v.x << 16), acc[0]);
      acc[1] = fma_v(yr, (V)__uint_as_float(v.x & 0xffff0000u), acc[1]);
      acc[2] = fma_v(yr, (V)__uint_as_float(v.y << 16), acc[2]);
      acc[3] = fma_v(yr, (V)__uint_as_float(v.y & 0xffff0000u), acc[3]);
    };
    // the group's first row as a 64-bit pointer, its rows at 32-bit offsets
    // (u * step < 2^32 for any int n): 64-bit offsets a row put a carry
    // IMAD.X on the FMA pipe beside every load, 2% of the fp32 call
    const unsigned stepw = (unsigned)step;
    const uint2* row = col;
    int r = 0;
    for (; r + kRows <= m; r += kRows, row += kRows * (size_t)stepw) {
      uint2 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) v[u] = __ldg(row + u * stepw);
#pragma unroll
      for (int u = 0; u < kRows; ++u) fma4(__ldg(yi + r + u), v[u]);
    }
    for (; r < m; ++r, row += stepw) fma4(__ldg(yi + r), __ldg(row));
    const V* ci = c_of<V>(P) + (size_t)inst * P.c_stride;
    const size_t cn = (size_t)inst * n + j;
    const bool up = P.at_upper != nullptr;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      rec = merge(rec, column_rec<V>(acc[q], ci[j + q], up && P.at_upper[cn + q], basic[tc + q],
                                     j + q, eps_of(P, V())));
  }
  finish_chunk(rec, red, P, inst, base);
}

// ---------------------------------------------------------------- async copies

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

// mbarriers in shared memory and the bulk copies that complete on them
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival, and bytes more that the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared, counted on bar when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box (C columns, R rows, instance inst) at column x, row r of a 3-D
// tensor map (n, m, B) into shared memory, counted on bar when it lands
// (rows past m land as zeros; the bytes counted are the whole box's)
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x, int r, int inst,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(r), "r"(inst), "r"(smem_u32(bar))
      : "memory");
}

// the box (x, r) of a 2-D tensor map into shared memory, counted on bar
__device__ __forceinline__ void tensor_copy2(void* dst, const CUtensorMap* map, int x, int r,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(r), "r"(smem_u32(bar))
      : "memory");
}

// four consecutive V of shared memory, 16-byte aligned
__device__ __forceinline__ void load4v(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4v(const double* p, double (&v)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
// four adjacent columns of one row of a stage, as V
__device__ __forceinline__ void load_a4(const float* row, int c0, float (&a)[4]) { load4v(row + c0, a); }
__device__ __forceinline__ void load_a4(const double* row, int c0, double (&a)[4]) { load4v(row + c0, a); }
template <typename V>
__device__ __forceinline__ void load_a4(const uint16_t* row, int c0, V (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(&row[c0]);
  a[0] = (V)__uint_as_float(v.x << 16); a[1] = (V)__uint_as_float(v.x & 0xffff0000u);
  a[2] = (V)__uint_as_float(v.y << 16); a[3] = (V)__uint_as_float(v.y & 0xffff0000u);
}

// ---------------------------------------------------------------- window, bulk copies

// one stage of the ring: R rows of the chunk's C columns, then their y
// (padded to 32 values: the next stage's box lands 128-byte aligned)
template <typename T, typename V, int C, int R>
struct WinStage {
  T a[R][C];
  V y[(R + 31) / 32 * 32];
};

// T: float, double, or uint16_t for the bf16 shadow (four columns a thread)
template <typename T, typename V>
struct WinTma {
  static constexpr int kCpt = sizeof(T) == 2 ? kCols : 1;  // columns a consumer thread
  static constexpr int kR = tma_rows<T>();
  static constexpr int kConsumers = kTmaChunk / kCpt;
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  using Stage = WinStage<T, V, kTmaChunk, kR>;
  static constexpr size_t kSmem = kTmaStages * (sizeof(Stage) + 2 * sizeof(uint64_t));
  static_assert(sizeof(Stage) % 128 == 0, "stages stay 128-byte aligned");
};

__device__ __forceinline__ void fma_row(float (&acc)[1], float yr, const float* row, int tc) {
  acc[0] = fmaf(yr, row[tc], acc[0]);
}
__device__ __forceinline__ void fma_row(double (&acc)[1], double yr, const double* row, int tc) {
  acc[0] = fma(yr, row[tc], acc[0]);
}
// four bf16 columns
template <typename V>
__device__ __forceinline__ void fma_row(V (&acc)[kCols], V yr, const uint16_t* row, int tc) {
  V a[4];
  load_a4(row, tc, a);
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = fma_v(yr, a[q], acc[q]);
}

// grid (chunks, B); the last warp copies (a box of the tensor map and the
// rows' y a stage), the others sum
template <typename T, typename V, bool CLUSTER>
__global__ void __launch_bounds__(WinTma<T, V>::kThreads) batch_pricing_window_tma_kernel(
    const Args P, const __grid_constant__ CUtensorMap map) {
  using W = WinTma<T, V>;
  using Stage = typename W::Stage;
  constexpr int R = W::kR, ST = kTmaStages, CPT = W::kCpt;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * sizeof(Stage));
  uint64_t* empty = full + ST;
  __shared__ unsigned char basic[kTmaChunk];
  __shared__ Rec<V> red[32];
  const int inst = blockIdx.y;
  const int base = window_lo(P, inst);
  const int lo = base + blockIdx.x * kTmaChunk;
  const int width = min(kTmaChunk, base + P.win - lo);  // a multiple of 16 bytes
  const int m = P.m;
  const int tiles = (m + R - 1) / R;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= W::kConsumers;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const V* y_src = y_of<V>(P) + (size_t)inst * m;
  // tile k's rows into stage k mod ST
  auto fill = [&](int k) {
    Stage& s = st[k % ST];
    uint64_t* bar = &full[k % ST];
    const int r0 = k * R, rows = min(R, m - r0);
    if (lane == 0) {
      mbar_expect_tx(bar, sizeof(s.a) + rows * sizeof(V));
      tensor_copy(&s.a[0][0], &map, lo, r0, inst, bar);
      bulk_copy(s.y, y_src + r0, rows * sizeof(V), bar);
    }
  };
  // the first stages fly while the chunk's basic columns are marked
  if (producer)
    for (int k = 0; k < min(ST, tiles); ++k) fill(k);
  mark_chunk<kTmaChunk>(basic, P.basis + (size_t)inst * m, m, lo);

  Rec<V> rec = rec_none<V>();
  if (producer) {
    for (int k = ST; k < tiles; ++k) {
      mbar_wait(&empty[k % ST], ((k / ST) - 1) & 1);  // tile k - ST consumed
      fill(k);
    }
  } else {
    const int tc = CPT * (int)threadIdx.x;
    const bool in = tc < width;
    V acc[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[q] = V(0);
    for (int k = 0; k < tiles; ++k) {
      const Stage& s = st[k % ST];
      mbar_wait(&full[k % ST], (k / ST) & 1);
      const int rows = min(R, m - k * R);  // a multiple of 4
      if (in) {
#pragma unroll 4
        for (int r = 0; r < rows; r += 4) {
          V yv[4];
          load4v(&s.y[r], yv);
          fma_row(acc, yv[0], s.a[r], tc);
          fma_row(acc, yv[1], s.a[r + 1], tc);
          fma_row(acc, yv[2], s.a[r + 2], tc);
          fma_row(acc, yv[3], s.a[r + 3], tc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k % ST]);
    }
    if (in) {
      const V* ci = c_of<V>(P) + (size_t)inst * P.c_stride;
      const size_t cn = (size_t)inst * P.n + lo + tc;
      const bool up = P.at_upper != nullptr;
  #pragma unroll
      for (int q = 0; q < CPT; ++q)
        rec = merge(rec, column_rec<V>(acc[q], ci[lo + tc + q], up && P.at_upper[cn + q],
                                       basic[tc + q], lo + tc + q, eps_of(P, V())));
    }
  }
  if constexpr (CLUSTER) {
    // the instance's chunks are one cluster: block 0 merges their records
    // in chunk order out of each block's slot
    __shared__ Rec<V> slot;
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    rec = block_merge(rec, red);
    if (threadIdx.x == 0) slot = rec;
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
      Rec<V> r = slot;
      for (unsigned q = 1; q < cluster.num_blocks(); ++q) r = merge(r, *cluster.map_shared_rank(&slot, q));
      choose(r, P.use_bland[inst] != 0, P.p_out, P.min_out, inst, base);
    }
    cluster.sync();  // no block leaves while its slot may be read
  } else {
    finish_chunk(rec, red, P, inst, base);
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's entry
// point query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  return sizeof(T) == 8   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
         : sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_UINT16;
}

template <typename T, typename V>
cudaError_t launch_window_tma(const Args& P, cudaStream_t s) {
  using W = WinTma<T, V>;
  // A as (n, m, B) elements, boxes of one stage's rows of a chunk
  CUtensorMap map{};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)P.n, (cuuint64_t)P.m, (cuuint64_t)P.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)P.n * sizeof(T), (cuuint64_t)P.m * P.n * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)kTmaChunk, (cuuint32_t)W::kR, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  if (encode(&map, tensor_map_type<T>(), 3, const_cast<void*>(P.A), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (P.chunks > kTmaClusterMax) {
    auto kernel = batch_pricing_window_tma_kernel<T, V, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(P.chunks, P.batch), W::kThreads, W::kSmem, s>>>(P, map);
    return cudaGetLastError();
  }
  auto kernel = batch_pricing_window_tma_kernel<T, V, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.chunks, P.batch);
  cfg.blockDim = dim3(W::kThreads);
  cfg.dynamicSmemBytes = W::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, P, map);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- shared A

// block 0 of the grouped window's first launch: the instances sorted by
// window, stably (a counting sort), and the table of instance tiles
template <int TB>
__device__ void group_windows(const Args& P) {
  __shared__ int cnt[kGroupBins], off[kGroupBins], first[kGroupBins];
  __shared__ int total;
  const int lane = threadIdx.x & 31, S = P.win_s, tb = TB;
  for (int s = threadIdx.x; s < S; s += blockDim.x) cnt[s] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < P.batch; i += blockDim.x) atomicAdd(&cnt[window_of(P, i)], 1);
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scans of the counts and of the tiles
    const int per = (S + 31) / 32, s0 = min(S, lane * per), s1 = min(S, s0 + per);
    int n_i = 0, n_t = 0;
    for (int s = s0; s < s1; ++s) {
      n_i += cnt[s];
      n_t += (cnt[s] + tb - 1) / tb;
    }
    int e_i = n_i, e_t = n_t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(kFull, e_i, d), b = __shfl_up_sync(kFull, e_t, d);
      if (lane >= d) {
        e_i += a;
        e_t += b;
      }
    }
    if (lane == 31) total = e_t;
    e_i -= n_i;
    e_t -= n_t;
    for (int s = s0; s < s1; ++s) {
      off[s] = e_i;
      first[s] = e_t;
      e_i += cnt[s];
      e_t += (cnt[s] + tb - 1) / tb;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    P.win_off[s] = off[s];
    for (int q = 0; q * tb < cnt[s]; ++q)
      P.groups[first[s] + q] = Group{s, off[s] + q * tb, min(tb, cnt[s] - q * tb)};
  }
  if (threadIdx.x == 0) P.win_off[S] = P.batch;
  for (int t = total + threadIdx.x; t < P.group_tiles; t += blockDim.x) P.groups[t] = Group{0, 0, 0};
  __syncthreads();
  if (threadIdx.x < 32) {  // the permutation, 32 instances at a time in order
    for (int i0 = 0; i0 < P.batch; i0 += 32) {
      const int i = i0 + lane;
      const int s = i < P.batch ? window_of(P, i) : -1;
      const unsigned same = __match_any_sync(kFull, s);
      const int rank = __popc(same & ((1u << lane) - 1u));
      const int pos = s >= 0 ? off[s] + rank : 0;
      __syncwarp();
      if (s >= 0 && rank == 0) off[s] += __popc(same);
      __syncwarp();
      if (s >= 0) P.perm[pos] = i;
    }
  }
}

// bit j % 32 of word j / 32 of row i: column j is basic in instance i
// (GROUP: block 0 groups the instances by window into tiles of TB, the
// others make the mask)
template <bool GROUP, int TB = kGroupB>
__global__ void __launch_bounds__(kThreads) batch_pricing_mask_kernel(const Args P) {
  if constexpr (GROUP) {
    if (blockIdx.x == 0) {
      group_windows<TB>(P);
      return;
    }
  }
  __shared__ unsigned w[kMaskChunk];
  const int inst = blockIdx.x - (GROUP ? 1 : 0);
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

template <typename T, typename V>
struct Stage {
  static constexpr int kK = tile_k<V>();
  static constexpr int kPad = 16 / (int)sizeof(V);
  // instance-major, rows padded by 16 bytes: the four V a thread reads (4
  // rows of one y) sit in other banks for each of 8 consecutive instances
  V y[kTileB][kK + kPad];
  T a[kK][kTileN];
};

// Fills stages: rows [k0, k0 + K) of the tile's y rows and A columns, by
// the block's threads. VEC: 16-byte copies (m % 4 == 0, n a multiple of 16
// bytes, aligned bases), each thread's sources and bounds worked out once;
// else element loads and stores.
template <typename T, typename V, bool VEC>
struct Loader {
  static constexpr int kK = Stage<T, V>::kK;
  static constexpr int kPer = 16 / sizeof(T);       // elements of A a copy
  static constexpr int kYPer = 16 / sizeof(V);      // elements of y a copy
  static constexpr int kRowCopies = kTileN / kPer;  // copies a row of A's tile
  static constexpr int kYRow = kK / kYPer;                       // copies a row of y's tile
  static constexpr int kY = kTileB * kYRow / kProdThreads;       // copies of y a thread
  static constexpr int kA = kK * kRowCopies / kProdThreads;      // copies of A a thread
  static_assert(kY * kProdThreads == kTileB * kYRow && kA * kProdThreads == kK * kRowCopies,
                "every thread makes the same number of copies");
  const V* ysrc[VEC ? kY : 1];
  const T* asrc[VEC ? kA : 1];
  int yk[VEC ? kY : 1], ak[VEC ? kA : 1];  // the row offset of each copy (past m: out)
  bool yin[VEC ? kY : 1], ain[VEC ? kA : 1];

  __device__ __forceinline__ Loader(const Args& P, const T* A, int b0, int j0) {
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = threadIdx.x + u * kProdThreads, b = b0 + idx / kYRow;
        yk[u] = (idx % kYRow) * kYPer;
        yin[u] = b < P.batch;
        ysrc[u] = y_of<V>(P) + (size_t)(yin[u] ? b : 0) * P.m + yk[u];
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

  __device__ __forceinline__ void load(Stage<T, V>& s, const Args& P, const T* A, int b0,
                                       int j0, int k0) const {
    const int t = threadIdx.x;
    const V* y = y_of<V>(P);
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = t + u * kProdThreads;
        const bool in = yin[u] && k0 + yk[u] < P.m;
        cp_async16(&s.y[idx / kYRow][yk[u]], in ? ysrc[u] + k0 : y, in);
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = t + u * kProdThreads;
        const bool in = ain[u] && k0 + ak[u] < P.m;
        cp_async16(&s.a[ak[u]][(idx % kRowCopies) * kPer], in ? asrc[u] + (size_t)k0 * P.n : A,
                   in);
      }
    } else {
      for (int idx = t; idx < kTileB * kK; idx += kProdThreads) {
        const int bi = idx / kK, kr = idx % kK;
        const int b = b0 + bi, k = k0 + kr;
        s.y[bi][kr] = (b < P.batch && k < P.m) ? y[(size_t)b * P.m + k] : V(0);
      }
      for (int idx = t; idx < kK * kTileN; idx += kProdThreads) {
        const int kr = idx / kTileN, jc = idx % kTileN;
        const int k = k0 + kr, j = j0 + jc;
        s.a[kr][jc] = (k < P.m && j < P.n) ? A[(size_t)k * P.n + j] : T(0);
      }
    }
  }
};

// columns c0 + [0, 4) and c0 + 16 + [0, 4) of one row of the stage
template <typename T, typename V>
__device__ __forceinline__ void load_a8(const T* row, int c0, V (&a)[8]) {
  V lo[4], hi[4];
  load_a4(row, c0, lo);
  load_a4(row, c0 + 16, hi);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    a[h] = lo[h];
    a[4 + h] = hi[h];
  }
}

// grid (column tiles, instance tiles). kTileM rows of y a thread (8 apart)
// and 8 columns: a warp holds 8 x 4 lanes, 32 instances x 32 columns (a
// warp's load of A is 4 distinct 16-byte pieces a row in fp32, of y 8 on 8
// consecutive rows, in distinct banks); the 64 x 128 tile takes 2 x 4 warps.
template <typename T, typename V, bool VEC>
__global__ void __launch_bounds__(kProdThreads) batch_pricing_product_kernel(const Args P) {
  constexpr int kWarpsN = kTileN / 32;
  using S = Stage<T, V>;
  constexpr int K = S::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  S* st = reinterpret_cast<S*>(smem);
  Rec<V>(*red)[kTileB] = reinterpret_cast<Rec<V>(*)[kTileB]>(smem + kStages * sizeof(S));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % kWarpsN, wb = warp / kWarpsN;
  const int lx = lane & 3, ly = lane >> 2;
  const int row0 = wb * 8 * kTileM + ly;  // this thread's y rows: row0 + 8 i
  const int col0 = wn * 32 + lx * 4;  // and columns: col0 + [0, 4), col0 + 16 + [0, 4)
  const int j0 = blockIdx.x * kTileN, b0 = blockIdx.y * kTileB;
  const T* A = static_cast<const T*>(P.A);
  const int k_tiles = (P.m + K - 1) / K;
  const Loader<T, V, VEC> ld(P, A, b0, j0);

  V acc[kTileM][8];
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = V(0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) ld.load(st[s], P, A, b0, j0, s * K);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every thread is done with tile kt - 1
    const int nt = kt + kStages - 1;
    if (nt < k_tiles) ld.load(st[nt % kStages], P, A, b0, j0, nt * K);
    cp_async_commit();
    const S& s = st[kt % kStages];
#pragma unroll
    for (int k4 = 0; k4 < K; k4 += 4) {
      V yv[kTileM][4];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) load4v(&s.y[row0 + 8 * i][k4], yv[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        V a[8];
        load_a8(s.a[k4 + kk], col0, a);
#pragma unroll
        for (int i = 0; i < kTileM; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fma_v(yv[i][kk], a[jj], acc[i][jj]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: each instance's record over the warp's 32 columns (the 4
  // lanes of one ly), then over the tile's 4 warps of columns
#pragma unroll
  for (int i = 0; i < kTileM; ++i) {
    const int b = b0 + row0 + 8 * i;
    Rec<V> rec = rec_none<V>();
    if (b < P.batch) {
      const V* cb = c_of<V>(P) + (size_t)b * P.c_stride;
      const unsigned* mb = P.mask + (size_t)b * P.words;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + col0 + (jj < 4 ? jj : 12 + jj);
        if (j < P.n) {
          const bool up = P.at_upper != nullptr && P.at_upper[(size_t)b * P.n + j];
          const bool basic = (mb[j >> 5] >> (j & 31)) & 1u;
          rec = merge(rec, column_rec<V>(acc[i][jj], cb[j], up, basic, j, eps_of(P, V())));
        }
      }
    }
    // merge is commutative: every lane of the four ends with the same record
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) rec = merge(rec, shfl_xor(rec, off));
    if (lx == 0) red[wn][row0 + 8 * i] = rec;
  }
  __syncthreads();
  if (threadIdx.x < kTileB) {
    const int b = b0 + threadIdx.x;
    Rec<V> rec = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) rec = merge(rec, red[w][threadIdx.x]);
    if (b < P.batch) {
      if (P.chunks == 1)
        choose(rec, P.use_bland[b] != 0, P.p_out, P.min_out, b, 0);
      else
        recs_of<V>(P)[(size_t)b * P.chunks + blockIdx.x] = rec;
    }
  }
}

// one launch of the product: the ring and the records in dynamic shared
// memory (78 KB in fp32, 79 KB in fp64: above the 48 KB a launch gets
// without asking)
template <typename T, typename V, bool VEC>
cudaError_t launch_product(const Args& P, cudaStream_t s) {
  constexpr size_t smem = kStages * sizeof(Stage<T, V>) + (kTileN / 32) * kTileB * sizeof(Rec<V>);
  auto kernel = batch_pricing_product_kernel<T, V, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P.chunks, (P.batch + kTileB - 1) / kTileB);
  kernel<<<grid, kProdThreads, smem, s>>>(P);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- shared A, grouped window

// a stage of the grouped window's ring: K rows of the tile's y rows
// (padded as in Stage) and of its A columns
template <typename T, typename V>
struct GroupStage {
  static constexpr int kK = tile_k<V>();
  V y[kGroupB][kK + 16 / sizeof(V)];
  T a[kK][kGroupN];
};

// Fills the grouped window's stages: y rows gathered through the
// permutation, A's columns [j0, end) of the tile's window; 16-byte copies
// (VEC) or element loads, zeros past count, m and end.
template <typename T, typename V, bool VEC>
struct GroupLoader {
  static constexpr int kK = GroupStage<T, V>::kK;
  static constexpr int kPer = 16 / sizeof(T);                      // elements of A a copy
  static constexpr int kYPer = 16 / sizeof(V);                     // elements of y a copy
  static constexpr int kRowCopies = kGroupN / kPer;                // copies a row of A's tile
  static constexpr int kYRow = kK / kYPer;                         // copies a row of y's tile
  static constexpr int kY = kGroupB * kYRow / kGroupThreads;      // copies of y a thread
  static constexpr int kA = kK * kRowCopies / kGroupThreads;      // copies of A a thread
  static_assert(kY * kGroupThreads == kGroupB * kYRow && kA * kGroupThreads == kK * kRowCopies,
                "every thread makes the same number of copies");
  const V* ysrc[VEC ? kY : 1];
  const T* asrc[VEC ? kA : 1];
  int yk[VEC ? kY : 1], ak[VEC ? kA : 1];
  bool yin[VEC ? kY : 1], ain[VEC ? kA : 1];

  __device__ __forceinline__ GroupLoader(const Args& P, const T* A, const Group& g, int j0,
                                         int end) {
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = threadIdx.x + u * kGroupThreads, bi = idx / kYRow;
        yk[u] = (idx % kYRow) * kYPer;
        yin[u] = bi < g.count;
        ysrc[u] = y_of<V>(P) + (size_t)(yin[u] ? P.perm[g.start + bi] : 0) * P.m + yk[u];
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = threadIdx.x + u * kGroupThreads, j = j0 + (idx % kRowCopies) * kPer;
        ak[u] = idx / kRowCopies;
        ain[u] = j < end;
        asrc[u] = A + (size_t)ak[u] * P.n + (ain[u] ? j : 0);
      }
    }
  }

  __device__ __forceinline__ void load(GroupStage<T, V>& s, const Args& P, const T* A,
                                       const Group& g, int j0, int end, int k0) const {
    const int t = threadIdx.x;
    const V* y = y_of<V>(P);
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = t + u * kGroupThreads;
        const bool in = yin[u] && k0 + yk[u] < P.m;
        cp_async16(&s.y[idx / kYRow][yk[u]], in ? ysrc[u] + k0 : y, in);
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = t + u * kGroupThreads;
        const bool in = ain[u] && k0 + ak[u] < P.m;
        cp_async16(&s.a[ak[u]][(idx % kRowCopies) * kPer], in ? asrc[u] + (size_t)k0 * P.n : A,
                   in);
      }
    } else {
      for (int idx = t; idx < kGroupB * kK; idx += kGroupThreads) {
        const int bi = idx / kK, kr = idx % kK, k = k0 + kr;
        s.y[bi][kr] = (bi < g.count && k < P.m) ? y[(size_t)P.perm[g.start + bi] * P.m + k] : V(0);
      }
      for (int idx = t; idx < kK * kGroupN; idx += kGroupThreads) {
        const int kr = idx / kGroupN, jc = idx % kGroupN;
        const int k = k0 + kr, j = j0 + jc;
        s.a[kr][jc] = (k < P.m && j < end) ? A[(size_t)k * P.n + j] : T(0);
      }
    }
  }
};

// grid (column tiles of the window, instance tiles of the table). A warp:
// lanes 4 (instance groups) x 8 (column groups); a thread kGroupTM
// instances, 4 apart (their 16 bytes of y in distinct banks), x 4 adjacent
// columns (a warp's load of A is 32 consecutive elements).
template <typename T, typename V, bool VEC>
__global__ void __launch_bounds__(kGroupThreads) batch_pricing_group_kernel(const Args P) {
  using S = GroupStage<T, V>;
  constexpr int K = S::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  S* st = reinterpret_cast<S*>(smem);
  const Group g = P.groups[blockIdx.y];
  if (g.count == 0) return;  // a surplus tile: the whole CTA leaves
  const int lo = g.s * P.win, end = lo + P.win;
  const int j0 = lo + (int)blockIdx.x * kGroupN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 4 * kGroupTM + (lane & 3);  // this thread's rows of the tile: row0 + 4 i
  const int col0 = (lane >> 2) * 4;                     // and columns: col0 + [0, 4)
  const T* A = static_cast<const T*>(P.A);
  const int k_tiles = (P.m + K - 1) / K;
  const GroupLoader<T, V, VEC> ld(P, A, g, j0, end);

  V acc[kGroupTM][4];
#pragma unroll
  for (int i = 0; i < kGroupTM; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = V(0);

#pragma unroll
  for (int s = 0; s < kGroupStages - 1; ++s) {
    if (s < k_tiles) ld.load(st[s], P, A, g, j0, end, s * K);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kGroupStages - 2>();
    __syncthreads();  // tile kt has landed; every thread is done with tile kt - 1
    const int nt = kt + kGroupStages - 1;
    if (nt < k_tiles) ld.load(st[nt % kGroupStages], P, A, g, j0, end, nt * K);
    cp_async_commit();
    const S& s = st[kt % kGroupStages];
#pragma unroll
    for (int k4 = 0; k4 < K; k4 += 4) {
      V yv[kGroupTM][4];
#pragma unroll
      for (int i = 0; i < kGroupTM; ++i) load4v(&s.y[row0 + 4 * i][k4], yv[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        V a[4];
        load_a4(s.a[k4 + kk], col0, a);
#pragma unroll
        for (int i = 0; i < kGroupTM; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fma_v(yv[i][kk], a[jj], acc[i][jj]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: each instance's record over the tile's 32 columns (the 8
  // lanes of one instance group); a warp owns its instances' whole rows
#pragma unroll
  for (int i = 0; i < kGroupTM; ++i) {
    const int bi = row0 + 4 * i;
    const int b = bi < g.count ? P.perm[g.start + bi] : 0;
    Rec<V> rec = rec_none<V>();
    if (bi < g.count) {
      const V* cb = c_of<V>(P) + (size_t)b * P.c_stride;
      const unsigned* mb = P.mask + (size_t)b * P.words;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + col0 + jj;
        if (j < end) {
          const bool up = P.at_upper != nullptr && P.at_upper[(size_t)b * P.n + j];
          const bool basic = (mb[j >> 5] >> (j & 31)) & 1u;
          rec = merge(rec, column_rec<V>(acc[i][jj], cb[j], up, basic, j, eps_of(P, V())));
        }
      }
    }
    // merge is commutative: every lane of the eight ends with the same record
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) rec = merge(rec, shfl_xor(rec, off));
    if ((lane >> 2) == 0 && bi < g.count) {
      if (P.chunks == 1)
        choose(rec, P.use_bland[b] != 0, P.p_out, P.min_out, b, lo);
      else
        recs_of<V>(P)[(size_t)b * P.chunks + blockIdx.x] = rec;
    }
  }
}

template <typename T, typename V, bool VEC>
cudaError_t launch_group(const Args& P, cudaStream_t s) {
  constexpr size_t smem = kGroupStages * sizeof(GroupStage<T, V>);
  auto kernel = batch_pricing_group_kernel<T, V, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(P.chunks, P.group_tiles), kGroupThreads, smem, s>>>(P);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float64 on the tensor cores

// D += A B on one m16n8k4 f64 fragment (.row.col): lane 4 g + t holds A's
// rows g and g + 8 at column t, B's column g at row t, and D's rows g, g +
// 8 at columns 2 t, 2 t + 1 (d[0], d[1] and d[2], d[3])
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], const double (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// A CTA tile of the float64 product: TB instances x TN columns, WB x WN
// warps, the ring's stages of kDmmaRows rows
template <int TB, int TN, int WB, int WN, int STAGES>
struct DmmaCfg {
  static constexpr int kTB = TB, kTN = TN, kWN = WN, kStages = STAGES;
  static constexpr int kThreads = 32 * WB * WN;
  static constexpr int kFM = TB / WB / 16, kFN = TN / WN / 8;  // fragments a warp
  static_assert(kFM * 16 * WB == TB && kFN * 8 * WN == TN, "whole fragments a warp");
};
using DmmaProduct = DmmaCfg<128, 64, 4, 2, 3>;  // hopper.py _BP_DMMA_TILE mirrors it
using DmmaGroup = DmmaCfg<32, 64, 2, 4, 4>;  // and _BP_DMMA_GROUP_TILE this
constexpr int kDmmaK = 4;     // rows an mma (hopper.py _BP_DMMA_K mirrors it)
constexpr int kDmmaRows = 32;  // rows of A a stage

// a stage: the tile's y rows (instance-major) and A's rows; each row padded
// so that a fragment's 16 lanes of a phase (4 rows x 4 columns of 8 bytes)
// fall in distinct banks: rows of 36 doubles for y, TN + 4 doubles or TN + 8
// bf16 words for A (the bf16 pairs of a word are read together)
template <typename T, int TB, int TN>
struct DmmaStage {
  static constexpr int kYPad = 4, kAPad = sizeof(T) == 8 ? 4 : 8;
  double y[TB][kDmmaRows + kYPad];
  T a[kDmmaRows][TN + kAPad];
};

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ double widen(uint16_t v) {
  return (double)__uint_as_float((unsigned)v << 16);
}

// One stage's product into a warp's accumulators: kDmmaRows / kDmmaK
// m16n8k4 mma a fragment pair, the k-steps ascending. r0, c0: the warp's
// first row and column of the tile; g, t: the lane's group and place.
template <typename T, class C>
__device__ __forceinline__ void dmma_stage(double (&acc)[C::kFM][C::kFN][4],
                                           const DmmaStage<T, C::kTB, C::kTN>& s, int r0, int c0,
                                           int g, int t) {
  constexpr int FM = C::kFM, FN = C::kFN;
#pragma unroll
  for (int kb = 0; kb < kDmmaRows; kb += kDmmaK) {
    double fa[FM][2], fb[FN][1];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      fa[i][0] = s.y[r0 + 16 * i + g][kb + t];
      fa[i][1] = s.y[r0 + 16 * i + g + 8][kb + t];
    }
#pragma unroll
    for (int jn = 0; jn < FN; ++jn) fb[jn][0] = widen(s.a[kb + t][c0 + 8 * jn + g]);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int jn = 0; jn < FN; ++jn) dmma(acc[i][jn], fa[i], fb[jn]);
  }
}

// The tile a CTA of the float64 product owns: instances perm[start, start +
// count) (perm null: start + i), columns [j0, j0 + TN) below end; lo the
// first column of the window (0 unwindowed). A surplus tile of the grouped
// window has count 0.
struct DmmaTile {
  const int* perm;
  int start, count, lo, end, j0;
};

template <bool GROUP, class C>
__device__ __forceinline__ DmmaTile dmma_tile(const Args& P) {
  DmmaTile d{nullptr, 0, 0, 0, P.n, 0};
  if constexpr (GROUP) {
    const Group g = P.groups[blockIdx.y];
    d = DmmaTile{P.perm, g.start, g.count, g.s * P.win, g.s * P.win + P.win, 0};
  } else {
    d.start = blockIdx.y * C::kTB;
    d.count = min(C::kTB, P.batch - d.start);
  }
  d.j0 = d.lo + (int)blockIdx.x * C::kTN;
  return d;
}

// The masked choice on the accumulators: each of a consumer thread's rows'
// record over its 2 FN columns, then over the 4 lanes of its row, then
// over the tile's WN warps of columns (red, through shared memory; every
// thread of the block calls it, others with consumer false), then the
// choice or the chunk's record.
template <class C>
__device__ __forceinline__ void dmma_epilogue(const Args& P, const double (&acc)[C::kFM][C::kFN][4],
                                              Rec<double> (*red)[C::kTB], const DmmaTile& d,
                                              bool consumer) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wn = warp % C::kWN, r0 = warp / C::kWN * 16 * C::kFM, c0 = wn * 8 * C::kFN;
  if (consumer) {
#pragma unroll
    for (int i = 0; i < C::kFM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + g + 8 * h;
        Rec<double> rec = rec_none<double>();
        if (row < d.count) {
          const int b = d.perm ? d.perm[d.start + row] : d.start + row;
          const double* cb = c_of<double>(P) + (size_t)b * P.c_stride;
          const unsigned* mb = P.mask + (size_t)b * P.words;
#pragma unroll
          for (int jn = 0; jn < C::kFN; ++jn)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int j = d.j0 + c0 + 8 * jn + 2 * t + q;
              if (j < d.end) {
                const bool up = P.at_upper != nullptr && P.at_upper[(size_t)b * P.n + j];
                const bool basic = (mb[j >> 5] >> (j & 31)) & 1u;
                rec = merge(rec, column_rec<double>(acc[i][jn][2 * h + q], cb[j], up, basic, j, P.eps_d));
              }
            }
        }
        // merge is commutative: every lane of the four ends with the same record
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) rec = merge(rec, shfl_xor(rec, off));
        if (t == 0) red[wn][row] = rec;
      }
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < d.count) {
    const int b = d.perm ? d.perm[d.start + threadIdx.x] : d.start + threadIdx.x;
    Rec<double> rec = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < C::kWN; ++w) rec = merge(rec, red[w][threadIdx.x]);
    if (P.chunks == 1)
      choose(rec, P.use_bland[b] != 0, P.p_out, P.min_out, b, d.lo);
    else
      recs_of<double>(P)[(size_t)b * P.chunks + blockIdx.x] = rec;
  }
}

template <class C>
__device__ __forceinline__ void dmma_zero(double (&acc)[C::kFM][C::kFN][4]) {
#pragma unroll
  for (int i = 0; i < C::kFM; ++i)
#pragma unroll
    for (int jn = 0; jn < C::kFN; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.0;
}

// Fills a stage of the ring: rows [k0, k0 + kDmmaRows) of the tile's y
// rows (instance rows of the tile, zeros past count and m) and of A's
// columns [j0, j0 + TN) (zeros past end and m). VEC: 16-byte cp.async
// copies, each thread's sources and bounds worked out once; else element
// loads.
template <typename T, class C, bool VEC>
struct DmmaLoader {
  static constexpr int K = kDmmaRows, kTh = C::kThreads;
  static constexpr int kPer = 16 / sizeof(T);        // elements of A a copy
  static constexpr int kRowCopies = C::kTN / kPer;   // copies a row of A's tile
  static constexpr int kYRow = K / 2;                // copies a row of y's tile
  static constexpr int kY = C::kTB * kYRow / kTh;    // copies of y a thread
  static constexpr int kA = K * kRowCopies / kTh;    // copies of A a thread
  static_assert(kY * kTh == C::kTB * kYRow && kA * kTh == K * kRowCopies,
                "every thread makes the same number of copies");
  const double* ysrc[VEC ? kY : 1];
  const T* asrc[VEC ? kA : 1];
  int yk[VEC ? kY : 1], ak[VEC ? kA : 1];
  bool yin[VEC ? kY : 1], ain[VEC ? kA : 1];

  __device__ __forceinline__ DmmaLoader(const Args& P, const T* A, const DmmaTile& d) {
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = threadIdx.x + u * kTh, bi = idx / kYRow;
        yk[u] = (idx % kYRow) * 2;
        yin[u] = bi < d.count;
        const int b = yin[u] ? (d.perm ? d.perm[d.start + bi] : d.start + bi) : 0;
        ysrc[u] = y_of<double>(P) + (size_t)b * P.m + yk[u];
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = threadIdx.x + u * kTh, j = d.j0 + (idx % kRowCopies) * kPer;
        ak[u] = idx / kRowCopies;
        ain[u] = j < d.end;
        asrc[u] = A + (size_t)ak[u] * P.n + (ain[u] ? j : 0);
      }
    }
  }

  __device__ __forceinline__ void load(DmmaStage<T, C::kTB, C::kTN>& s, const Args& P, const T* A,
                                       const DmmaTile& d, int k0) const {
    const int t = threadIdx.x;
    const double* y = y_of<double>(P);
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < kY; ++u) {
        const int idx = t + u * kTh;
        const bool in = yin[u] && k0 + yk[u] < P.m;
        cp_async16(&s.y[idx / kYRow][yk[u]], in ? ysrc[u] + k0 : y, in);
      }
#pragma unroll
      for (int u = 0; u < kA; ++u) {
        const int idx = t + u * kTh;
        const bool in = ain[u] && k0 + ak[u] < P.m;
        cp_async16(&s.a[ak[u]][(idx % kRowCopies) * kPer], in ? asrc[u] + (size_t)k0 * P.n : A,
                   in);
      }
    } else {
      for (int idx = t; idx < C::kTB * K; idx += kTh) {
        const int bi = idx / K, kr = idx % K, k = k0 + kr;
        const int b = d.perm ? d.perm[d.start + min(bi, d.count - 1)] : d.start + bi;
        s.y[bi][kr] = (bi < d.count && k < P.m) ? y[(size_t)b * P.m + k] : 0.0;
      }
      for (int idx = t; idx < K * C::kTN; idx += kTh) {
        const int kr = idx / C::kTN, jc = idx % C::kTN;
        const int k = k0 + kr, j = d.j0 + jc;
        s.a[kr][jc] = (k < P.m && j < d.end) ? A[(size_t)k * P.n + j] : T(0);
      }
    }
  }
};

// The float64 product Y . A on the FP64 tensor cores with the masked choice
// in its epilogue, fed through a ring of cp.async copies (VEC; layout 5)
// or element loads (layouts 3 and 6). GROUP false: the shared layout,
// grid (column tiles, instance tiles of TB); true: the grouped window,
// grid (column tiles of the window, the table's instance tiles). T:
// double, or uint16_t for the bf16 shadow (widened exactly between shared
// memory and the fragment). Every accumulator starts at 0 and walks the
// rows in ascending steps of kDmmaK from row 0.
template <typename T, bool VEC, bool GROUP, class C>
__global__ void __launch_bounds__(C::kThreads) batch_pricing_dmma_kernel(const Args P) {
  using S = DmmaStage<T, C::kTB, C::kTN>;
  constexpr int K = kDmmaRows;
  extern __shared__ __align__(16) unsigned char smem[];
  S* st = reinterpret_cast<S*>(smem);
  Rec<double>(*red)[C::kTB] =
      reinterpret_cast<Rec<double>(*)[C::kTB]>(smem + C::kStages * sizeof(S));
  const DmmaTile d = dmma_tile<GROUP, C>(P);
  if (d.count == 0) return;  // a surplus tile: the whole CTA leaves
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp / C::kWN * 16 * C::kFM, c0 = warp % C::kWN * 8 * C::kFN;
  const T* A = static_cast<const T*>(P.A);
  const int k_tiles = (P.m + K - 1) / K;
  const DmmaLoader<T, C, VEC> ld(P, A, d);
  double acc[C::kFM][C::kFN][4];
  dmma_zero<C>(acc);
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < k_tiles) ld.load(st[s], P, A, d, s * K);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile kt has landed; every thread is done with tile kt - 1
    const int nt = kt + C::kStages - 1;
    if (nt < k_tiles) ld.load(st[nt % C::kStages], P, A, d, nt * K);
    cp_async_commit();
    dmma_stage<T, C>(acc, st[kt % C::kStages], r0, c0, lane >> 2, lane & 3);
  }
  cp_async_wait<0>();
  dmma_epilogue<C>(P, acc, red, d, true);
}

// The shared product fed by bulk tensor copies (layout 2 in double): a
// producer warp streams the stages into the ring and the consumer warps
// run the mma out of it, a full and an empty mbarrier a stage. A stage is
// one box of y's 2-D tensor map (m, B), 36 columns of TB instances, and one
// of A's (n, m), kDmmaRows rows of TN + kAPad columns: the pad columns
// hold the next tile's values or zeros and are never read; past m, n and B
// the boxes land as zeros.
template <typename T, class C>
__global__ void __launch_bounds__(C::kThreads + 32) batch_pricing_dmma_tma_kernel(
    const Args P, const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap amap) {
  using S = DmmaStage<T, C::kTB, C::kTN>;
  constexpr int K = kDmmaRows, ST = C::kStages, NW = C::kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  S* st = reinterpret_cast<S*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * sizeof(S));
  uint64_t* empty = full + ST;
  Rec<double>(*red)[C::kTB] = reinterpret_cast<Rec<double>(*)[C::kTB]>(empty + ST);
  const DmmaTile d = dmma_tile<false, C>(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_tiles = (P.m + K - 1) / K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    mbar_init_fence();
  }
  __syncthreads();
  double acc[C::kFM][C::kFN][4];
  if (warp == NW) {  // the producer
    if (lane == 0) {
      for (int k = 0; k < k_tiles; ++k) {
        S& s = st[k % ST];
        uint64_t* bar = &full[k % ST];
        if (k >= ST) mbar_wait(&empty[k % ST], ((k / ST) - 1) & 1);  // tile k - ST consumed
        mbar_expect_tx(bar, sizeof(S));
        tensor_copy2(&s.y[0][0], &ymap, k * K, d.start, bar);
        tensor_copy2(&s.a[0][0], &amap, d.j0, k * K, bar);
      }
    }
  } else {
    const int r0 = warp / C::kWN * 16 * C::kFM, c0 = warp % C::kWN * 8 * C::kFN;
    dmma_zero<C>(acc);
    for (int k = 0; k < k_tiles; ++k) {
      mbar_wait(&full[k % ST], (k / ST) & 1);
      dmma_stage<T, C>(acc, st[k % ST], r0, c0, lane >> 2, lane & 3);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[k % ST]);
    }
  }
  dmma_epilogue<C>(P, acc, red, d, warp < NW);
}

// one launch of the float64 product: the ring and the records in dynamic
// shared memory. bulk (the shared layout's 16-byte case): the bulk-copy
// kernel (163 KB with double A, 126 KB with the bf16 shadow); else the
// cp.async ring (VEC, the grouped window's 16-byte case: 106 KB, 55 KB)
// or element loads.
template <typename T, bool VEC, bool GROUP, class C>
cudaError_t launch_dmma(const Args& P, bool bulk, cudaStream_t s) {
  using S = DmmaStage<T, C::kTB, C::kTN>;
  static_assert(sizeof(S::y) % 128 == 0 && sizeof(S) % 128 == 0, "boxes land 128-byte aligned");
  const dim3 grid(P.chunks, GROUP ? P.group_tiles : (P.batch + C::kTB - 1) / C::kTB);
  const size_t recs = C::kWN * C::kTB * sizeof(Rec<double>);
  if (!bulk) {
    const size_t smem = C::kStages * sizeof(S) + recs;
    auto kernel = batch_pricing_dmma_kernel<T, VEC, GROUP, C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, smem, s>>>(P);
    return cudaGetLastError();
  }
  if constexpr (!GROUP) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint32_t one[2] = {1, 1};
    CUtensorMap ymap{}, amap{};
    {  // y as (m, B) doubles, boxes of 36 x TB
      const cuuint64_t dims[2] = {(cuuint64_t)P.m, (cuuint64_t)P.batch};
      const cuuint64_t strides[1] = {(cuuint64_t)P.m * sizeof(double)};
      const cuuint32_t box[2] = {(cuuint32_t)(kDmmaRows + S::kYPad), (cuuint32_t)C::kTB};
      if (encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<void*>(P.y), dims, strides,
                 box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
    {  // A as (n, m), boxes of TN + kAPad x kDmmaRows
      const cuuint64_t dims[2] = {(cuuint64_t)P.n, (cuuint64_t)P.m};
      const cuuint64_t strides[1] = {(cuuint64_t)P.n * sizeof(T)};
      const cuuint32_t box[2] = {(cuuint32_t)(C::kTN + S::kAPad), (cuuint32_t)kDmmaRows};
      if (encode(&amap, tensor_map_type<T>(), 2, const_cast<void*>(P.A), dims, strides, box, one,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    }
    const size_t smem = C::kStages * (sizeof(S) + 2 * sizeof(uint64_t)) + recs;
    auto kernel = batch_pricing_dmma_tma_kernel<T, C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads + 32, smem, s>>>(P, ymap, amap);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- records

template <typename V, bool WIN>
__global__ void __launch_bounds__(kThreads) batch_pricing_reduce_kernel(const Args P) {
  __shared__ Rec<V> red[32];
  const int inst = blockIdx.x;
  const Rec<V>* recs = recs_of<V>(P);
  Rec<V> rec = rec_none<V>();
  for (int k = threadIdx.x; k < P.chunks; k += kThreads)
    rec = merge(rec, recs[(size_t)inst * P.chunks + k]);
  rec = block_merge(rec, red);
  if (threadIdx.x == 0)
    choose(rec, P.use_bland[inst] != 0, P.p_out, P.min_out, inst, WIN ? window_lo(P, inst) : 0);
}

// the group scratch of B instances in S windows: the permutation, the
// windows' offsets, then the tiles
void carve_groups(Args& P, void* group, int batch, int win_s) {
  P.perm = static_cast<int*>(group);
  P.win_off = P.perm + batch;
  P.groups = reinterpret_cast<Group*>(P.win_off + win_s + 1);
}

// the bf16 shadow as the kernels of shared memory keep it: raw 16-bit words
template <typename T>
struct Raw {
  using type = T;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint16_t;
};

// every launch of one call, A's elements T (float, double or
// __nv_bfloat16), the vectors' V
template <typename T, typename V>
cudaError_t run(const Args& P, int layout, cudaStream_t s) {
  using TR = typename Raw<T>::type;
  const bool windowed = P.win > 0;
  const int chunks = P.chunks;
  cudaError_t err = cudaSuccess;
  if (layout == 4) {
    err = launch_window_tma<TR, V>(P, s);
  } else if (layout == 0 || layout == 1) {
    const dim3 grid(chunks, P.batch);
    if (layout == 1) {
      if (windowed)
        batch_pricing_bf16x4_kernel<V, true><<<grid, kChunk / kCols, 0, s>>>(P);
      else
        batch_pricing_bf16x4_kernel<V, false><<<grid, kChunk / kCols, 0, s>>>(P);
    } else if (windowed) {
      batch_pricing_scan_kernel<T, V, true><<<grid, kThreads, 0, s>>>(P);
    } else {
      batch_pricing_scan_kernel<T, V, false><<<grid, kThreads, 0, s>>>(P);
    }
    err = cudaGetLastError();
  } else if (layout == 5 || layout == 6) {
    if constexpr (sizeof(V) == 8) {
      batch_pricing_mask_kernel<true, DmmaGroup::kTB><<<P.batch + 1, kThreads, 0, s>>>(P);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = layout == 5 ? launch_dmma<TR, true, true, DmmaGroup>(P, false, s)
                        : launch_dmma<TR, false, true, DmmaGroup>(P, false, s);
    } else {
      batch_pricing_mask_kernel<true><<<P.batch + 1, kThreads, 0, s>>>(P);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = layout == 5 ? launch_group<TR, V, true>(P, s) : launch_group<TR, V, false>(P, s);
    }
  } else {
    batch_pricing_mask_kernel<false><<<P.batch, kThreads, 0, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if constexpr (sizeof(V) == 8)
      err = launch_dmma<TR, false, false, DmmaProduct>(P, layout == 2, s);
    else
      err = layout == 2 ? launch_product<TR, V, true>(P, s) : launch_product<TR, V, false>(P, s);
  }
  if (err != cudaSuccess || chunks == 1 || (layout == 4 && chunks <= kTmaClusterMax)) return err;
  if (windowed)
    batch_pricing_reduce_kernel<V, true><<<P.batch, kThreads, 0, s>>>(P);
  else
    batch_pricing_reduce_kernel<V, false><<<P.batch, kThreads, 0, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

// layout 0: per-instance A (B, m, n), a column a thread; 1: per-instance
// bf16, four columns a thread (n % 4 == 0, A 8-byte aligned); 2: one shared
// A (m, n), 16-byte copies (m % 4 == 0, n * elem % 16 == 0, y and A 16-byte
// aligned); 3: one shared A, element loads; 4: a per-instance window by
// bulk copies (m % 4 == 0, n * elem and win * elem multiples of 16, y and
// A 16-byte aligned); 5: a shared A's window, instances grouped by window,
// the product on 16-byte copies (layout 2's conditions and win * elem %
// 16 == 0); 6: the same on element loads.
// a_dtype 0: A fp32, 1: bf16, 2: fp64; v_dtype 0: the vectors fp32, 1:
// fp64 (A fp32 with fp32 vectors, fp64 with fp64 ones, bf16 with either).
// y (B, m) V; c (B, n) V, or one (n,) with c_shared; at_upper (B, n) bool
// bytes or null (the unsigned mode); basis (B, m) int32; use_bland (B,)
// bool bytes; eps rounded to V. chunks: records an instance, ceil(span /
// 256) (layouts 0, 1, 4), ceil(n / 128) (2, 3) or ceil(win / 32) (5, 6),
// with fp64 vectors ceil(n / 64) (2, 3) or ceil(win / 64) (5, 6),
// span = win or n; words: ceil(n / 32) (2, 3, 5, 6; else 0). Scratch: mask,
// B * words uint32 (2, 3, 5, 6); recs, B * chunks records of
// simplex_batch_pricing_record_bytes(v_dtype) bytes, aligned to 8 in fp64,
// where chunks > 1; group (5, 6): B + win_s + 1 + 3 * group_tiles int32,
// group_tiles = ceil(B / 16) + win_s - 1 (fp64 vectors: ceil(B / 32) +
// win_s - 1). Outputs: p (B,) int32, min_e (B,)
// V. The window: win = 0 prices every column (0 to 3); win > 0 (0, 1, 4 to
// 6; chunks as above, win * win_s <= n, layout 1 also win % 4 == 0) prices
// [(win_seg[i] mod win_s) * win, + win) of instance i, win_seg (B,) int32;
// a_shared (windowed only): one A (m, n) for every instance (layouts 0 and
// 1 at an instance stride of 0, and 5, 6; at most 1024 windows for 5, 6).
// Returns a cudaError_t; an inconsistent plan is cudaErrorInvalidValue.
extern "C" int simplex_batch_pricing(int layout, int a_dtype, int v_dtype, const void* y,
                                     const void* A, const void* c, const void* at_upper,
                                     const void* basis, const void* use_bland, int batch, int m,
                                     int n, int c_shared, double eps, int chunks, int words,
                                     void* mask, void* recs, void* p, void* min_e, int win,
                                     int win_s, const void* win_seg, int a_shared, void* group,
                                     int group_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grouped = layout == 5 || layout == 6;
  const bool shared = layout == 2 || layout == 3 || grouped;
  const bool windowed = win > 0;
  const bool bf16 = a_dtype == 1;
  const int elem = a_dtype == 0 ? 4 : a_dtype == 1 ? 2 : 8;
  const bool f64 = v_dtype == 1;  // the shared layouts' product on the FP64 tensor cores
  const int group_b = f64 ? DmmaGroup::kTB : kGroupB;  // instances a grouped tile
  const int tile = layout == 4 ? kTmaChunk
                   : grouped   ? (f64 ? DmmaGroup::kTN : kGroupN)
                   : shared    ? (f64 ? DmmaProduct::kTN : kTileN)
                               : kChunk;
  const int span = windowed ? win : n;
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y), aa = reinterpret_cast<uintptr_t>(A);
  const bool copies16 = m % 4 == 0 && (n * elem) % 16 == 0 && ya % 16 == 0 && aa % 16 == 0;
  const bool win16 = (win * elem) % 16 == 0;
  if (layout < 0 || layout > 6 || a_dtype < 0 || a_dtype > 2 || v_dtype < 0 || v_dtype > 1 ||
      (a_dtype == 0 && v_dtype != 0) || (a_dtype == 2 && v_dtype != 1) || batch < 1 || m < 1 ||
      n < 1 || win < 0 || chunks != (span + tile - 1) / tile ||
      words != (shared ? (n + 31) / 32 : 0) ||
      (layout == 1 && (!bf16 || n % kCols != 0 || aa % 8 != 0 ||
                       (windowed && win % kCols != 0))) ||
      ((layout == 2 || layout == 5) && !copies16) || (shared && mask == nullptr) ||
      (chunks > 1 && recs == nullptr && !(layout == 4 && chunks <= kTmaClusterMax)) ||
      (recs != nullptr && reinterpret_cast<uintptr_t>(recs) % (v_dtype == 1 ? 8 : 4) != 0) ||
      (a_shared && !windowed) ||
      ((layout == 2 || layout == 3) && windowed) ||
      (layout == 4 && (!copies16 || !win16 || a_shared)) ||
      (layout == 5 && !win16) ||
      (grouped && (!a_shared || win_s > kGroupBins || group == nullptr ||
                   group_tiles != (batch + group_b - 1) / group_b + win_s - 1)) ||
      (layout >= 4 && !windowed) ||
      (windowed && (win_s < 1 || (long long)win * win_s > n || win_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args P;
  P.y = y;
  P.A = A;
  P.c = c;
  P.at_upper = static_cast<const unsigned char*>(at_upper);
  P.basis = static_cast<const int*>(basis);
  P.use_bland = static_cast<const unsigned char*>(use_bland);
  P.batch = batch;
  P.m = m;
  P.n = n;
  P.c_stride = c_shared ? 0 : (size_t)n;
  P.eps_f = (float)eps;
  P.eps_d = eps;
  P.chunks = chunks;
  P.mask = static_cast<unsigned*>(mask);
  P.words = words;
  P.recs = recs;
  P.p_out = static_cast<int*>(p);
  P.min_out = min_e;
  P.win = win;
  P.win_s = win_s;
  P.win_seg = static_cast<const int*>(win_seg);
  P.a_stride = a_shared ? 0 : (size_t)m * n;
  P.group_tiles = group_tiles;
  if (grouped) carve_groups(P, group, batch, win_s);
  cudaError_t err;
  if (a_dtype == 0)
    err = run<float, float>(P, layout, s);
  else if (a_dtype == 2)
    err = run<double, double>(P, layout, s);
  else if (v_dtype == 0)
    err = run<__nv_bfloat16, float>(P, layout, s);
  else
    err = run<__nv_bfloat16, double>(P, layout, s);
  return (int)err;
}

// The grouped window's first step alone (block 0 of layouts 5 and 6's first
// launch): the instances of seg (B,) int32 sorted by window seg mod win_s
// (at most 1024), stably, into group (B + win_s + 1 + 3 * group_tiles
// int32: the permutation, the windows' offsets, the instance tiles).
extern "C" int simplex_batch_pricing_groups(const void* win_seg, int batch, int win_s,
                                            int group_tiles, void* group, void* stream) {
  if (batch < 1 || win_s < 1 || win_s > kGroupBins || win_seg == nullptr || group == nullptr ||
      group_tiles != (batch + kGroupB - 1) / kGroupB + win_s - 1)
    return (int)cudaErrorInvalidValue;
  Args P{};
  P.batch = batch;
  P.win_s = win_s;
  P.win_seg = static_cast<const int*>(win_seg);
  P.group_tiles = group_tiles;
  carve_groups(P, group, batch, win_s);
  batch_pricing_mask_kernel<true><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// the size of one chunk record with the vectors of v_dtype (0 fp32, 1
// fp64), for the wrapper's scratch
extern "C" int simplex_batch_pricing_record_bytes(int v_dtype) {
  return v_dtype == 1 ? (int)sizeof(Rec<double>) : (int)sizeof(Rec<float>);
}
