// The batched pivot tail: for every instance of a batch, the ratio test,
// the eta vector, the stepped x_b, row q of the true inverse, y, c_b,
// basis and the step's scalars, in one launch.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, ratio_eta /
// _ratio_eta_kernel (the pl.pallas_call at line 323) as
// simplex_tpu/batch/vmapped.py runs it (vmap gives it a batch grid axis),
// with the O(m) selects and scalar updates that simplex_tpu/core/step.py
// pivot_step wraps around it, as csrc/ratio_eta.cu's tail does for one
// instance.
//
// Bound on the H100: the bytes, 4 B (12 m + 12) in all at batch B (each
// input read once, each output written once): 12.8 MB at 4096 x 64, 0.0038
// ms at 3.35 TB/s (the bound chip_smoke.py reports). In practice its time
// is the latency of one instance's chain: load, two reduction rounds, the
// dependent read of row q of B_inv, the stores.
//
// Design. The two reduction rounds are those of ratio_eta.cu, on its
// records (csrc/ratio_cluster.cuh: Pass1, Pass2, the NaN-first minimum,
// lowest index on ties, Bland's smallest basis index): round 1 min theta,
// min relaxed theta, any eligible row; round 2 Harris' largest alpha within
// theta_max, the classic lowest index of the minimum, Bland's. Two paths,
// by m:
//   - warp (m <= 256): one warp an instance, four instances a block. Each
//     lane holds its rows of alpha, x_b and basis in registers, loaded
//     once (float4 / float2 loads where m allows: a lane holds groups of V
//     consecutive rows), and both rounds reduce by warp shuffles alone: no
//     shared memory, no __syncthreads. Row q of B_inv (and the pending
//     pairs' U[:, q], R) is read once q is known.
//   - block (m > 256): one block an instance, one row a thread up to 512
//     rows (a stride loop beyond), each round through shared memory. The
//     warm re-solve's clean-up runs it at m = 2048.
// Every arithmetic step is one IEEE round-to-nearest op in the plain
// version's order (step_scalars, step_row: the same code on both paths), so
// every output equals ops.pivot_tail_batched bit for bit; under deferred
// updates row q adds the pending pairs of its instance in pair order, a
// multiply and an add each, as the plain version does. An instance that is
// not active is copied through unchanged, with a zero eta and row.

#include "ratio_cluster.cuh"

namespace {

using ratio_cluster::kFull;
using ratio_cluster::kIntMax;
using ratio_cluster::nan_min;
using Pass1 = ratio_cluster::Pass1<float>;  // the batched tail runs in fp32 only
using Pass2 = ratio_cluster::Pass2<float>;
using ratio_cluster::pos;
using ratio_cluster::warp_reduce;

constexpr int kTailWarps = 4;        // instances a block on the warp path
constexpr int kBlockThreads = 512;   // the block path's threads a block at most

struct Params {
  const float* x_b;    // (B, m)
  const float* alpha;  // (B, m)
  const int* basis;    // (B, m)
  const float* y;      // (B, m)
  const float* c_b;    // (B, m)
  const float* B_inv;  // (B, m, m)
  float* U;            // (B, L, m) or null
  float* R;            // (B, L, m)
  const int* npend;    // (B,) or null
  int L;
  const float* min_e;  // (B,)
  const float* e_p;
  const float* c_p;
  const int* p;
  const int* iters;
  const int* degen;
  const int* status;
  const unsigned char* active;
  int m;
  float eps, pivot_tol, feas_tol, degen_tol;
  int harris, bland_after;
  int st_running, st_optimal, st_unbounded, st_singular;
  // outputs (B, m) and (B,)
  float* eta;
  float* row_out;
  float* x_b_out;
  float* y_out;
  float* c_b_out;
  int* basis_out;
  int* scal;             // (6, B): q, theta bits, iters, status, degen, npend
  unsigned char* flags;  // (4, B): optimal, unbounded, bad, take
  int batch;
};

enum { kQ = 0, kTheta, kIters, kStatus, kDegen, kNpend };
enum { kOptimal = 0, kUnbounded, kBad, kTake };

// ------------------------------------------------------------ shared steps

__device__ __forceinline__ bool use_bland(const Params& P, int degen) {
  return P.bland_after > 0 && degen >= P.bland_after;
}

// round 1's contribution of one row
__device__ __forceinline__ void pass1_row(const Params& P, Pass1& r1, float a, float x) {
  if (a > P.pivot_tol) {
    const float xp = pos(x);
    r1.tmin = nan_min(r1.tmin, __fdiv_rn(xp, a));
    r1.trel = nan_min(r1.trel, __fdiv_rn(__fadd_rn(xp, P.feas_tol), a));
    r1.any = 1;
  }
}

// round 2's contribution of row r
__device__ __forceinline__ void pass2_row(const Params& P, Pass2& r2, float tmin, float tmax,
                                          float a, float x, int bas, int r) {
  const bool mk = a > P.pivot_tol;
  const float theta = mk ? __fdiv_rn(pos(x), a) : INFINITY;
  if (mk && theta <= tmax) r2.harris(a, r);
  if ((theta == tmin || (isnan(tmin) && isnan(theta))) && r < r2.c_row) r2.c_row = r;
  if (theta == tmin) r2.bland(bas, r);
}

// what the step decides for instance i once both rounds are reduced
struct Step {
  int q, np, degen;
  float theta_q, inv_live, th, y_scale;
  bool optimal, unbounded, bad, go;
};

__device__ __forceinline__ Step step_scalars(const Params& P, int i, const Pass1& r1,
                                             const Pass2& r2, int degen) {
  const bool bland = use_bland(P, degen);
  const size_t off = (size_t)i * P.m;
  Step S;
  S.degen = degen;
  S.unbounded = r1.any == 0;
  int q = bland ? r2.b_row : (P.harris ? r2.h_row : r2.c_row);
  if (q == kIntMax) q = 0;
  S.q = q;
  const float a_q = P.alpha[off + q];
  const float theta_at_q = a_q > P.pivot_tol ? __fdiv_rn(pos(P.x_b[off + q]), a_q) : INFINITY;
  S.theta_q = S.unbounded ? INFINITY : (bland ? r1.tmin : theta_at_q);
  const float min_e = P.min_e[i];
  S.optimal = min_e >= -P.eps;
  const bool take0 = !S.optimal && !S.unbounded;
  S.bad = !isfinite(min_e) || (take0 && !isfinite(S.theta_q));
  S.go = take0 && !S.bad;
  // eta and x_b_new as ratio_eta computes them (live: a finite step)
  const bool live = !S.unbounded && isfinite(S.theta_q);
  S.inv_live = __fdiv_rn(1.f, live ? a_q : 1.f);
  S.th = live ? S.theta_q : 0.f;
  const float inv = __fdiv_rn(1.f, S.go ? a_q : 1.f);
  S.y_scale = __fmul_rn(P.e_p[i], inv);
  S.np = P.npend != nullptr ? P.npend[i] : 0;
  return S;
}

// row r of row q of the true inverse: B_inv[q, r] plus the pending pairs
__device__ __forceinline__ float true_row(const Params& P, const Step& S, int i, int r,
                                          float b_qr) {
  if (P.U != nullptr) {
    const float* Ui = P.U + (size_t)i * P.L * P.m;
    const float* Ri = P.R + (size_t)i * P.L * P.m;
    for (int k = 0; k < S.np; ++k)
      b_qr = __fadd_rn(b_qr, __fmul_rn(Ui[(size_t)k * P.m + S.q], Ri[(size_t)k * P.m + r]));
  }
  return b_qr;
}

struct Row {
  float eta, row, x, y, c_b;
  int basis;
};

// the outputs of row r; in: its alpha, x_b, basis, y, c_b and true-inverse entry
__device__ __forceinline__ Row step_row(const Params& P, const Step& S, int i, int r, float a,
                                        float x, int bas, float y, float c_b, float row) {
  if (!S.go) return Row{0.f, 0.f, x, y, c_b, bas};
  const bool at_q = r == S.q;
  return Row{at_q ? __fsub_rn(S.inv_live, 1.f) : __fmul_rn(-a, S.inv_live), row,
             at_q ? S.th : __fsub_rn(x, __fmul_rn(S.th, a)),
             __fsub_rn(y, __fmul_rn(S.y_scale, row)), at_q ? P.c_p[i] : c_b,
             at_q ? P.p[i] : bas};
}

__device__ __forceinline__ void write_scalars(const Params& P, int i, const Step& S) {
  const int B = P.batch;
  const float th_step = S.go ? S.theta_q : 0.f;
  P.scal[kQ * B + i] = S.q;
  P.scal[kTheta * B + i] = __float_as_int(S.theta_q);
  P.scal[kIters * B + i] = P.iters[i] + (S.go ? 1 : 0);
  P.scal[kStatus * B + i] = S.optimal ? P.st_optimal
                            : S.unbounded ? P.st_unbounded
                            : S.bad ? P.st_singular : P.st_running;
  P.scal[kDegen * B + i] = S.go ? (th_step <= P.degen_tol ? S.degen + 1 : 0) : S.degen;
  P.scal[kNpend * B + i] = S.np + (S.go && P.U != nullptr ? 1 : 0);
  P.flags[kOptimal * B + i] = S.optimal;
  P.flags[kUnbounded * B + i] = S.unbounded;
  P.flags[kBad * B + i] = S.bad;
  P.flags[kTake * B + i] = S.go;
}

__device__ __forceinline__ void write_inactive_scalars(const Params& P, int i) {
  const int B = P.batch;
  P.scal[kQ * B + i] = 0;
  P.scal[kTheta * B + i] = 0;
  P.scal[kIters * B + i] = P.iters[i];
  P.scal[kStatus * B + i] = P.status[i];
  P.scal[kDegen * B + i] = P.degen[i];
  P.scal[kNpend * B + i] = P.npend != nullptr ? P.npend[i] : 0;
  for (int f = 0; f < 4; ++f) P.flags[f * B + i] = 0;
}

// ------------------------------------------------------------ block path

template <typename T>
__device__ T block_reduce(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : T::identity();
    v = warp_reduce(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const T out = red[32];
  __syncthreads();  // red is reused by the next round
  return out;
}

// at most kBlockThreads a block and two blocks an SM (64 registers a
// thread): the warm re-solve's 256 instances of 2048 rows run in one wave
__global__ void __launch_bounds__(kBlockThreads, 2) batch_tail_block_kernel(const Params P) {
  __shared__ Pass1 red1[33];
  __shared__ Pass2 red2[33];
  const int i = blockIdx.x;
  const int m = P.m;
  const size_t off = (size_t)i * m;
  const float* x_b = P.x_b + off;
  const float* alpha = P.alpha + off;
  const int* basis = P.basis + off;

  if (!P.active[i]) {
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      P.eta[off + r] = 0.f;
      P.row_out[off + r] = 0.f;
      P.x_b_out[off + r] = x_b[r];
      P.y_out[off + r] = P.y[off + r];
      P.c_b_out[off + r] = P.c_b[off + r];
      P.basis_out[off + r] = basis[r];
    }
    if (threadIdx.x == 0) write_inactive_scalars(P, i);
    return;
  }

  Pass1 r1 = Pass1::identity();
  for (int r = threadIdx.x; r < m; r += blockDim.x) pass1_row(P, r1, alpha[r], x_b[r]);
  r1 = block_reduce(r1, red1);

  Pass2 r2 = Pass2::identity();
  for (int r = threadIdx.x; r < m; r += blockDim.x)
    pass2_row(P, r2, r1.tmin, r1.trel, alpha[r], x_b[r], basis[r], r);
  r2 = block_reduce(r2, red2);

  const Step S = step_scalars(P, i, r1, r2, P.degen[i]);
  const float* Bq = P.B_inv + (size_t)i * m * m + (size_t)S.q * m;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const Row o = step_row(P, S, i, r, alpha[r], x_b[r], basis[r], P.y[off + r],
                           P.c_b[off + r], true_row(P, S, i, r, Bq[r]));
    P.eta[off + r] = o.eta;
    P.row_out[off + r] = o.row;
    P.x_b_out[off + r] = o.x;
    P.y_out[off + r] = o.y;
    P.c_b_out[off + r] = o.c_b;
    P.basis_out[off + r] = o.basis;
  }
  if (S.go && P.U != nullptr) {
    // the new pair goes into slot npend of this instance (read above by
    // every thread, before any write: the slot is past the pending pairs)
    float* Us = P.U + ((size_t)i * P.L + S.np) * m;
    float* Rs = P.R + ((size_t)i * P.L + S.np) * m;
    __syncthreads();
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      Us[r] = P.eta[off + r];
      Rs[r] = P.row_out[off + r];
    }
  }
  if (threadIdx.x == 0) write_scalars(P, i, S);
}

// ------------------------------------------------------------ warp path

// V consecutive 32-bit words at p (aligned to 4 V bytes)
template <int V>
__device__ __forceinline__ void ld(const void* p, unsigned* v) {
  if constexpr (V == 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (V == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

template <int V>
__device__ __forceinline__ void st(void* p, const unsigned* v) {
  if constexpr (V == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  else
    *reinterpret_cast<unsigned*>(p) = v[0];
}

// every lane gets lane 0's record
__device__ __forceinline__ Pass1 broadcast(Pass1 v) {
  return Pass1{__shfl_sync(kFull, v.tmin, 0), __shfl_sync(kFull, v.trel, 0),
               __shfl_sync(kFull, v.any, 0)};
}
__device__ __forceinline__ Pass2 broadcast(Pass2 v) {
  return Pass2{__shfl_sync(kFull, v.h_alpha, 0), __shfl_sync(kFull, v.h_row, 0),
               __shfl_sync(kFull, v.c_row, 0), __shfl_sync(kFull, v.b_basis, 0),
               __shfl_sync(kFull, v.b_row, 0)};
}

// RPL rows a lane, in RPL / V groups of V consecutive rows: group g of lane
// l starts at row (g * 32 + l) * V. m <= 32 * RPL; V > 1 needs m % V == 0.
template <int RPL, int V>
__global__ void __launch_bounds__(32 * kTailWarps) batch_tail_warp_kernel(const Params P) {
  constexpr int G = RPL / V;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kTailWarps + (threadIdx.x >> 5);
  if (i >= P.batch) return;  // the whole warp
  const int m = P.m;
  const size_t off = (size_t)i * m;
  const unsigned zero[V] = {};

  if (!P.active[i]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r0 = (g * 32 + lane) * V;
      if (r0 < m) {
        unsigned v[V];
        ld<V>(P.x_b + off + r0, v);
        st<V>(P.x_b_out + off + r0, v);
        ld<V>(P.y + off + r0, v);
        st<V>(P.y_out + off + r0, v);
        ld<V>(P.c_b + off + r0, v);
        st<V>(P.c_b_out + off + r0, v);
        ld<V>(P.basis + off + r0, v);
        st<V>(P.basis_out + off + r0, v);
        st<V>(P.eta + off + r0, zero);
        st<V>(P.row_out + off + r0, zero);
      }
    }
    if (lane == 0) write_inactive_scalars(P, i);
    return;
  }

  // this lane's rows, loaded once
  unsigned a[RPL], x[RPL], bas[RPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
    if (r0 < m) {
      ld<V>(P.alpha + off + r0, a + g * V);
      ld<V>(P.x_b + off + r0, x + g * V);
      ld<V>(P.basis + off + r0, bas + g * V);
    }
  }

  Pass1 r1 = Pass1::identity();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (r0 + v < m)
        pass1_row(P, r1, __uint_as_float(a[g * V + v]), __uint_as_float(x[g * V + v]));
  }
  r1 = broadcast(warp_reduce(r1));

  Pass2 r2 = Pass2::identity();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (r0 + v < m)
        pass2_row(P, r2, r1.tmin, r1.trel, __uint_as_float(a[g * V + v]),
                  __uint_as_float(x[g * V + v]), (int)bas[g * V + v], r0 + v);
  }
  r2 = broadcast(warp_reduce(r2));

  const Step S = step_scalars(P, i, r1, r2, P.degen[i]);
  const float* Bq = P.B_inv + (size_t)i * m * m + (size_t)S.q * m;
  unsigned eta[RPL], row[RPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
    if (r0 < m) {
      unsigned bq[V], yv[V], cb[V], xo[V], yo[V], co[V], bo[V];
      ld<V>(Bq + r0, bq);
      ld<V>(P.y + off + r0, yv);
      ld<V>(P.c_b + off + r0, cb);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = g * V + v;
        const Row o = step_row(P, S, i, r0 + v, __uint_as_float(a[k]), __uint_as_float(x[k]),
                               (int)bas[k], __uint_as_float(yv[v]), __uint_as_float(cb[v]),
                               true_row(P, S, i, r0 + v, __uint_as_float(bq[v])));
        eta[k] = __float_as_uint(o.eta);
        row[k] = __float_as_uint(o.row);
        xo[v] = __float_as_uint(o.x);
        yo[v] = __float_as_uint(o.y);
        co[v] = __float_as_uint(o.c_b);
        bo[v] = (unsigned)o.basis;
      }
      st<V>(P.eta + off + r0, eta + g * V);
      st<V>(P.row_out + off + r0, row + g * V);
      st<V>(P.x_b_out + off + r0, xo);
      st<V>(P.y_out + off + r0, yo);
      st<V>(P.c_b_out + off + r0, co);
      st<V>(P.basis_out + off + r0, bo);
    }
  }
  if (S.go && P.U != nullptr) {
    // the new pair goes into slot npend of this instance, after every lane
    // has read the pending pairs (the slot is past them)
    __syncwarp();
    float* Us = P.U + ((size_t)i * P.L + S.np) * m;
    float* Rs = P.R + ((size_t)i * P.L + S.np) * m;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r0 = (g * 32 + lane) * V;
      if (r0 < m) {
        st<V>(Us + r0, eta + g * V);
        st<V>(Rs + r0, row + g * V);
      }
    }
  }
  if (lane == 0) write_scalars(P, i, S);
}

template <int RPL, int V>
int launch_warp(const Params& P, cudaStream_t s) {
  const int blocks = (P.batch + kTailWarps - 1) / kTailWarps;
  batch_tail_warp_kernel<RPL, V><<<blocks, 32 * kTailWarps, 0, s>>>(P);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

}  // namespace

// Vectors (B, m) fp32 (basis int32), B_inv (B, m, m) fp32; U, R (B, L, m)
// fp32 and npend (B,) int32, or null under eager updates; per-instance
// scalars (B,): min_e, e_p, c_p fp32, p, iters, degen, status int32,
// active bool bytes. The path: rows_per_lane 0, the block path with
// `threads` (a multiple of 32 up to 512) a block; else the warp path,
// rows_per_lane in {1, 2, 4, 8} (m <= 32 * rows_per_lane), vec in {1,
// min(rows_per_lane, 4)} (vec > 1: m % vec == 0 and every pointer aligned
// to 4 vec bytes), threads = 128. Outputs: eta, row, x_b, y, c_b (B, m)
// fp32, basis (B, m) int32, scal (6, B) int32 (q, theta_q's bits, iters,
// status, degen, npend), flags (4, B) bytes (optimal, unbounded, bad,
// take). No output overlaps an input. Returns a cudaError_t; an
// inconsistent plan is cudaErrorInvalidValue.
extern "C" int simplex_batch_tail(
    const void* x_b, const void* alpha, const void* basis, const void* y,
    const void* c_b, const void* B_inv, void* U, void* R, const void* npend,
    int L, const void* min_e, const void* e_p, const void* c_p, const void* p,
    const void* iters, const void* degen, const void* status, const void* active,
    int batch, int m, float eps, float pivot_tol, float feas_tol, float degen_tol,
    int harris, int bland_after, int st_running, int st_optimal, int st_unbounded,
    int st_singular, int threads, int rows_per_lane, int vec, void* eta, void* row,
    void* x_b_out, void* y_out, void* c_b_out, void* basis_out, void* scal, void* flags,
    void* stream) {
  Params P = {};
  P.x_b = static_cast<const float*>(x_b);
  P.alpha = static_cast<const float*>(alpha);
  P.basis = static_cast<const int*>(basis);
  P.y = static_cast<const float*>(y);
  P.c_b = static_cast<const float*>(c_b);
  P.B_inv = static_cast<const float*>(B_inv);
  P.U = static_cast<float*>(U);
  P.R = static_cast<float*>(R);
  P.npend = static_cast<const int*>(npend);
  P.L = L;
  P.min_e = static_cast<const float*>(min_e);
  P.e_p = static_cast<const float*>(e_p);
  P.c_p = static_cast<const float*>(c_p);
  P.p = static_cast<const int*>(p);
  P.iters = static_cast<const int*>(iters);
  P.degen = static_cast<const int*>(degen);
  P.status = static_cast<const int*>(status);
  P.active = static_cast<const unsigned char*>(active);
  P.m = m;
  P.eps = eps;
  P.pivot_tol = pivot_tol;
  P.feas_tol = feas_tol;
  P.degen_tol = degen_tol;
  P.harris = harris;
  P.bland_after = bland_after;
  P.st_running = st_running;
  P.st_optimal = st_optimal;
  P.st_unbounded = st_unbounded;
  P.st_singular = st_singular;
  P.eta = static_cast<float*>(eta);
  P.row_out = static_cast<float*>(row);
  P.x_b_out = static_cast<float*>(x_b_out);
  P.y_out = static_cast<float*>(y_out);
  P.c_b_out = static_cast<float*>(c_b_out);
  P.basis_out = static_cast<int*>(basis_out);
  P.scal = static_cast<int*>(scal);
  P.flags = static_cast<unsigned char*>(flags);
  P.batch = batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || m < 1) return (int)cudaErrorInvalidValue;
  if (rows_per_lane == 0) {
    if (threads < 32 || threads > kBlockThreads || threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    batch_tail_block_kernel<<<batch, threads, 0, s>>>(P);
    return (int)cudaGetLastError();
  }
  const int bytes = 4 * vec;
  const void* vecs[] = {x_b, alpha, basis, y, c_b, B_inv, U, R, eta, row, x_b_out, y_out,
                        c_b_out, basis_out};
  bool ok = threads == 32 * kTailWarps && m <= 32 * rows_per_lane &&
            (vec == 1 || (vec == (rows_per_lane < 4 ? rows_per_lane : 4) && m % vec == 0));
  for (const void* v : vecs) ok = ok && aligned(v, bytes);
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (rows_per_lane * 10 + vec) {
    case 11: return launch_warp<1, 1>(P, s);
    case 21: return launch_warp<2, 1>(P, s);
    case 22: return launch_warp<2, 2>(P, s);
    case 41: return launch_warp<4, 1>(P, s);
    case 44: return launch_warp<4, 4>(P, s);
    case 81: return launch_warp<8, 1>(P, s);
    case 84: return launch_warp<8, 4>(P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
