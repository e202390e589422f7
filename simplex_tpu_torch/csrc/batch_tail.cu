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
// Bound on the H100: the bytes, sizeof(T) (12 m + 12) in all at batch B
// (each input read once, each output written once): 12.8 MB at 4096 x 64
// in fp32 (0.0038 ms at 3.35 TB/s, the bound chip_smoke.py reports), 25.6
// MB in fp64. In practice its time is the latency of one instance's chain:
// load, two reduction rounds, the dependent read of row q of B_inv, the
// stores.
//
// Design. The two reduction rounds are those of ratio_eta.cu, on its
// records (csrc/ratio_cluster.cuh: Pass1, Pass2, the NaN-first minimum,
// lowest index on ties, Bland's smallest basis index): round 1 min theta,
// min relaxed theta, any eligible row; round 2 Harris' largest alpha within
// theta_max, the classic lowest index of the minimum, Bland's. Two paths,
// by m:
//   - warp (m <= 256): one warp an instance, four instances a block. Each
//     lane holds its rows of alpha, x_b and basis in registers, loaded
//     once (vector loads where m allows: a lane holds groups of V
//     consecutive rows, a float4 / float2 in fp32, one or two double2 in
//     fp64), and both rounds reduce by warp shuffles alone: no shared
//     memory, no __syncthreads. Row q of B_inv (and the pending pairs'
//     U[:, q], R) is read once q is known.
//   - block (m > 256): one block an instance, one row a thread up to 512
//     rows (a stride loop beyond), each round through shared memory. The
//     warm re-solve's clean-up runs it at m = 2048.
// The element type T is float or double (a dtype code picks the
// instantiation); the tolerances arrive as doubles and are rounded to T
// once, as torch rounds a Python float that it compares with a T tensor.
// Every arithmetic step is one IEEE round-to-nearest op in the plain
// version's order (step_scalars, step_row: the same code on both paths), so
// every output equals ops.pivot_tail_batched bit for bit; under deferred
// updates row q adds the pending pairs of its instance in pair order, a
// multiply and an add each, as the plain version does. An instance that is
// not active is copied through unchanged, with a zero eta and row.

#include "ratio_cluster.cuh"

namespace {

using ratio_cluster::add_rn;
using ratio_cluster::div_rn;
using ratio_cluster::kFull;
using ratio_cluster::kIntMax;
using ratio_cluster::mul_rn;
using ratio_cluster::nan_min;
using ratio_cluster::Pass1;
using ratio_cluster::Pass2;
using ratio_cluster::pos;
using ratio_cluster::sub_rn;
using ratio_cluster::warp_reduce;

constexpr int kTailWarps = 4;        // instances a block on the warp path
constexpr int kBlockThreads = 512;   // the block path's threads a block at most

template <typename T>
struct Params {
  const T* x_b;    // (B, m)
  const T* alpha;  // (B, m)
  const int* basis;  // (B, m)
  const T* y;      // (B, m)
  const T* c_b;    // (B, m)
  const T* B_inv;  // (B, m, m)
  T* U;            // (B, L, m) or null
  T* R;            // (B, L, m)
  const int* npend;  // (B,) or null
  int L;
  const T* min_e;  // (B,)
  const T* e_p;
  const T* c_p;
  const int* p;
  const int* iters;
  const int* degen;
  const int* status;
  const unsigned char* active;
  int m;
  T eps, pivot_tol, feas_tol, degen_tol;
  int harris, bland_after;
  int st_running, st_optimal, st_unbounded, st_singular;
  // outputs (B, m) and (B,)
  T* eta;
  T* row_out;
  T* x_b_out;
  T* y_out;
  T* c_b_out;
  int* basis_out;
  int* scal;             // (6, B): q, (theta), iters, status, degen, npend
  T* theta;              // (B,): theta_q
  unsigned char* flags;  // (4, B): optimal, unbounded, bad, take
  int batch;
};

enum { kQ = 0, kTheta, kIters, kStatus, kDegen, kNpend };
enum { kOptimal = 0, kUnbounded, kBad, kTake };

// ------------------------------------------------------------ shared steps

template <typename T>
__device__ __forceinline__ bool use_bland(const Params<T>& P, int degen) {
  return P.bland_after > 0 && degen >= P.bland_after;
}

// round 1's contribution of one row
template <typename T>
__device__ __forceinline__ void pass1_row(const Params<T>& P, Pass1<T>& r1, T a, T x) {
  if (a > P.pivot_tol) {
    const T xp = pos(x);
    r1.tmin = nan_min(r1.tmin, div_rn(xp, a));
    r1.trel = nan_min(r1.trel, div_rn(add_rn(xp, P.feas_tol), a));
    r1.any = 1;
  }
}

// round 2's contribution of row r
template <typename T>
__device__ __forceinline__ void pass2_row(const Params<T>& P, Pass2<T>& r2, T tmin, T tmax, T a,
                                          T x, int bas, int r) {
  const bool mk = a > P.pivot_tol;
  const T theta = mk ? div_rn(pos(x), a) : T(INFINITY);
  if (mk && theta <= tmax) r2.harris(a, r);
  if ((theta == tmin || (isnan(tmin) && isnan(theta))) && r < r2.c_row) r2.c_row = r;
  if (theta == tmin) r2.bland(bas, r);
}

// what the step decides for instance i once both rounds are reduced
template <typename T>
struct Step {
  int q, np, degen;
  T theta_q, inv_live, th, y_scale;
  bool optimal, unbounded, bad, go;
};

template <typename T>
__device__ __forceinline__ Step<T> step_scalars(const Params<T>& P, int i, const Pass1<T>& r1,
                                                const Pass2<T>& r2, int degen) {
  const bool bland = use_bland(P, degen);
  const size_t off = (size_t)i * P.m;
  Step<T> S;
  S.degen = degen;
  S.unbounded = r1.any == 0;
  int q = bland ? r2.b_row : (P.harris ? r2.h_row : r2.c_row);
  if (q == kIntMax) q = 0;
  S.q = q;
  const T a_q = P.alpha[off + q];
  const T theta_at_q = a_q > P.pivot_tol ? div_rn(pos(P.x_b[off + q]), a_q) : T(INFINITY);
  S.theta_q = S.unbounded ? T(INFINITY) : (bland ? r1.tmin : theta_at_q);
  const T min_e = P.min_e[i];
  S.optimal = min_e >= -P.eps;
  const bool take0 = !S.optimal && !S.unbounded;
  S.bad = !isfinite(min_e) || (take0 && !isfinite(S.theta_q));
  S.go = take0 && !S.bad;
  // eta and x_b_new as ratio_eta computes them (live: a finite step)
  const bool live = !S.unbounded && isfinite(S.theta_q);
  S.inv_live = div_rn(T(1), live ? a_q : T(1));
  S.th = live ? S.theta_q : T(0);
  const T inv = div_rn(T(1), S.go ? a_q : T(1));
  S.y_scale = mul_rn(P.e_p[i], inv);
  S.np = P.npend != nullptr ? P.npend[i] : 0;
  return S;
}

// row r of row q of the true inverse: B_inv[q, r] plus the pending pairs
template <typename T>
__device__ __forceinline__ T true_row(const Params<T>& P, const Step<T>& S, int i, int r, T b_qr) {
  if (P.U != nullptr) {
    const T* Ui = P.U + (size_t)i * P.L * P.m;
    const T* Ri = P.R + (size_t)i * P.L * P.m;
    for (int k = 0; k < S.np; ++k)
      b_qr = add_rn(b_qr, mul_rn(Ui[(size_t)k * P.m + S.q], Ri[(size_t)k * P.m + r]));
  }
  return b_qr;
}

template <typename T>
struct Row {
  T eta, row, x, y, c_b;
  int basis;
};

// the outputs of row r; in: its alpha, x_b, basis, y, c_b and true-inverse entry
template <typename T>
__device__ __forceinline__ Row<T> step_row(const Params<T>& P, const Step<T>& S, int i, int r, T a,
                                           T x, int bas, T y, T c_b, T row) {
  if (!S.go) return Row<T>{T(0), T(0), x, y, c_b, bas};
  const bool at_q = r == S.q;
  return Row<T>{at_q ? sub_rn(S.inv_live, T(1)) : mul_rn(-a, S.inv_live), row,
                at_q ? S.th : sub_rn(x, mul_rn(S.th, a)),
                sub_rn(y, mul_rn(S.y_scale, row)), at_q ? P.c_p[i] : c_b,
                at_q ? P.p[i] : bas};
}

template <typename T>
__device__ __forceinline__ void write_scalars(const Params<T>& P, int i, const Step<T>& S) {
  const int B = P.batch;
  const T th_step = S.go ? S.theta_q : T(0);
  P.scal[kQ * B + i] = S.q;
  P.theta[i] = S.theta_q;
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

template <typename T>
__device__ __forceinline__ void write_inactive_scalars(const Params<T>& P, int i) {
  const int B = P.batch;
  P.scal[kQ * B + i] = 0;
  P.theta[i] = T(0);
  P.scal[kIters * B + i] = P.iters[i];
  P.scal[kStatus * B + i] = P.status[i];
  P.scal[kDegen * B + i] = P.degen[i];
  P.scal[kNpend * B + i] = P.npend != nullptr ? P.npend[i] : 0;
  for (int f = 0; f < 4; ++f) P.flags[f * B + i] = 0;
}

// ------------------------------------------------------------ block path

template <typename R>
__device__ R block_reduce(R v, R* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : R::identity();
    v = warp_reduce(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const R out = red[32];
  __syncthreads();  // red is reused by the next round
  return out;
}

// at most kBlockThreads a block; in fp32 two blocks an SM (64 registers a
// thread: the warm re-solve's 256 instances of 2048 rows run in one wave),
// in fp64 one, so that the doubles do not spill
template <typename T>
__global__ void __launch_bounds__(kBlockThreads, sizeof(T) == 4 ? 2 : 1)
batch_tail_block_kernel(const Params<T> P) {
  __shared__ Pass1<T> red1[33];
  __shared__ Pass2<T> red2[33];
  const int i = blockIdx.x;
  const int m = P.m;
  const size_t off = (size_t)i * m;
  const T* x_b = P.x_b + off;
  const T* alpha = P.alpha + off;
  const int* basis = P.basis + off;

  if (!P.active[i]) {
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      P.eta[off + r] = T(0);
      P.row_out[off + r] = T(0);
      P.x_b_out[off + r] = x_b[r];
      P.y_out[off + r] = P.y[off + r];
      P.c_b_out[off + r] = P.c_b[off + r];
      P.basis_out[off + r] = basis[r];
    }
    if (threadIdx.x == 0) write_inactive_scalars(P, i);
    return;
  }

  Pass1<T> r1 = Pass1<T>::identity();
  for (int r = threadIdx.x; r < m; r += blockDim.x) pass1_row(P, r1, alpha[r], x_b[r]);
  r1 = block_reduce(r1, red1);

  Pass2<T> r2 = Pass2<T>::identity();
  for (int r = threadIdx.x; r < m; r += blockDim.x)
    pass2_row(P, r2, r1.tmin, r1.trel, alpha[r], x_b[r], basis[r], r);
  r2 = block_reduce(r2, red2);

  const Step<T> S = step_scalars(P, i, r1, r2, P.degen[i]);
  const T* Bq = P.B_inv + (size_t)i * m * m + (size_t)S.q * m;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const Row<T> o = step_row(P, S, i, r, alpha[r], x_b[r], basis[r], P.y[off + r],
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
    T* Us = P.U + ((size_t)i * P.L + S.np) * m;
    T* Rs = P.R + ((size_t)i * P.L + S.np) * m;
    __syncthreads();
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      Us[r] = P.eta[off + r];
      Rs[r] = P.row_out[off + r];
    }
  }
  if (threadIdx.x == 0) write_scalars(P, i, S);
}

// ------------------------------------------------------------ warp path

// V consecutive elements at p: one float4 / float2 / int4 / int2 (aligned
// to their size), or V / 2 double2 (16-byte aligned); V = 1 one element
template <int V>
__device__ __forceinline__ void ld(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (V == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void ld(const int* p, int* v) {
  if constexpr (V == 4) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if constexpr (V == 2) {
    const int2 w = *reinterpret_cast<const int2*>(p);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void ld(const double* p, double* v) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int h = 0; h < V / 2; ++h) {
      const double2 w = reinterpret_cast<const double2*>(p)[h];
      v[2 * h] = w.x;
      v[2 * h + 1] = w.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}
template <int V>
__device__ __forceinline__ void st(int* p, const int* v) {
  if constexpr (V == 4)
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  else
    *p = v[0];
}
template <int V>
__device__ __forceinline__ void st(double* p, const double* v) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int h = 0; h < V / 2; ++h)
      reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
  }
}

// every lane gets lane 0's record
template <typename T>
__device__ __forceinline__ Pass1<T> broadcast(Pass1<T> v) {
  return Pass1<T>{__shfl_sync(kFull, v.tmin, 0), __shfl_sync(kFull, v.trel, 0),
                  __shfl_sync(kFull, v.any, 0)};
}
template <typename T>
__device__ __forceinline__ Pass2<T> broadcast(Pass2<T> v) {
  return Pass2<T>{__shfl_sync(kFull, v.h_alpha, 0), __shfl_sync(kFull, v.h_row, 0),
                  __shfl_sync(kFull, v.c_row, 0), __shfl_sync(kFull, v.b_basis, 0),
                  __shfl_sync(kFull, v.b_row, 0)};
}

// RPL rows a lane, in RPL / V groups of V consecutive rows: group g of lane
// l starts at row (g * 32 + l) * V. m <= 32 * RPL; V > 1 needs m % V == 0.
template <typename T, int RPL, int V>
__global__ void __launch_bounds__(32 * kTailWarps) batch_tail_warp_kernel(const Params<T> P) {
  constexpr int G = RPL / V;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kTailWarps + (threadIdx.x >> 5);
  if (i >= P.batch) return;  // the whole warp
  const int m = P.m;
  const size_t off = (size_t)i * m;

  if (!P.active[i]) {
    const T zero[V] = {};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r0 = (g * 32 + lane) * V;
      if (r0 < m) {
        T v[V];
        int b[V];
        ld<V>(P.x_b + off + r0, v);
        st<V>(P.x_b_out + off + r0, v);
        ld<V>(P.y + off + r0, v);
        st<V>(P.y_out + off + r0, v);
        ld<V>(P.c_b + off + r0, v);
        st<V>(P.c_b_out + off + r0, v);
        ld<V>(P.basis + off + r0, b);
        st<V>(P.basis_out + off + r0, b);
        st<V>(P.eta + off + r0, zero);
        st<V>(P.row_out + off + r0, zero);
      }
    }
    if (lane == 0) write_inactive_scalars(P, i);
    return;
  }

  // this lane's rows, loaded once
  T a[RPL], x[RPL];
  int bas[RPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
    if (r0 < m) {
      ld<V>(P.alpha + off + r0, a + g * V);
      ld<V>(P.x_b + off + r0, x + g * V);
      ld<V>(P.basis + off + r0, bas + g * V);
    }
  }

  Pass1<T> r1 = Pass1<T>::identity();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (r0 + v < m) pass1_row(P, r1, a[g * V + v], x[g * V + v]);
  }
  r1 = broadcast(warp_reduce(r1));

  Pass2<T> r2 = Pass2<T>::identity();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (r0 + v < m)
        pass2_row(P, r2, r1.tmin, r1.trel, a[g * V + v], x[g * V + v], bas[g * V + v], r0 + v);
  }
  r2 = broadcast(warp_reduce(r2));

  const Step<T> S = step_scalars(P, i, r1, r2, P.degen[i]);
  const T* Bq = P.B_inv + (size_t)i * m * m + (size_t)S.q * m;
  T eta[RPL], row[RPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r0 = (g * 32 + lane) * V;
    if (r0 < m) {
      T bq[V], yv[V], cb[V], xo[V], yo[V], co[V];
      int bo[V];
      ld<V>(Bq + r0, bq);
      ld<V>(P.y + off + r0, yv);
      ld<V>(P.c_b + off + r0, cb);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = g * V + v;
        const Row<T> o = step_row(P, S, i, r0 + v, a[k], x[k], bas[k], yv[v], cb[v],
                                  true_row(P, S, i, r0 + v, bq[v]));
        eta[k] = o.eta;
        row[k] = o.row;
        xo[v] = o.x;
        yo[v] = o.y;
        co[v] = o.c_b;
        bo[v] = o.basis;
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
    T* Us = P.U + ((size_t)i * P.L + S.np) * m;
    T* Rs = P.R + ((size_t)i * P.L + S.np) * m;
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

template <typename T, int RPL, int V>
int launch_warp(const Params<T>& P, cudaStream_t s) {
  const int blocks = (P.batch + kTailWarps - 1) / kTailWarps;
  batch_tail_warp_kernel<T, RPL, V><<<blocks, 32 * kTailWarps, 0, s>>>(P);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

struct Call {
  const void *x_b, *alpha, *basis, *y, *c_b, *B_inv;
  void *U, *R;
  const void* npend;
  int L;
  const void *min_e, *e_p, *c_p, *p, *iters, *degen, *status, *active;
  int batch, m;
  double eps, pivot_tol, feas_tol, degen_tol;
  int harris, bland_after, st_running, st_optimal, st_unbounded, st_singular;
  int threads, rows_per_lane, vec;
  void *eta, *row, *x_b_out, *y_out, *c_b_out, *basis_out, *scal, *theta, *flags;
};

template <typename T>
int run(const Call& C, cudaStream_t s) {
  Params<T> P = {};
  P.x_b = static_cast<const T*>(C.x_b);
  P.alpha = static_cast<const T*>(C.alpha);
  P.basis = static_cast<const int*>(C.basis);
  P.y = static_cast<const T*>(C.y);
  P.c_b = static_cast<const T*>(C.c_b);
  P.B_inv = static_cast<const T*>(C.B_inv);
  P.U = static_cast<T*>(C.U);
  P.R = static_cast<T*>(C.R);
  P.npend = static_cast<const int*>(C.npend);
  P.L = C.L;
  P.min_e = static_cast<const T*>(C.min_e);
  P.e_p = static_cast<const T*>(C.e_p);
  P.c_p = static_cast<const T*>(C.c_p);
  P.p = static_cast<const int*>(C.p);
  P.iters = static_cast<const int*>(C.iters);
  P.degen = static_cast<const int*>(C.degen);
  P.status = static_cast<const int*>(C.status);
  P.active = static_cast<const unsigned char*>(C.active);
  P.m = C.m;
  P.eps = (T)C.eps;
  P.pivot_tol = (T)C.pivot_tol;
  P.feas_tol = (T)C.feas_tol;
  P.degen_tol = (T)C.degen_tol;
  P.harris = C.harris;
  P.bland_after = C.bland_after;
  P.st_running = C.st_running;
  P.st_optimal = C.st_optimal;
  P.st_unbounded = C.st_unbounded;
  P.st_singular = C.st_singular;
  P.eta = static_cast<T*>(C.eta);
  P.row_out = static_cast<T*>(C.row);
  P.x_b_out = static_cast<T*>(C.x_b_out);
  P.y_out = static_cast<T*>(C.y_out);
  P.c_b_out = static_cast<T*>(C.c_b_out);
  P.basis_out = static_cast<int*>(C.basis_out);
  P.scal = static_cast<int*>(C.scal);
  P.theta = static_cast<T*>(C.theta);
  P.flags = static_cast<unsigned char*>(C.flags);
  P.batch = C.batch;
  if (C.batch < 1 || C.m < 1 || !aligned(C.theta, sizeof(T))) return (int)cudaErrorInvalidValue;
  if (C.rows_per_lane == 0) {
    if (C.threads < 32 || C.threads > kBlockThreads || C.threads % 32 != 0)
      return (int)cudaErrorInvalidValue;
    batch_tail_block_kernel<T><<<C.batch, C.threads, 0, s>>>(P);
    return (int)cudaGetLastError();
  }
  const int vec = C.vec;
  // a group of vec rows: vec * sizeof(T) bytes (16-byte pieces in fp64),
  // vec * 4 of basis
  const int fbytes = vec * (int)sizeof(T) < 16 ? vec * (int)sizeof(T) : 16;
  const void* fvecs[] = {C.x_b, C.alpha, C.y, C.c_b, C.B_inv, C.U, C.R,
                         C.eta, C.row, C.x_b_out, C.y_out, C.c_b_out};
  bool ok = C.threads == 32 * kTailWarps && C.m <= 32 * C.rows_per_lane &&
            (vec == 1 || (vec == (C.rows_per_lane < 4 ? C.rows_per_lane : 4) && C.m % vec == 0)) &&
            aligned(C.basis, 4 * vec) && aligned(C.basis_out, 4 * vec);
  for (const void* v : fvecs) ok = ok && aligned(v, fbytes);
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (C.rows_per_lane * 10 + vec) {
    case 11: return launch_warp<T, 1, 1>(P, s);
    case 21: return launch_warp<T, 2, 1>(P, s);
    case 22: return launch_warp<T, 2, 2>(P, s);
    case 41: return launch_warp<T, 4, 1>(P, s);
    case 44: return launch_warp<T, 4, 4>(P, s);
    case 81: return launch_warp<T, 8, 1>(P, s);
    case 84: return launch_warp<T, 8, 4>(P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64, the type T of every float operand.
// Vectors (B, m) T (basis int32), B_inv (B, m, m) T; U, R (B, L, m) T and
// npend (B,) int32, or null under eager updates; per-instance scalars (B,):
// min_e, e_p, c_p T, p, iters, degen, status int32, active bool bytes; the
// tolerances as doubles, rounded to T once. The path: rows_per_lane 0, the
// block path with `threads` (a multiple of 32 up to 512) a block; else the
// warp path, rows_per_lane in {1, 2, 4, 8} (m <= 32 * rows_per_lane), vec
// in {1, min(rows_per_lane, 4)} (vec > 1: m % vec == 0, the T pointers
// aligned to min(16, vec sizeof(T)) bytes and basis, basis_out to 4 vec),
// threads = 128. Outputs: eta, row, x_b, y, c_b (B, m) T, basis (B, m)
// int32, scal (6, B) int32 (q, -, iters, status, degen, npend; row 1 is
// not written), theta (B,) T (theta_q; in fp32 the wrapper passes scal's
// row 1), flags (4, B) bytes (optimal, unbounded, bad, take). No output
// overlaps an input. Returns a cudaError_t; an inconsistent plan is
// cudaErrorInvalidValue.
extern "C" int simplex_batch_tail(
    int dtype, const void* x_b, const void* alpha, const void* basis, const void* y,
    const void* c_b, const void* B_inv, void* U, void* R, const void* npend,
    int L, const void* min_e, const void* e_p, const void* c_p, const void* p,
    const void* iters, const void* degen, const void* status, const void* active,
    int batch, int m, double eps, double pivot_tol, double feas_tol, double degen_tol,
    int harris, int bland_after, int st_running, int st_optimal, int st_unbounded,
    int st_singular, int threads, int rows_per_lane, int vec, void* eta, void* row,
    void* x_b_out, void* y_out, void* c_b_out, void* basis_out, void* scal, void* theta,
    void* flags, void* stream) {
  const Call C{x_b, alpha, basis, y, c_b, B_inv, U, R, npend, L, min_e, e_p, c_p, p, iters,
               degen, status, active, batch, m, eps, pivot_tol, feas_tol, degen_tol, harris,
               bland_after, st_running, st_optimal, st_unbounded, st_singular, threads,
               rows_per_lane, vec, eta, row, x_b_out, y_out, c_b_out, basis_out, scal, theta,
               flags};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(C, s);
  if (dtype == 1) return run<double>(C, s);
  return (int)cudaErrorInvalidValue;
}
