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
// is the launch and the reduction steps of a block.
//
// Design: one block an instance, one row a thread up to 1024 rows (a
// stride loop beyond): at m = 64 two warps hold the column, so a thread
// block cluster (csrc/ratio_eta.cu) has nothing to do here, and 4096
// independent blocks fill the card. The two reduction rounds are those of
// ratio_eta.cu, on its records (csrc/ratio_cluster.cuh: Pass1, Pass2, the
// NaN-first minimum, lowest index on ties, Bland's smallest basis index)
// reduced over the block alone: round 1 min theta, min relaxed theta, any
// eligible row; round 2 Harris' largest alpha within theta_max, the
// classic lowest index of the minimum, Bland's. Every arithmetic step is
// one IEEE round-to-nearest op in the plain version's order, so every
// output equals ops.pivot_tail_batched bit for bit; under deferred updates
// row q adds the pending pairs of its instance in pair order, a multiply
// and an add each, as the plain version does. An instance that is not
// active is copied through unchanged, with a zero eta and row.

#include "ratio_cluster.cuh"

namespace {

using ratio_cluster::kIntMax;
using ratio_cluster::nan_min;
using ratio_cluster::Pass1;
using ratio_cluster::Pass2;
using ratio_cluster::pos;
using ratio_cluster::warp_reduce;

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

__global__ void __launch_bounds__(1024) batch_tail_kernel(const Params P) {
  __shared__ Pass1 red1[33];
  __shared__ Pass2 red2[33];
  const int i = blockIdx.x;
  const int m = P.m;
  const size_t off = (size_t)i * m;
  const float* x_b = P.x_b + off;
  const float* alpha = P.alpha + off;
  const int* basis = P.basis + off;
  const int B = P.batch;
  int* sc = P.scal;
  unsigned char* fl = P.flags;

  if (!P.active[i]) {
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      P.eta[off + r] = 0.f;
      P.row_out[off + r] = 0.f;
      P.x_b_out[off + r] = x_b[r];
      P.y_out[off + r] = P.y[off + r];
      P.c_b_out[off + r] = P.c_b[off + r];
      P.basis_out[off + r] = basis[r];
    }
    if (threadIdx.x == 0) {
      sc[kQ * B + i] = 0;
      sc[kTheta * B + i] = 0;
      sc[kIters * B + i] = P.iters[i];
      sc[kStatus * B + i] = P.status[i];
      sc[kDegen * B + i] = P.degen[i];
      sc[kNpend * B + i] = P.npend != nullptr ? P.npend[i] : 0;
      fl[kOptimal * B + i] = 0;
      fl[kUnbounded * B + i] = 0;
      fl[kBad * B + i] = 0;
      fl[kTake * B + i] = 0;
    }
    return;
  }

  const int degen = P.degen[i];
  const bool bland = P.bland_after > 0 && degen >= P.bland_after;

  Pass1 r1 = Pass1::identity();
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    if (a > P.pivot_tol) {
      const float xp = pos(x_b[r]);
      r1.tmin = nan_min(r1.tmin, __fdiv_rn(xp, a));
      r1.trel = nan_min(r1.trel, __fdiv_rn(__fadd_rn(xp, P.feas_tol), a));
      r1.any = 1;
    }
  }
  r1 = block_reduce(r1, red1);
  const float tmin = r1.tmin;
  const float tmax = r1.trel;
  const bool unbounded = r1.any == 0;

  Pass2 r2 = Pass2::identity();
  const bool tmin_nan = isnan(tmin);
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    const bool mk = a > P.pivot_tol;
    const float theta = mk ? __fdiv_rn(pos(x_b[r]), a) : INFINITY;
    if (mk && theta <= tmax) r2.harris(a, r);
    if ((theta == tmin || (tmin_nan && isnan(theta))) && r < r2.c_row) r2.c_row = r;
    if (theta == tmin) r2.bland(basis[r], r);
  }
  r2 = block_reduce(r2, red2);

  int q = bland ? r2.b_row : (P.harris ? r2.h_row : r2.c_row);
  if (q == kIntMax) q = 0;
  const float a_q = alpha[q];
  const float theta_at_q = a_q > P.pivot_tol ? __fdiv_rn(pos(x_b[q]), a_q) : INFINITY;
  const float theta_q = unbounded ? INFINITY : (bland ? tmin : theta_at_q);

  const float min_e = P.min_e[i];
  const float e_p = P.e_p[i];
  const float c_p = P.c_p[i];
  const int p = P.p[i];
  const bool optimal = min_e >= -P.eps;
  const bool take0 = !optimal && !unbounded;
  const bool bad = !isfinite(min_e) || (take0 && !isfinite(theta_q));
  const bool go = take0 && !bad;
  // eta and x_b_new as ratio_eta computes them (live: a finite step)
  const bool live = !unbounded && isfinite(theta_q);
  const float inv_live = __fdiv_rn(1.f, live ? a_q : 1.f);
  const float th = live ? theta_q : 0.f;
  const float inv = __fdiv_rn(1.f, go ? a_q : 1.f);
  const float y_scale = __fmul_rn(e_p, inv);
  const int np = P.npend != nullptr ? P.npend[i] : 0;
  const float* Bq = P.B_inv + (size_t)i * m * m + (size_t)q * m;

  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const float a = alpha[r];
    const float x = x_b[r];
    const bool at_q = r == q;
    float row = Bq[r];
    if (P.U != nullptr) {
      const float* Ui = P.U + (size_t)i * P.L * m;
      const float* Ri = P.R + (size_t)i * P.L * m;
      for (int k = 0; k < np; ++k)
        row = __fadd_rn(row, __fmul_rn(Ui[(size_t)k * m + q], Ri[(size_t)k * m + r]));
    }
    if (go) {
      const float eta = at_q ? __fsub_rn(inv_live, 1.f) : __fmul_rn(-a, inv_live);
      P.eta[off + r] = eta;
      P.row_out[off + r] = row;
      P.x_b_out[off + r] = at_q ? th : __fsub_rn(x, __fmul_rn(th, a));
      P.y_out[off + r] = __fsub_rn(P.y[off + r], __fmul_rn(y_scale, row));
      P.c_b_out[off + r] = at_q ? c_p : P.c_b[off + r];
      P.basis_out[off + r] = at_q ? p : basis[r];
    } else {
      P.eta[off + r] = 0.f;
      P.row_out[off + r] = 0.f;
      P.x_b_out[off + r] = x;
      P.y_out[off + r] = P.y[off + r];
      P.c_b_out[off + r] = P.c_b[off + r];
      P.basis_out[off + r] = basis[r];
    }
  }
  if (go && P.U != nullptr) {
    // the new pair goes into slot npend of this instance (read above by
    // every thread, before any write: the slot is past the pending pairs)
    float* Us = P.U + ((size_t)i * P.L + np) * m;
    float* Rs = P.R + ((size_t)i * P.L + np) * m;
    __syncthreads();
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      Us[r] = P.eta[off + r];
      Rs[r] = P.row_out[off + r];
    }
  }

  if (threadIdx.x == 0) {
    const float th_step = go ? theta_q : 0.f;
    sc[kQ * B + i] = q;
    sc[kTheta * B + i] = __float_as_int(theta_q);
    sc[kIters * B + i] = P.iters[i] + (go ? 1 : 0);
    sc[kStatus * B + i] = optimal ? P.st_optimal
                          : unbounded ? P.st_unbounded
                          : bad ? P.st_singular : P.st_running;
    sc[kDegen * B + i] = go ? (th_step <= P.degen_tol ? degen + 1 : 0) : degen;
    sc[kNpend * B + i] = np + (go && P.U != nullptr ? 1 : 0);
    fl[kOptimal * B + i] = optimal;
    fl[kUnbounded * B + i] = unbounded;
    fl[kBad * B + i] = bad;
    fl[kTake * B + i] = go;
  }
}

}  // namespace

// Vectors (B, m) fp32 (basis int32), B_inv (B, m, m) fp32; U, R (B, L, m)
// fp32 and npend (B,) int32, or null under eager updates; per-instance
// scalars (B,): min_e, e_p, c_p fp32, p, iters, degen, status int32,
// active bool bytes. threads: a multiple of 32 up to 1024. Outputs: eta,
// row, x_b, y, c_b (B, m) fp32, basis (B, m) int32, scal (6, B) int32
// (q, theta_q's bits, iters, status, degen, npend), flags (4, B) bytes
// (optimal, unbounded, bad, take). No output overlaps an input.
extern "C" int simplex_batch_tail(
    const void* x_b, const void* alpha, const void* basis, const void* y,
    const void* c_b, const void* B_inv, void* U, void* R, const void* npend,
    int L, const void* min_e, const void* e_p, const void* c_p, const void* p,
    const void* iters, const void* degen, const void* status, const void* active,
    int batch, int m, float eps, float pivot_tol, float feas_tol, float degen_tol,
    int harris, int bland_after, int st_running, int st_optimal, int st_unbounded,
    int st_singular, int threads, void* eta, void* row, void* x_b_out, void* y_out,
    void* c_b_out, void* basis_out, void* scal, void* flags, void* stream) {
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
  batch_tail_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
