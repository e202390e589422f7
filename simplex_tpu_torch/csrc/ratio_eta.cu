// The pivot's O(m) tail in one launch: ratio test, eta vector, stepped x_b,
// row q of the true inverse, y, c_b, basis, and the step's scalars.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, ratio_eta / _ratio_eta_kernel
// (the pl.pallas_call at line 323), and the O(m) selects and scalar updates
// that simplex_tpu/core/step.py pivot_step wraps around it (one XLA
// executable there; some forty small launches under eager PyTorch).
//
// Bound on the H100: latency, not bytes. At m = 8192 the tail reads about
// 200 KB and writes about 200 KB (0.1 us of traffic at 3.35 TB/s); its time
// is one launch plus the dependent reduction steps. The unit of cost is the
// launch, so the design spends one.
//
// Design: one thread block cluster of up to 8 blocks of 1024 threads, sized
// by m (one block up to 1024 rows; 8 blocks from 7169 rows on; a stride loop
// beyond 8192). Each thread keeps its first row (alpha, x_b, basis) in
// registers, so at m <= 8192 every row is read from device memory once; rows
// beyond the first stride are re-read (they hit L2).
//   round 1  min theta, min relaxed theta (Harris pass 1), any(alpha > tol),
//            reduced as one record over the cluster (cluster_reduce,
//            ratio_cluster.cuh: warp shuffles, shared memory, then
//            distributed shared memory);
//   round 2  over the rows with theta recomputed bit for bit: Harris' largest
//            alpha among rows with theta <= theta_max, the classic lowest
//            index of the minimum, Bland's smallest basis index among the
//            exact minima, again one record and one exchange;
//   scalars  every thread derives q, theta_q and the step's decisions from
//            the two records (no further barrier);
//   epilogue every thread writes its rows of eta, x_b and, with the tail on,
//            row q of the true inverse (the base row plus the pending pairs
//            in pair order), y, c_b and basis, selected as the step selects
//            them: a step that does not pivot gets a zero eta and row and
//            every other leaf unchanged. Block 0 writes the scalars.
// No second kernel, no float atomics, no scratch in device memory. Every
// reduction is a min / max whose ties break to the lowest index (NaN first
// where torch.min puts it first), so the result does not depend on how the
// rows are split over blocks, and each arithmetic step is one IEEE
// round-to-nearest op (the __f*_rn intrinsics keep nvcc from contracting
// them into FMAs): q, theta_q, the flags, eta, x_b, y, c_b and basis equal
// the plain PyTorch composition bit for bit. The pending-pair sum of the
// deferred row uses fmaf in pair order; the plain version sums through a
// matrix product, so that row and y agree to rounding only.
// A last cluster.sync() keeps every block's shared memory alive until all
// its readers are done.

#include "ratio_cluster.cuh"

namespace {

using namespace ratio_cluster;

struct Params {
  // the ratio test
  const float* x_b;
  const float* alpha;
  const int* basis;
  int m;
  float pivot_tol, feas_tol;
  int harris;
  // tail off: use_bland is one bool (a byte) or one int32 on the device
  const void* use_bland;
  int bland_is_byte;
  // tail on: the step's device scalars and vectors
  int tail;
  const float* min_e;
  const float* e_p;
  const float* c_p;
  const int* p;
  const int* iters;
  const int* degen;
  const int* npend_in;  // null when updates are eager
  const float* y;
  const float* c_b;
  const float* B_inv;
  const float* U;  // (L, m) pending etas, null when updates are eager
  const float* R;  // (L, m) pending rows
  int npend;       // pending pairs, known on the host
  float eps, degen_tol;
  int bland_after;
  int st_running, st_optimal, st_unbounded, st_singular;
  // outputs
  float* eta;
  float* x_b_out;
  float* row_out;
  float* y_out;
  float* c_b_out;
  int* basis_out;
  int* scal;             // kQ .. kNpend
  unsigned char* flags;  // kOptimal .. kTake, one byte each (bool)
};

// words of the scalar block (theta_q as float bits), bytes of the flag block
enum { kQ = 0, kTheta, kIters, kStatus, kDegen, kNpend, kScalWords };
enum { kOptimal = 0, kUnbounded, kBad, kTake, kFlagBytes };

__global__ void __launch_bounds__(kThreads) pivot_tail_kernel(const Params P) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Pass1 red1[33];
  __shared__ Pass2 red2[33];
  __shared__ Pass1 slot1;
  __shared__ Pass2 slot2;

  const int m = P.m;
  const int stride = (int)cluster.num_blocks() * kThreads;
  const int g0 = (int)cluster.block_rank() * kThreads + (int)threadIdx.x;
  // this thread's first row, kept in registers for all three passes
  const bool has0 = g0 < m;
  const float a0 = has0 ? P.alpha[g0] : 0.f;
  const float x0 = has0 ? P.x_b[g0] : 0.f;
  const int b0 = has0 ? P.basis[g0] : 0;

  bool bland;
  if (P.tail)
    bland = P.bland_after > 0 && *P.degen >= P.bland_after;
  else if (P.bland_is_byte)
    bland = *static_cast<const unsigned char*>(P.use_bland) != 0;
  else
    bland = *static_cast<const int*>(P.use_bland) != 0;

  // round 1: min theta, min relaxed theta, any eligible row
  Pass1 r1 = Pass1::identity();
  for (int r = g0; r < m; r += stride) {
    const float a = r == g0 ? a0 : P.alpha[r];
    if (a > P.pivot_tol) {
      const float xp = pos(r == g0 ? x0 : P.x_b[r]);
      r1.tmin = nan_min(r1.tmin, __fdiv_rn(xp, a));
      r1.trel = nan_min(r1.trel, __fdiv_rn(__fadd_rn(xp, P.feas_tol), a));
      r1.any = 1;
    }
  }
  r1 = cluster_reduce(r1, red1, &slot1, cluster);
  const float tmin = r1.tmin;
  const float tmax = r1.trel;
  const bool unbounded = r1.any == 0;

  // round 2: Harris / classic / Bland candidates
  Pass2 r2 = Pass2::identity();
  const bool tmin_nan = isnan(tmin);
  for (int r = g0; r < m; r += stride) {
    const float a = r == g0 ? a0 : P.alpha[r];
    const bool mk = a > P.pivot_tol;
    const float theta = mk ? __fdiv_rn(pos(r == g0 ? x0 : P.x_b[r]), a) : INFINITY;
    if (mk && theta <= tmax) r2.harris(a, r);
    if ((theta == tmin || (tmin_nan && isnan(theta))) && r < r2.c_row) r2.c_row = r;
    if (theta == tmin) r2.bland(r == g0 ? b0 : P.basis[r], r);
  }
  r2 = cluster_reduce(r2, red2, &slot2, cluster);

  // scalars: every thread derives them (uniform loads, no barrier)
  int q = bland ? r2.b_row : (P.harris ? r2.h_row : r2.c_row);
  if (q == kIntMax) q = 0;
  const float a_q = P.alpha[q];
  const float theta_at_q = a_q > P.pivot_tol ? __fdiv_rn(pos(P.x_b[q]), a_q) : INFINITY;
  const float theta_q = unbounded ? INFINITY : (bland ? tmin : theta_at_q);

  bool go;        // eta and x_b are those of a pivot on row q
  bool zero_eta;  // tail: the step does not pivot
  bool optimal = false, bad = false;
  float min_e = 0.f, e_p = 0.f, c_p = 0.f;
  int p = 0;
  if (P.tail) {
    min_e = *P.min_e;
    e_p = *P.e_p;
    c_p = *P.c_p;
    p = *P.p;
    optimal = min_e >= -P.eps;
    const bool take0 = !optimal && !unbounded;
    // numerical failure: a non-finite pricing value, or a pivot about to be
    // taken with a non-finite ratio
    bad = !isfinite(min_e) || (take0 && !isfinite(theta_q));
    go = take0 && !bad;
    zero_eta = !go;
  } else {
    go = !unbounded && isfinite(theta_q);
    zero_eta = false;
  }
  const float inv = __fdiv_rn(1.f, go ? a_q : 1.f);
  const float th = go ? theta_q : 0.f;

  // epilogue
  const float y_scale = __fmul_rn(e_p, inv);
  for (int r = g0; r < m; r += stride) {
    const float a = r == g0 ? a0 : P.alpha[r];
    const float x = r == g0 ? x0 : P.x_b[r];
    if (zero_eta) {
      P.eta[r] = 0.f;
      P.row_out[r] = 0.f;
      P.x_b_out[r] = x;
      P.y_out[r] = P.y[r];
      P.c_b_out[r] = P.c_b[r];
      P.basis_out[r] = r == g0 ? b0 : P.basis[r];
      continue;
    }
    const bool at_q = r == q;
    P.eta[r] = at_q ? __fsub_rn(inv, 1.f) : __fmul_rn(-a, inv);
    P.x_b_out[r] = at_q ? th : __fsub_rn(x, __fmul_rn(th, a));
    if (P.tail) {
      // row q of the true inverse: the base row plus the pending pairs
      float row = P.B_inv[(size_t)q * m + r];
      for (int k = 0; k < P.npend; ++k)
        row = fmaf(P.U[(size_t)k * m + q], P.R[(size_t)k * m + r], row);
      P.row_out[r] = row;
      P.y_out[r] = __fsub_rn(P.y[r], __fmul_rn(y_scale, row));
      P.c_b_out[r] = at_q ? c_p : P.c_b[r];
      P.basis_out[r] = at_q ? p : (r == g0 ? b0 : P.basis[r]);
    }
  }

  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    int* s = P.scal;
    unsigned char* f = P.flags;
    s[kQ] = q;
    s[kTheta] = __float_as_int(theta_q);
    f[kUnbounded] = unbounded;
    if (P.tail) {
      const int degen = *P.degen;
      s[kIters] = *P.iters + (go ? 1 : 0);
      s[kStatus] = optimal ? P.st_optimal
                   : unbounded ? P.st_unbounded
                   : bad ? P.st_singular : P.st_running;
      s[kDegen] = go ? (th <= P.degen_tol ? degen + 1 : 0) : degen;
      s[kNpend] = P.npend_in != nullptr ? *P.npend_in + (go ? 1 : 0) : 0;
      f[kOptimal] = optimal;
      f[kBad] = bad;
      f[kTake] = go;
    }
  }
  // no block may exit while another still reads its shared memory
  cluster.sync();
}

int launch(const Params& P, int cluster_blocks, cudaStream_t stream) {
  return launch_cluster(pivot_tail_kernel, P, cluster_blocks, stream);
}

}  // namespace

// The ratio test with the eta / x_b epilogue alone (the tail off).
// use_bland: one element on the device, a bool byte (bland_is_byte) or an
// int32. cluster_blocks: 1..8 blocks of 1024 threads. Outputs: scal
// (6 int32 words, of which q and theta_q's bits are written), flags (4
// bytes, of which unbounded, the second, is written), eta and x_b_new (m,)
// fp32.
extern "C" int simplex_ratio_eta(const void* x_b, const void* alpha,
                                 const void* basis, const void* use_bland,
                                 int bland_is_byte, int m, float pivot_tol,
                                 float feas_tol, int harris, int cluster_blocks,
                                 void* scal, void* flags, void* eta,
                                 void* x_b_new, void* stream) {
  Params P = {};
  P.x_b = static_cast<const float*>(x_b);
  P.alpha = static_cast<const float*>(alpha);
  P.basis = static_cast<const int*>(basis);
  P.m = m;
  P.pivot_tol = pivot_tol;
  P.feas_tol = feas_tol;
  P.harris = harris;
  P.use_bland = use_bland;
  P.bland_is_byte = bland_is_byte;
  P.tail = 0;
  P.eta = static_cast<float*>(eta);
  P.x_b_out = static_cast<float*>(x_b_new);
  P.scal = static_cast<int*>(scal);
  P.flags = static_cast<unsigned char*>(flags);
  return launch(P, cluster_blocks, static_cast<cudaStream_t>(stream));
}

// The whole tail. Scalars on the device: min_e, e_p, c_p fp32; p, iters,
// degen, npend_in int32 (npend_in null when updates are eager). Vectors:
// x_b, alpha, y, c_b (m,) fp32; basis (m,) int32; B_inv (m, m) fp32
// row-major; U, R (L, m) fp32 with npend <= L pending pairs (null and 0 when
// eager). Outputs, none overlapping an input: eta, row, x_b_out, y_out,
// c_b_out (m,) fp32, basis_out (m,) int32 (under deferred updates eta and row
// are rows npend of U and R), scal (6 int32 words: q, theta_q's bits,
// iters, status, degen, npend) and flags (4 bytes: optimal, unbounded, bad,
// take).
extern "C" int simplex_pivot_tail(
    const void* x_b, const void* alpha, const void* basis, const void* y,
    const void* c_b, const void* B_inv, const void* U, const void* R,
    int npend, const void* min_e, const void* e_p, const void* c_p,
    const void* p, const void* iters, const void* degen, const void* npend_in,
    int m, float eps, float pivot_tol, float feas_tol, float degen_tol,
    int harris, int bland_after, int st_running, int st_optimal,
    int st_unbounded, int st_singular, int cluster_blocks, void* eta,
    void* row, void* x_b_out, void* y_out, void* c_b_out, void* basis_out,
    void* scal, void* flags, void* stream) {
  Params P = {};
  P.x_b = static_cast<const float*>(x_b);
  P.alpha = static_cast<const float*>(alpha);
  P.basis = static_cast<const int*>(basis);
  P.m = m;
  P.pivot_tol = pivot_tol;
  P.feas_tol = feas_tol;
  P.harris = harris;
  P.tail = 1;
  P.min_e = static_cast<const float*>(min_e);
  P.e_p = static_cast<const float*>(e_p);
  P.c_p = static_cast<const float*>(c_p);
  P.p = static_cast<const int*>(p);
  P.iters = static_cast<const int*>(iters);
  P.degen = static_cast<const int*>(degen);
  P.npend_in = static_cast<const int*>(npend_in);
  P.y = static_cast<const float*>(y);
  P.c_b = static_cast<const float*>(c_b);
  P.B_inv = static_cast<const float*>(B_inv);
  P.U = static_cast<const float*>(U);
  P.R = static_cast<const float*>(R);
  P.npend = npend;
  P.eps = eps;
  P.degen_tol = degen_tol;
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
  return launch(P, cluster_blocks, static_cast<cudaStream_t>(stream));
}
