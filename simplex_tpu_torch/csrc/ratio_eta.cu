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
// round-to-nearest op (the *_rn helpers of ratio_cluster.cuh keep nvcc from
// contracting them into FMAs): q, theta_q, the flags, eta, x_b, y, c_b and
// basis equal the plain PyTorch composition bit for bit. The pending-pair sum
// of the deferred row uses one fma a pair, in pair order; the plain version
// sums through a matrix product, so that row and y agree to rounding only.
// The element type T is float or double (a dtype code picks the
// instantiation); the tolerances arrive as doubles and are rounded to T once,
// as torch rounds a Python float that it compares with a T tensor. In double
// the kernel moves twice the bytes; it stays bound by its launch.
// A last cluster.sync() keeps every block's shared memory alive until all
// its readers are done.

#include "ratio_cluster.cuh"

namespace {

using namespace ratio_cluster;

// The launch's arguments. The float arrays and scalars are of the element
// type T that the dtype code names (the kernel types them on entry); the
// tolerances are doubles, rounded to T once.
struct Params {
  // the ratio test
  const void* x_b;
  const void* alpha;
  const int* basis;
  int m;
  double pivot_tol, feas_tol;
  int harris;
  // tail off: use_bland is one bool (a byte) or one int32 on the device
  const void* use_bland;
  int bland_is_byte;
  // tail on: the step's device scalars and vectors
  int tail;
  const void* min_e;
  const void* e_p;
  const void* c_p;
  const int* p;
  const int* iters;
  const int* degen;
  const int* npend_in;  // null when updates are eager
  const void* y;
  const void* c_b;
  const void* B_inv;
  const void* U;  // (L, m) pending etas, null when updates are eager
  const void* R;  // (L, m) pending rows
  int npend;      // pending pairs, known on the host
  double eps, degen_tol;
  int bland_after;
  int st_running, st_optimal, st_unbounded, st_singular;
  // outputs
  void* eta;
  void* x_b_out;
  void* row_out;
  void* y_out;
  void* c_b_out;
  int* basis_out;
  int* scal;             // kQ .. kNpend (Scal<T>)
  unsigned char* flags;  // kOptimal .. kTake, one byte each (bool)
};

// The scalar block in int32 words: q, theta_q as a T at word W = sizeof(T)
// / 4 (so a double is 8-byte aligned, after a pad word), then iters, status,
// degen, npend; the flag block, one byte each.
template <typename T>
struct Scal {
  enum { kQ = 0, kTheta = sizeof(T) / 4, kIters = 2 * kTheta, kStatus, kDegen, kNpend, kWords };
};
enum { kOptimal = 0, kUnbounded, kBad, kTake, kFlagBytes };

template <typename T>
__global__ void __launch_bounds__(kThreads) pivot_tail_kernel(const Params P) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Pass1<T> red1[33];
  __shared__ Pass2<T> red2[33];
  __shared__ Pass1<T> slot1;
  __shared__ Pass2<T> slot2;

  const T* x_b = static_cast<const T*>(P.x_b);
  const T* alpha = static_cast<const T*>(P.alpha);
  const T pivot_tol = (T)P.pivot_tol;
  const int m = P.m;
  const int stride = (int)cluster.num_blocks() * kThreads;
  const int g0 = (int)cluster.block_rank() * kThreads + (int)threadIdx.x;
  // this thread's first row, kept in registers for all three passes
  const bool has0 = g0 < m;
  const T a0 = has0 ? alpha[g0] : T(0);
  const T x0 = has0 ? x_b[g0] : T(0);
  const int b0 = has0 ? P.basis[g0] : 0;

  bool bland;
  if (P.tail)
    bland = P.bland_after > 0 && *P.degen >= P.bland_after;
  else if (P.bland_is_byte)
    bland = *static_cast<const unsigned char*>(P.use_bland) != 0;
  else
    bland = *static_cast<const int*>(P.use_bland) != 0;

  // round 1: min theta, min relaxed theta, any eligible row
  const T feas_tol = (T)P.feas_tol;
  Pass1<T> r1 = Pass1<T>::identity();
  for (int r = g0; r < m; r += stride) {
    const T a = r == g0 ? a0 : alpha[r];
    if (a > pivot_tol) {
      const T xp = pos(r == g0 ? x0 : x_b[r]);
      r1.tmin = nan_min(r1.tmin, div_rn(xp, a));
      r1.trel = nan_min(r1.trel, div_rn(add_rn(xp, feas_tol), a));
      r1.any = 1;
    }
  }
  r1 = cluster_reduce(r1, red1, &slot1, cluster);
  const T tmin = r1.tmin;
  const T tmax = r1.trel;
  const bool unbounded = r1.any == 0;

  // round 2: Harris / classic / Bland candidates
  Pass2<T> r2 = Pass2<T>::identity();
  const bool tmin_nan = isnan(tmin);
  for (int r = g0; r < m; r += stride) {
    const T a = r == g0 ? a0 : alpha[r];
    const bool mk = a > pivot_tol;
    const T theta = mk ? div_rn(pos(r == g0 ? x0 : x_b[r]), a) : T(INFINITY);
    if (mk && theta <= tmax) r2.harris(a, r);
    if ((theta == tmin || (tmin_nan && isnan(theta))) && r < r2.c_row) r2.c_row = r;
    if (theta == tmin) r2.bland(r == g0 ? b0 : P.basis[r], r);
  }
  r2 = cluster_reduce(r2, red2, &slot2, cluster);

  // scalars: every thread derives them (uniform loads, no barrier)
  int q = bland ? r2.b_row : (P.harris ? r2.h_row : r2.c_row);
  if (q == kIntMax) q = 0;
  const T a_q = alpha[q];
  const T theta_at_q = a_q > pivot_tol ? div_rn(pos(x_b[q]), a_q) : T(INFINITY);
  const T theta_q = unbounded ? T(INFINITY) : (bland ? tmin : theta_at_q);

  bool go;        // eta and x_b are those of a pivot on row q
  bool zero_eta;  // tail: the step does not pivot
  bool optimal = false, bad = false;
  T min_e = 0, e_p = 0, c_p = 0;
  int p = 0;
  if (P.tail) {
    min_e = *static_cast<const T*>(P.min_e);
    e_p = *static_cast<const T*>(P.e_p);
    c_p = *static_cast<const T*>(P.c_p);
    p = *P.p;
    optimal = min_e >= (T)(-P.eps);
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
  const T inv = div_rn(T(1), go ? a_q : T(1));
  const T th = go ? theta_q : T(0);

  // epilogue
  T* eta = static_cast<T*>(P.eta);
  T* x_b_out = static_cast<T*>(P.x_b_out);
  T* row_out = static_cast<T*>(P.row_out);
  T* y_out = static_cast<T*>(P.y_out);
  T* c_b_out = static_cast<T*>(P.c_b_out);
  const T* y = static_cast<const T*>(P.y);
  const T* c_b = static_cast<const T*>(P.c_b);
  const T* B_inv = static_cast<const T*>(P.B_inv);
  const T* U = static_cast<const T*>(P.U);
  const T* R = static_cast<const T*>(P.R);
  const T y_scale = mul_rn(e_p, inv);
  for (int r = g0; r < m; r += stride) {
    const T a = r == g0 ? a0 : alpha[r];
    const T x = r == g0 ? x0 : x_b[r];
    if (zero_eta) {
      eta[r] = T(0);
      row_out[r] = T(0);
      x_b_out[r] = x;
      y_out[r] = y[r];
      c_b_out[r] = c_b[r];
      P.basis_out[r] = r == g0 ? b0 : P.basis[r];
      continue;
    }
    const bool at_q = r == q;
    eta[r] = at_q ? sub_rn(inv, T(1)) : mul_rn(-a, inv);
    x_b_out[r] = at_q ? th : sub_rn(x, mul_rn(th, a));
    if (P.tail) {
      // row q of the true inverse: the base row plus the pending pairs
      T row = B_inv[(size_t)q * m + r];
      for (int k = 0; k < P.npend; ++k)
        row = fma_rn(U[(size_t)k * m + q], R[(size_t)k * m + r], row);
      row_out[r] = row;
      y_out[r] = sub_rn(y[r], mul_rn(y_scale, row));
      c_b_out[r] = at_q ? c_p : c_b[r];
      P.basis_out[r] = at_q ? p : (r == g0 ? b0 : P.basis[r]);
    }
  }

  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    using S = Scal<T>;
    int* s = P.scal;
    unsigned char* f = P.flags;
    s[S::kQ] = q;
    *reinterpret_cast<T*>(s + S::kTheta) = theta_q;
    f[kUnbounded] = unbounded;
    if (P.tail) {
      const int degen = *P.degen;
      s[S::kIters] = *P.iters + (go ? 1 : 0);
      s[S::kStatus] = optimal ? P.st_optimal
                      : unbounded ? P.st_unbounded
                      : bad ? P.st_singular : P.st_running;
      s[S::kDegen] = go ? (th <= (T)P.degen_tol ? degen + 1 : 0) : degen;
      s[S::kNpend] = P.npend_in != nullptr ? *P.npend_in + (go ? 1 : 0) : 0;
      f[kOptimal] = optimal;
      f[kBad] = bad;
      f[kTake] = go;
    }
  }
  // no block may exit while another still reads its shared memory
  cluster.sync();
}

// dtype: 0 = float32, 1 = float64
int launch(int dtype, const Params& P, int cluster_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cluster(pivot_tail_kernel<float>, P, cluster_blocks, s);
  if (dtype == 1) return launch_cluster(pivot_tail_kernel<double>, P, cluster_blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The ratio test with the eta / x_b epilogue alone (the tail off).
// dtype: 0 = float32, 1 = float64, the type T of x_b, alpha and the outputs.
// use_bland: one element on the device, a bool byte (bland_is_byte) or an
// int32. cluster_blocks: 1..8 blocks of 1024 threads. Outputs: scal
// (Scal<T>'s 4 + 2 sizeof(T) / 4 int32 words, of which q and theta_q are
// written), flags (4 bytes, of which unbounded, the second, is written), eta
// and x_b_new (m,) T.
extern "C" int simplex_ratio_eta(int dtype, const void* x_b, const void* alpha,
                                 const void* basis, const void* use_bland,
                                 int bland_is_byte, int m, double pivot_tol,
                                 double feas_tol, int harris, int cluster_blocks,
                                 void* scal, void* flags, void* eta,
                                 void* x_b_new, void* stream) {
  Params P = {};
  P.x_b = x_b;
  P.alpha = alpha;
  P.basis = static_cast<const int*>(basis);
  P.m = m;
  P.pivot_tol = pivot_tol;
  P.feas_tol = feas_tol;
  P.harris = harris;
  P.use_bland = use_bland;
  P.bland_is_byte = bland_is_byte;
  P.tail = 0;
  P.eta = eta;
  P.x_b_out = x_b_new;
  P.scal = static_cast<int*>(scal);
  P.flags = static_cast<unsigned char*>(flags);
  return launch(dtype, P, cluster_blocks, stream);
}

// The whole tail. dtype: 0 = float32, 1 = float64, the type T of every float
// operand. Scalars on the device: min_e, e_p, c_p T; p, iters, degen,
// npend_in int32 (npend_in null when updates are eager). Vectors: x_b, alpha,
// y, c_b (m,) T; basis (m,) int32; B_inv (m, m) T row-major; U, R (L, m) T
// with npend <= L pending pairs (null and 0 when eager). Outputs, none
// overlapping an input: eta, row, x_b_out, y_out, c_b_out (m,) T, basis_out
// (m,) int32 (under deferred updates eta and row are rows npend of U and R),
// scal (Scal<T>: q, theta_q as a T, iters, status, degen, npend) and flags
// (4 bytes: optimal, unbounded, bad, take).
extern "C" int simplex_pivot_tail(
    int dtype, const void* x_b, const void* alpha, const void* basis, const void* y,
    const void* c_b, const void* B_inv, const void* U, const void* R,
    int npend, const void* min_e, const void* e_p, const void* c_p,
    const void* p, const void* iters, const void* degen, const void* npend_in,
    int m, double eps, double pivot_tol, double feas_tol, double degen_tol,
    int harris, int bland_after, int st_running, int st_optimal,
    int st_unbounded, int st_singular, int cluster_blocks, void* eta,
    void* row, void* x_b_out, void* y_out, void* c_b_out, void* basis_out,
    void* scal, void* flags, void* stream) {
  Params P = {};
  P.x_b = x_b;
  P.alpha = alpha;
  P.basis = static_cast<const int*>(basis);
  P.m = m;
  P.pivot_tol = pivot_tol;
  P.feas_tol = feas_tol;
  P.harris = harris;
  P.tail = 1;
  P.min_e = min_e;
  P.e_p = e_p;
  P.c_p = c_p;
  P.p = static_cast<const int*>(p);
  P.iters = static_cast<const int*>(iters);
  P.degen = static_cast<const int*>(degen);
  P.npend_in = static_cast<const int*>(npend_in);
  P.y = y;
  P.c_b = c_b;
  P.B_inv = B_inv;
  P.U = U;
  P.R = R;
  P.npend = npend;
  P.eps = eps;
  P.degen_tol = degen_tol;
  P.bland_after = bland_after;
  P.st_running = st_running;
  P.st_optimal = st_optimal;
  P.st_unbounded = st_unbounded;
  P.st_singular = st_singular;
  P.eta = eta;
  P.row_out = row;
  P.x_b_out = x_b_out;
  P.y_out = y_out;
  P.c_b_out = c_b_out;
  P.basis_out = static_cast<int*>(basis_out);
  P.scal = static_cast<int*>(scal);
  P.flags = static_cast<unsigned char*>(flags);
  return launch(dtype, P, cluster_blocks, stream);
}
