// Classic masked ratio test: theta_i = max(x_b_i, 0) / alpha_i over the rows
// with alpha_i > pivot_tol; q is the lowest-index argmin of theta, or under
// Bland's rule the row with the smallest basis index among rows at the exact
// minimum; unbounded when no row is eligible.
//
// Replaces: simplex_tpu/kernels/pallas_ops.py, ratio_argmin / _ratio_kernel
// (the pl.pallas_call at line 212).
//
// Bound on the H100: latency. At m = 8192 it reads 96 KB and writes 9 bytes,
// so its time is the launch plus the dependent reduction steps, and the
// design keeps those few: the rows spread over as many SMs as ratio_eta.cu's
// tail uses, each read from device memory once.
//
// Design: one thread block cluster of up to 8 blocks of 1024 threads, sized
// by m (one block up to 1024 rows; 8 blocks from 7169 rows on; a stride loop
// beyond 8192), the same shape as ratio_eta.cu's kernel and the same
// reduction (cluster_reduce, ratio_cluster.cuh), without the epilogue. Each
// thread keeps its first row (alpha, x_b, basis) in registers.
//   round 1  min theta and any(alpha > tol), one record over the cluster;
//   round 2  with theta recomputed bit for bit: the lowest row at the min
//            (classic) and the smallest (basis, row) pair at the exact min
//            (Bland), again one record and one exchange;
//   thread 0 of block 0 picks q (INT_MAX maps to 0), theta_q and the
//            unbounded flag.
// The Pallas kernel needs m % 128 == 0 and falls back to XLA otherwise; this
// one takes any m. Each theta is one IEEE division (div_rn) and every
// reduction breaks ties to the lowest index, so the result equals the plain
// PyTorch version (kernels/ops.py ratio_argmin) bit for bit, NaN included:
// a NaN theta wins the min, and its lowest row is q, as torch.argmin gives.
// use_bland is read on the device and the results stay there, so a caller
// needs no host sync. A last cluster.sync() keeps every block's shared memory
// alive until all its readers are done. The element type T is float or
// double (a dtype code picks the instantiation); pivot_tol arrives as a
// double and is rounded to T once, as torch compares a T tensor with it.

#include "ratio_cluster.cuh"

namespace {

using namespace ratio_cluster;

// x_b, alpha and theta_out are of the element type T that the dtype code
// names (the kernel types them on entry); pivot_tol is rounded to T once.
struct Params {
  const void* x_b;
  const void* alpha;
  const int* basis;
  const void* use_bland;  // one bool (a byte) or one int32 on the device
  int bland_is_byte;
  int m;
  double pivot_tol;
  int* q_out;
  void* theta_out;
  bool* unb_out;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ratio_argmin_kernel(const Params P) {
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
  // this thread's first row, kept in registers for both rounds
  const bool has0 = g0 < m;
  const T a0 = has0 ? alpha[g0] : T(0);
  const T x0 = has0 ? x_b[g0] : T(0);
  const int b0 = has0 ? P.basis[g0] : 0;

  // round 1: min theta, any eligible row (trel stays +inf: no Harris pass)
  Pass1<T> r1 = Pass1<T>::identity();
  for (int r = g0; r < m; r += stride) {
    const T a = r == g0 ? a0 : alpha[r];
    if (a > pivot_tol) {
      r1.tmin = nan_min(r1.tmin, div_rn(pos(r == g0 ? x0 : x_b[r]), a));
      r1.any = 1;
    }
  }
  r1 = cluster_reduce(r1, red1, &slot1, cluster);
  const T tmin = r1.tmin;

  // round 2: lowest row at the min (classic), smallest (basis, row) at the
  // exact min (Bland); the Harris fields stay at their identity
  Pass2<T> r2 = Pass2<T>::identity();
  const bool tmin_nan = isnan(tmin);
  for (int r = g0; r < m; r += stride) {
    const T a = r == g0 ? a0 : alpha[r];
    const T theta = a > pivot_tol ? div_rn(pos(r == g0 ? x0 : x_b[r]), a) : T(INFINITY);
    if ((theta == tmin || (tmin_nan && isnan(theta))) && r < r2.c_row) r2.c_row = r;
    if (theta == tmin) r2.bland(r == g0 ? b0 : P.basis[r], r);
  }
  r2 = cluster_reduce(r2, red2, &slot2, cluster);

  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const bool bland = P.bland_is_byte
                           ? *static_cast<const unsigned char*>(P.use_bland) != 0
                           : *static_cast<const int*>(P.use_bland) != 0;
    const bool unbounded = r1.any == 0;
    int q = bland ? r2.b_row : r2.c_row;
    if (q == kIntMax) q = 0;
    *P.q_out = q;
    *static_cast<T*>(P.theta_out) = unbounded ? T(INFINITY) : tmin;
    *P.unb_out = unbounded;
  }
  // no block may exit while another still reads its shared memory
  cluster.sync();
}

}  // namespace

// dtype: 0 = float32, 1 = float64, the type T of x_b, alpha and theta_q.
// use_bland: one element on the device, a bool byte (bland_is_byte) or an
// int32. cluster_blocks: 1..8 blocks of 1024 threads. Outputs: q int32,
// theta_q T, unbounded bool (one byte).
extern "C" int simplex_ratio_argmin(int dtype, const void* x_b, const void* alpha,
                                    const void* basis, const void* use_bland,
                                    int bland_is_byte, int m, double pivot_tol,
                                    int cluster_blocks, void* q, void* theta_q,
                                    void* unbounded, void* stream) {
  Params P = {};
  P.x_b = x_b;
  P.alpha = alpha;
  P.basis = static_cast<const int*>(basis);
  P.use_bland = use_bland;
  P.bland_is_byte = bland_is_byte;
  P.m = m;
  P.pivot_tol = pivot_tol;
  P.q_out = static_cast<int*>(q);
  P.theta_out = theta_q;
  P.unb_out = static_cast<bool*>(unbounded);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cluster(ratio_argmin_kernel<float>, P, cluster_blocks, s);
  if (dtype == 1) return launch_cluster(ratio_argmin_kernel<double>, P, cluster_blocks, s);
  return (int)cudaErrorInvalidValue;
}
