// Native double-precision dense simplex oracle.
//
// Fills the role of the reference's GLPK-based correctness oracle
// (solver_glpk.cpp: glp_simplex on the same instance, objective compared by
// hand) in an image without GLPK: an independent, from-scratch,
// double-precision implementation with Bland anti-cycling and periodic
// refactorization, used by the automated parity harness
// (simplex_tpu_torch/oracle/native.py via ctypes).
//
// Deliberately different from both the CUDA reference and the JAX solver:
// row-major, f64, Gauss-Jordan refactorization, composite Dantzig/Bland
// policy driven by a degeneracy counter.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kEps = 1e-9;        // reduced-cost optimality tolerance
constexpr double kPivotTol = 1e-11;  // ratio-test eligibility
constexpr int kBlandAfter = 64;      // degenerate pivots before Bland kicks in
constexpr int kRefactorEvery = 256;

enum Status : int32_t {
  kRunning = 0,
  kOptimal = 1,
  kUnbounded = 2,
  kMaxIter = 3,
  kSingular = 4,
};

// Invert an m x m row-major matrix by Gauss-Jordan with partial pivoting.
// Returns false if (numerically) singular.
bool InvertInto(std::vector<double> work, int m, std::vector<double>& inv) {
  inv.assign(static_cast<size_t>(m) * m, 0.0);
  for (int i = 0; i < m; ++i) inv[static_cast<size_t>(i) * m + i] = 1.0;
  for (int col = 0; col < m; ++col) {
    int piv = col;
    double best = std::fabs(work[static_cast<size_t>(col) * m + col]);
    for (int r = col + 1; r < m; ++r) {
      double v = std::fabs(work[static_cast<size_t>(r) * m + col]);
      if (v > best) { best = v; piv = r; }
    }
    if (best < 1e-14) return false;
    if (piv != col) {
      for (int j = 0; j < m; ++j) {
        std::swap(work[static_cast<size_t>(piv) * m + j],
                  work[static_cast<size_t>(col) * m + j]);
        std::swap(inv[static_cast<size_t>(piv) * m + j],
                  inv[static_cast<size_t>(col) * m + j]);
      }
    }
    double d = 1.0 / work[static_cast<size_t>(col) * m + col];
    for (int j = 0; j < m; ++j) {
      work[static_cast<size_t>(col) * m + j] *= d;
      inv[static_cast<size_t>(col) * m + j] *= d;
    }
    for (int r = 0; r < m; ++r) {
      if (r == col) continue;
      double f = work[static_cast<size_t>(r) * m + col];
      if (f == 0.0) continue;
      for (int j = 0; j < m; ++j) {
        work[static_cast<size_t>(r) * m + j] -=
            f * work[static_cast<size_t>(col) * m + j];
        inv[static_cast<size_t>(r) * m + j] -=
            f * inv[static_cast<size_t>(col) * m + j];
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Solve max c.x s.t. A x = b, x >= 0 starting from the basis in `basis`
// (basis[i] = column index of the i-th basic variable, A[:, basis] nonsingular).
//
// A is row-major (m x n). Outputs: z, x (length n), basis updated in place,
// iters. Returns a Status code.
int32_t simplex_solve_f64(const double* A, const double* b, const double* c,
                          int32_t m, int32_t n, int32_t max_iter,
                          int32_t* basis, double* z_out, double* x_out,
                          int32_t* iters_out) {
  const size_t mn = static_cast<size_t>(m);
  std::vector<double> B(mn * m), B_inv;
  auto load_basis_matrix = [&]() {
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j)
        B[static_cast<size_t>(i) * m + j] =
            A[static_cast<size_t>(i) * n + basis[j]];
  };
  load_basis_matrix();
  if (!InvertInto(B, m, B_inv)) return kSingular;

  std::vector<double> x_b(m), y(m), e(n), alpha(m);
  auto recompute_primal_dual = [&]() {
    for (int i = 0; i < m; ++i) {
      double s = 0.0;
      for (int j = 0; j < m; ++j) s += B_inv[static_cast<size_t>(i) * m + j] * b[j];
      x_b[i] = s < 0 && s > -1e-11 ? 0.0 : s;
    }
    for (int j = 0; j < m; ++j) {
      double s = 0.0;
      for (int i = 0; i < m; ++i)
        s += c[basis[i]] * B_inv[static_cast<size_t>(i) * m + j];
      y[j] = s;
    }
  };
  recompute_primal_dual();

  int degen = 0;
  int32_t it = 0;
  Status status = kMaxIter;
  for (; it < max_iter; ++it) {
    // pricing: e_j = y.A_j - c_j
    for (int j = 0; j < n; ++j) {
      double s = -c[j];
      for (int i = 0; i < m; ++i) s += y[i] * A[static_cast<size_t>(i) * n + j];
      e[j] = s;
    }
    int p = -1;
    if (degen >= kBlandAfter) {
      for (int j = 0; j < n; ++j)
        if (e[j] < -kEps) { p = j; break; }
      if (p < 0) { status = kOptimal; break; }
    } else {
      double best = -kEps;
      for (int j = 0; j < n; ++j)
        if (e[j] < best) { best = e[j]; p = j; }
      if (p < 0) { status = kOptimal; break; }
    }

    // ftran
    for (int i = 0; i < m; ++i) {
      double s = 0.0;
      for (int j = 0; j < m; ++j)
        s += B_inv[static_cast<size_t>(i) * m + j] *
             A[static_cast<size_t>(j) * n + p];
      alpha[i] = s;
    }

    // ratio test (Bland tie-break on basis index when in fallback mode)
    int q = -1;
    double theta = std::numeric_limits<double>::infinity();
    for (int i = 0; i < m; ++i) {
      if (alpha[i] <= kPivotTol) continue;
      double t = (x_b[i] < 0 ? 0.0 : x_b[i]) / alpha[i];
      bool better = t < theta * (1.0 - 1e-12);
      bool tie = std::fabs(t - theta) <= theta * 1e-12 + 1e-300;
      if (better || q < 0 ||
          (degen >= kBlandAfter && tie && basis[i] < basis[q])) {
        if (better || q < 0) theta = t;
        q = i;
      }
    }
    if (q < 0) { status = kUnbounded; break; }

    degen = (theta <= 1e-12) ? degen + 1 : 0;

    // pivot: product-form rank-1 update of B_inv
    double inv_aq = 1.0 / alpha[q];
    for (int j = 0; j < m; ++j) {
      double rowq = B_inv[static_cast<size_t>(q) * m + j] * inv_aq;
      for (int i = 0; i < m; ++i) {
        if (i == q) continue;
        B_inv[static_cast<size_t>(i) * m + j] -= alpha[i] * rowq;
      }
      B_inv[static_cast<size_t>(q) * m + j] = rowq;
    }
    basis[q] = p;

    if ((it + 1) % kRefactorEvery == 0) {
      load_basis_matrix();
      if (!InvertInto(B, m, B_inv)) { status = kSingular; break; }
    }
    recompute_primal_dual();
  }

  recompute_primal_dual();
  double z = 0.0;
  for (int i = 0; i < m; ++i) z += c[basis[i]] * x_b[i];
  *z_out = z;
  std::memset(x_out, 0, sizeof(double) * static_cast<size_t>(n));
  for (int i = 0; i < m; ++i) x_out[basis[i]] = x_b[i];
  *iters_out = it;
  return status;
}

}  // extern "C"
