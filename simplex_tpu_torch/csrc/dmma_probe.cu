// The sum order of the FP64 tensor cores: each f64 shape of
// mma.sync.aligned (DMMA) against the ascending chain
//   acc = C[i][j];  acc = fma(A[i][k], B[k][j], acc)  for k = 0, 1, ..., K - 1
// (and the descending one), on tiles the caller fills. Replaces no TPU
// kernel: it decides how batch_pricing.cu's float64 shared-A layouts may
// sum. Where every output of a shape equals the ascending chain bit for
// bit, a product that walks the rows in ascending k-steps from row 0 with
// that shape gives the same sums as the per-instance path's DFMA chain.
//
// One warp a tile: A (M x K, row-major), B (K x 8, row-major), C (M x 8);
// the fragments as the PTX ISA lays them out for .row.col f64 (lane = 4 g +
// t): A's element i at row g + 8 (i mod M/8), column t + 4 floor(i / (M/8));
// B's element i at row t + 4 i, column g; C's element i at row g + 8
// floor(i / 2), column 2 t + i mod 2. Each lane also computes the chain of
// its own outputs, in the order asked for. Nothing here bounds anything:
// the probe runs once, on a few million tiles, in milliseconds.

#include <cuda_runtime.h>

// m16n8k{4,8,16} in f64: PTX ISA 7.8 (CUDA 11.8) for sm_90
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 11 || (__CUDACC_VER_MAJOR__ == 11 && __CUDACC_VER_MINOR__ >= 8))
#define SIMPLEX_DMMA_M16 1
#else
#define SIMPLEX_DMMA_M16 0
#endif

namespace {

template <int M, int K>
struct Mma;

template <>
struct Mma<8, 4> {
  __device__ static void run(double (&d)[2], const double (&a)[1], const double (&b)[1],
                             const double (&c)[2]) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
                 : "=d"(d[0]), "=d"(d[1])
                 : "d"(a[0]), "d"(b[0]), "d"(c[0]), "d"(c[1]));
  }
};

#if SIMPLEX_DMMA_M16
template <>
struct Mma<16, 4> {
  __device__ static void run(double (&d)[4], const double (&a)[2], const double (&b)[1],
                             const double (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%7, %8, %9, %10};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]), "d"(c[0]), "d"(c[1]), "d"(c[2]), "d"(c[3]));
  }
};

template <>
struct Mma<16, 8> {
  __device__ static void run(double (&d)[4], const double (&a)[4], const double (&b)[2],
                             const double (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%10, %11, %12, %13};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]), "d"(c[0]),
          "d"(c[1]), "d"(c[2]), "d"(c[3]));
  }
};

template <>
struct Mma<16, 16> {
  __device__ static void run(double (&d)[4], const double (&a)[8], const double (&b)[4],
                             const double (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%16, %17, %18, %19};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]), "d"(c[0]), "d"(c[1]),
          "d"(c[2]), "d"(c[3]));
  }
};
#endif

constexpr int kWarps = 4;

template <int M, int K>
__global__ void __launch_bounds__(32 * kWarps)
    dmma_probe_kernel(const double* A, const double* B, const double* C, double* D, double* R,
                      int tiles, int descending) {
  constexpr int RM = M / 8, NA = M * K / 32, NB = K / 4, NC = 2 * RM;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // whole warps leave: mma.sync needs all 32 lanes of the rest
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* a = A + (size_t)tile * M * K;
  const double* b = B + (size_t)tile * K * 8;
  const double* c = C + (size_t)tile * M * 8;
  double fa[NA], fb[NB], fc[NC], fd[NC];
#pragma unroll
  for (int i = 0; i < NA; ++i) fa[i] = a[(g + 8 * (i % RM)) * K + t + 4 * (i / RM)];
#pragma unroll
  for (int i = 0; i < NB; ++i) fb[i] = b[(t + 4 * i) * 8 + g];
#pragma unroll
  for (int i = 0; i < NC; ++i) fc[i] = c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2];
  Mma<M, K>::run(fd, fa, fb, fc);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    double acc = fc[i];
    for (int s = 0; s < K; ++s) {
      const int k = descending ? K - 1 - s : s;
      acc = fma(a[row * K + k], b[k * 8 + col], acc);
    }
    D[(size_t)tile * M * 8 + row * 8 + col] = fd[i];
    R[(size_t)tile * M * 8 + row * 8 + col] = acc;
  }
}

template <int M, int K>
cudaError_t launch(const double* A, const double* B, const double* C, double* D, double* R,
                   int tiles, int descending, cudaStream_t s) {
  dmma_probe_kernel<M, K><<<(tiles + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(A, B, C, D, R, tiles,
                                                                                descending);
  return cudaGetLastError();
}

}  // namespace

// The shapes this build holds, a bit each: 1 m8n8k4, 2 m16n8k4, 4 m16n8k8,
// 8 m16n8k16.
extern "C" int simplex_dmma_probe_shapes() { return SIMPLEX_DMMA_M16 ? 15 : 1; }

// shape: 0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16. A (tiles, M, K), B
// (tiles, K, 8), C (tiles, M, 8) row-major doubles; D the mma's (tiles, M,
// 8), R the chain's, in ascending k (descending 0) or descending. Returns a
// cudaError_t; a shape this build lacks is cudaErrorNotSupported.
extern "C" int simplex_dmma_probe(int shape, const void* A, const void* B, const void* C, void* D,
                                  void* R, int tiles, int descending, void* stream) {
  const double *a = static_cast<const double*>(A), *b = static_cast<const double*>(B),
               *c = static_cast<const double*>(C);
  double *d = static_cast<double*>(D), *r = static_cast<double*>(R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles < 1 || shape < 0 || shape > 3) return (int)cudaErrorInvalidValue;
  if (!(simplex_dmma_probe_shapes() >> shape & 1)) return (int)cudaErrorNotSupported;
  switch (shape) {
    case 0:
      return (int)launch<8, 4>(a, b, c, d, r, tiles, descending, s);
#if SIMPLEX_DMMA_M16
    case 1:
      return (int)launch<16, 4>(a, b, c, d, r, tiles, descending, s);
    case 2:
      return (int)launch<16, 8>(a, b, c, d, r, tiles, descending, s);
    case 3:
      return (int)launch<16, 16>(a, b, c, d, r, tiles, descending, s);
#endif
  }
  return (int)cudaErrorNotSupported;
}
