// Native text-format loader.
//
// The reference parses its whitespace text format with an O(mn) iostream
// loop (load_matrix_impl, src/v1_baseline.cu:93-103) — fine for a 2x4
// sample, minutes for a gigabyte-scale 8k x 16k instance in Python. This is
// the framework's native data-loader: mmap the file once and parse with
// strtof directly into caller-provided numpy buffers (zero copies beyond the
// parse itself). Python wrapper: simplex_tpu_torch/io/native.py.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

inline void skip_ws(Cursor& c) {
  while (c.p < c.end &&
         (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' || *c.p == '\r'))
    ++c.p;
}

// Parse one float; returns false at end-of-input or on a non-numeric token.
inline bool next_f32(Cursor& c, float* out) {
  skip_ws(c);
  if (c.p >= c.end) return false;
  char* next = nullptr;
  float v = strtof(c.p, &next);
  if (next == c.p) return false;
  c.p = next;
  *out = v;
  return true;
}

inline bool next_i64(Cursor& c, int64_t* out) {
  skip_ws(c);
  if (c.p >= c.end) return false;
  char* next = nullptr;
  long long v = strtoll(c.p, &next, 10);
  if (next == c.p) return false;
  c.p = next;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Read only the "m n" header. Returns 0 on success.
int32_t lp_text_header(const char* path, int64_t* m_out, int64_t* n_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 1;
  char buf[256];
  ssize_t got = read(fd, buf, sizeof(buf) - 1);
  close(fd);
  if (got <= 0) return 2;
  buf[got] = '\0';
  Cursor c{buf, buf + got};
  if (!next_i64(c, m_out) || !next_i64(c, n_out)) return 3;
  if (*m_out <= 0 || *n_out <= 0 || *m_out > *n_out) return 4;
  return 0;
}

// Fill pre-allocated A (m*n row-major), b (m), c (n) from the file.
// Returns 0 on success, >0 on parse failure.
int32_t lp_text_load_f32(const char* path, int64_t m, int64_t n, float* A,
                         float* b, float* c) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return 2;
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_PRIVATE,
           fd, 0));
  close(fd);
  if (data == MAP_FAILED) return 3;

  Cursor cur{data, data + st.st_size};
  int32_t rc = 0;
  int64_t hm = 0, hn = 0;
  if (!next_i64(cur, &hm) || !next_i64(cur, &hn) || hm != m || hn != n) {
    rc = 4;
  } else {
    float v;
    for (int64_t i = 0; i < m * n && rc == 0; ++i) {
      if (!next_f32(cur, &v)) rc = 5;
      else A[i] = v;
    }
    for (int64_t i = 0; i < m && rc == 0; ++i) {
      if (!next_f32(cur, &v)) rc = 6;
      else b[i] = v;
    }
    for (int64_t i = 0; i < n && rc == 0; ++i) {
      if (!next_f32(cur, &v)) rc = 7;
      else c[i] = v;
    }
  }
  munmap(const_cast<char*>(data), static_cast<size_t>(st.st_size));
  return rc;
}

// Writer: dump (A, b, c) in the reference text format. Returns 0 on success.
int32_t lp_text_save_f32(const char* path, int64_t m, int64_t n,
                         const float* A, const float* b, const float* c) {
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  fprintf(f, "%lld %lld\n", static_cast<long long>(m),
          static_cast<long long>(n));
  for (int64_t i = 0; i < m; ++i) {
    for (int64_t j = 0; j < n; ++j)
      fprintf(f, j + 1 < n ? "%.9g " : "%.9g\n", A[i * n + j]);
  }
  for (int64_t i = 0; i < m; ++i)
    fprintf(f, i + 1 < m ? "%.9g " : "%.9g\n", b[i]);
  for (int64_t j = 0; j < n; ++j)
    fprintf(f, j + 1 < n ? "%.9g " : "%.9g\n", c[j]);
  fclose(f);
  return 0;
}

}  // extern "C"
