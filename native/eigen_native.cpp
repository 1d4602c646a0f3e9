// Native C++ runtime component: CPU oracle + C ABI layer.
//
// Equivalent of the reference's L3 FFI surface
// (wrapper/similarity_transform.cpp: extern "C" make_queue /
// max_eigen_value) and of its host-side orchestrator semantics
// (similarity_transform.cpp:5-75).  Role in this framework:
//
//   * a fast float32 CPU oracle with EXACTLY the parallel convergence
//     semantics (wraparound stop, lambda = v[0], 0-based round count) for
//     large-dim parity tests where the NumPy oracle is slow;
//   * C ABI parity so existing ctypes callers of the reference's
//     libsimilarity_transform.so can point at this library unchanged in
//     shape: make_queue(void**) + max_eigen_value(q, mat, val, vec, dim,
//     iter) -> int64 ms.
//
// This is a from-scratch implementation (no SYCL; plain C++17 +
// OpenMP-if-available); the device compute path of the framework is
// JAX/XLA/Pallas — this library is the host-side runtime piece.

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Context {
  // Reference keeps a sycl::queue behind the handle; the CPU oracle needs
  // only tuning knobs. eps/max_itr mirror include/similarity_transform.hpp:4-5.
  float eps = 1e-3f;
  unsigned max_itr = 1000;
};

// One round's row sums. Plain loops; compilers vectorize this fully.
void row_sums(const float* A, float* v, unsigned n) {
#pragma omp parallel for schedule(static)
  for (long r = 0; r < (long)n; ++r) {
    const float* row = A + (size_t)r * n;
    float acc = 0.0f;
    for (unsigned c = 0; c < n; ++c) acc += row[c];
    v[r] = acc;
  }
}

// Wraparound stop criterion: all |v[i] - v[(i+1) % n]| < eps
// (reference stop kernel, similarity_transform.cpp:385-417).
bool stop(const float* v, unsigned n, float eps) {
  for (unsigned i = 0; i < n; ++i) {
    const float next = v[(i + 1) % n];
    if (!(std::fabs(v[i] - next) < eps)) return false;
  }
  return true;
}

// Similarity update A[r][c] *= (1/v[r]) * v[c]
// (reference compute_next_matrix, similarity_transform.cpp:324-325).
void next_matrix(float* A, const float* v, unsigned n) {
#pragma omp parallel for schedule(static)
  for (long r = 0; r < (long)n; ++r) {
    const float inv_vr = 1.0f / v[r];
    float* row = A + (size_t)r * n;
    for (unsigned c = 0; c < n; ++c) row[c] *= inv_vr * v[c];
  }
}

// Matvec of the ORIGINAL matrix — the power-form hot op
// (ops/solver_matvec.py): y = A @ x, one read of A, no writes.
void matvec(const float* A, const float* x, float* y, unsigned n) {
#pragma omp parallel for schedule(static)
  for (long r = 0; r < (long)n; ++r) {
    const float* row = A + (size_t)r * n;
    float acc = 0.0f;
    for (unsigned c = 0; c < n; ++c) acc += row[c] * x[c];
    y[r] = acc;
  }
}

float find_max(const float* v, unsigned n) {
  float m = 0.0f;  // seeded 0: positivity assumption (cpp:169)
  for (unsigned r = 0; r < n; ++r) m = std::fmax(m, v[r]);
  return m;
}

// Hilbert fixture A[r][c] = 1/(r+c+1) (reference utils.cpp:137-154).
void hilbert(float* A, unsigned n) {
#pragma omp parallel for schedule(static)
  for (long r = 0; r < (long)n; ++r)
    for (unsigned c = 0; c < n; ++c)
      A[(size_t)r * n + c] = 1.0f / (float)(r + c + 1);
}

}  // namespace

extern "C" {

// Handle constructor — ABI shape of reference make_queue
// (wrapper/similarity_transform.cpp:3-12).
void make_queue(void** ctx) { *ctx = new Context(); }

void free_queue(void* ctx) { delete static_cast<Context*>(ctx); }

// Full solve — ABI shape of reference max_eigen_value
// (wrapper/similarity_transform.cpp:14-37). Returns wall ms of the loop
// (matching the reference's timing span, similarity_transform.cpp:36-58).
int64_t max_eigen_value(void* ctx_, float* mat, float* eigen_val,
                        float* eigen_vec, unsigned dim, unsigned* iter_cnt) {
  const Context cfg = ctx_ ? *static_cast<Context*>(ctx_) : Context();
  const size_t n2 = (size_t)dim * dim;

  float* A = static_cast<float*>(std::malloc(sizeof(float) * n2));
  float* v = static_cast<float*>(std::malloc(sizeof(float) * dim));
  std::memcpy(A, mat, sizeof(float) * n2);
  for (unsigned i = 0; i < dim; ++i) eigen_vec[i] = 1.0f;

  const auto start = std::chrono::steady_clock::now();
  unsigned i = 0;
  for (; i < cfg.max_itr; ++i) {
    row_sums(A, v, dim);
    const float m = find_max(v, dim);
    for (unsigned r = 0; r < dim; ++r) eigen_vec[r] *= v[r] / m;
    if (stop(v, dim, cfg.eps)) break;  // break BEFORE the update (cpp:45-52)
    next_matrix(A, v, dim);
  }
  *iter_cnt = i;
  const auto end = std::chrono::steady_clock::now();

  *eigen_val = v[0];  // lambda readout (cpp:60-65)
  std::free(A);
  std::free(v);
  return std::chrono::duration_cast<std::chrono::milliseconds>(end - start)
      .count();
}

// Matvec-form (power-form) solve — the framework's algorithmic fast path
// expressed natively (ops/solver_matvec.py algebra): one matvec against
// the ORIGINAL matrix per round, A never copied or written. Same
// convergence semantics and return convention as max_eigen_value.
int64_t max_eigen_value_matvec(void* ctx_, const float* mat, float* eigen_val,
                               float* eigen_vec, unsigned dim,
                               unsigned* iter_cnt) {
  const Context cfg = ctx_ ? *static_cast<Context*>(ctx_) : Context();
  float* v = static_cast<float*>(std::malloc(sizeof(float) * dim));
  float* y = static_cast<float*>(std::malloc(sizeof(float) * dim));
  for (unsigned i = 0; i < dim; ++i) eigen_vec[i] = 1.0f;

  const auto start = std::chrono::steady_clock::now();
  row_sums(mat, v, dim);  // v0 = A @ ones
  unsigned i = 0;
  float lam = v[0];
  for (; i < cfg.max_itr; ++i) {
    const float m = find_max(v, dim);
    for (unsigned r = 0; r < dim; ++r) eigen_vec[r] *= v[r] / m;
    lam = v[0];  // λ of the round being CHECKED — on cap exhaustion the
                 // convention is the last checked v[0], not the freshly
                 // updated v below (matches max_eigen_value + the oracle)
    if (stop(v, dim, cfg.eps)) break;  // break BEFORE the update
    matvec(mat, eigen_vec, y, dim);
    for (unsigned r = 0; r < dim; ++r) v[r] = y[r] / eigen_vec[r];
  }
  *iter_cnt = i;
  const auto end = std::chrono::steady_clock::now();

  *eigen_val = lam;
  std::free(v);
  std::free(y);
  return std::chrono::duration_cast<std::chrono::milliseconds>(end - start)
      .count();
}

// Per-kernel micro-benchmark (reference benchmark_* family,
// benchmarks/benchmark_similarity_transform.cpp): best-of-`reps` wall µs
// of one kernel launch on a Hilbert fixture. Names: "row_sums",
// "find_max", "eigvec", "stop", "next_matrix", "matvec".
// Returns -1.0 for an unknown name.
double bench_kernel_us(const char* name, unsigned dim, unsigned reps) {
  const size_t n2 = (size_t)dim * dim;
  const bool is_matrix = std::strcmp(name, "row_sums") == 0 ||
                         std::strcmp(name, "next_matrix") == 0 ||
                         std::strcmp(name, "matvec") == 0;
  float* A = nullptr;
  if (is_matrix) {
    A = static_cast<float*>(std::malloc(sizeof(float) * n2));
    hilbert(A, dim);
  }
  float* v = static_cast<float*>(std::malloc(sizeof(float) * dim));
  float* y = static_cast<float*>(std::malloc(sizeof(float) * dim));
  for (unsigned r = 0; r < dim; ++r) v[r] = 1.0f + 1e-4f * (float)(r % 7);

  double best = -1.0;
  volatile float sink = 0.0f;
  for (unsigned rep = 0; rep < reps + 1; ++rep) {  // first rep = warmup
    const auto t0 = std::chrono::steady_clock::now();
    if (std::strcmp(name, "row_sums") == 0) {
      row_sums(A, y, dim);
      sink += y[0];
    } else if (std::strcmp(name, "next_matrix") == 0) {
      next_matrix(A, v, dim);
      sink += A[0];
    } else if (std::strcmp(name, "matvec") == 0) {
      matvec(A, v, y, dim);
      sink += y[0];
    } else if (std::strcmp(name, "find_max") == 0) {
      sink += find_max(v, dim);
    } else if (std::strcmp(name, "eigvec") == 0) {
      for (unsigned r = 0; r < dim; ++r) y[r] = v[r] / 2.0f;
      sink += y[0];
    } else if (std::strcmp(name, "stop") == 0) {
      sink += stop(v, dim, 1e-3f) ? 1.0f : 0.0f;
    } else {
      break;
    }
    const auto t1 = std::chrono::steady_clock::now();
    const double us =
        (double)std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
            .count() /
        1e3;
    if (rep > 0 && (best < 0.0 || us < best)) best = us;
  }
  (void)sink;
  std::free(A);
  std::free(v);
  std::free(y);
  return best;
}

// Device-side Hilbert fixture fill (reference generate_hilbert_matrix).
void generate_hilbert(float* A, unsigned dim) { hilbert(A, dim); }

}  // extern "C"
