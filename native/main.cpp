// Native CLI driver — the reference's `./run` binary (main.cpp:7-162)
// re-expressed for this framework's native runtime: an end-to-end Hilbert
// sweep table followed by per-kernel sweeps, in the reference's
// fixed-width report format so tables diff side-by-side.
//
// Build + run:  make -C native run && ./native/run
// (The JAX counterpart is `python -m eigen_value.bench`.)

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {
void make_queue(void** ctx);
void free_queue(void* ctx);
int64_t max_eigen_value(void* ctx, float* mat, float* eigen_val,
                        float* eigen_vec, unsigned dim, unsigned* iter_cnt);
int64_t max_eigen_value_matvec(void* ctx, const float* mat, float* eigen_val,
                               float* eigen_vec, unsigned dim,
                               unsigned* iter_cnt);
double bench_kernel_us(const char* name, unsigned dim, unsigned reps);
void generate_hilbert(float* A, unsigned dim);
}

static unsigned g_max_matrix_pow = 13;  // reference main.cpp:23 sweep cap
static unsigned g_max_vector_pow = 25;  // reference main.cpp:78 sweep cap

static void e2e_sweep(void* q, bool matvec_form) {
  std::printf("Similarity Transform (native C++ %s)\n\n",
              matvec_form ? "matvec form" : "iterated form");
  for (unsigned p = 7; p <= g_max_matrix_pow; ++p) {
    const unsigned n = 1u << p;
    float* A = (float*)std::malloc(sizeof(float) * (size_t)n * n);
    float* ev = (float*)std::malloc(sizeof(float) * n);
    float lam = 0.0f;
    unsigned itr = 0;
    generate_hilbert(A, n);
    const int64_t ms = matvec_form
                           ? max_eigen_value_matvec(q, A, &lam, ev, n, &itr)
                           : max_eigen_value(q, A, &lam, ev, n, &itr);
    std::printf("%-5u x %5u\t\t%10lld ms\t\t%6u round(s)\n", n, n,
                (long long)ms, itr);
    std::free(A);
    std::free(ev);
  }
  std::printf("\n");
}

static void kernel_sweep(const char* name, unsigned lo_pow, unsigned hi_pow) {
  std::printf("%s\n\n", name);
  for (unsigned p = lo_pow; p <= hi_pow; ++p) {
    const unsigned n = 1u << p;
    const double us = bench_kernel_us(name, n, 3);
    std::printf("%-10u\t\t%12.1f us\n", n, us);
  }
  std::printf("\n");
}

int main(int argc, char** argv) {
  // ./run [max_matrix_pow] [max_vector_pow] — defaults reproduce the
  // reference's full sweeps; smaller caps give a quick smoke run (used by
  // the test suite: ./run 8 17).
  if (argc > 1) g_max_matrix_pow = (unsigned)std::atoi(argv[1]);
  if (argc > 2) g_max_vector_pow = (unsigned)std::atoi(argv[2]);

  void* q = nullptr;
  make_queue(&q);

  e2e_sweep(q, /*matvec_form=*/false);
  e2e_sweep(q, /*matvec_form=*/true);

  // matrix kernels: 2^7..2^13 (reference main.cpp:39)
  kernel_sweep("row_sums", 7, g_max_matrix_pow);
  kernel_sweep("next_matrix", 7, g_max_matrix_pow);
  kernel_sweep("matvec", 7, g_max_matrix_pow);
  // vector kernels: 2^16..2^25 (reference main.cpp:78)
  kernel_sweep("find_max", 16, g_max_vector_pow);
  kernel_sweep("eigvec", 16, g_max_vector_pow);
  kernel_sweep("stop", 16, g_max_vector_pow);

  free_queue(q);
  return 0;
}
