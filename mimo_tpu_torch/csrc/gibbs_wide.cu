// Kernel B2 at the widths above kMaxNarrow (m8 > 64) and in the chunked
// layout: compiled apart from gibbs.cu so that nvcc builds the two in
// parallel. mimo_gibbs and mimo_gibbs_grid call these.
#include "gibbs.cuh"

extern "C" int mimo_gibbs_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8,
                               const long long* seed, int* labels,
                               float* part, int grid, int chains,
                               void* stream) {
  return gibbs_variants<kMaxNarrow + 1, kMaxWidth, true>(
      v, xt, ld, d, p, kind, n, theta, k, m8, seed, labels, part, grid,
      chains, static_cast<cudaStream_t>(stream));
}

extern "C" int mimo_gibbs_grid_wide(int v, int k, int m8, int rows,
                                    long long n) {
  return gibbs_grid_variants<kMaxNarrow + 1, kMaxWidth, true>(v, k, m8, rows,
                                                              n);
}
