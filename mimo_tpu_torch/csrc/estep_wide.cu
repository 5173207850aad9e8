// Kernel B1 at the widths above kMaxNarrow (m8 > 64, the ILR maps at
// d >= 5 among them) and in the chunked layout: compiled apart from
// estep.cu so that nvcc builds the two in parallel. mimo_estep and
// mimo_estep_grid call these.
#include "estep.cuh"

extern "C" int mimo_estep_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8, float* part,
                               int grid, int chains, void* stream) {
  return estep_variants<kMaxNarrow + 1, kMaxWidth, true>(
      v, xt, ld, d, p, kind, n, theta, k, m8, part, grid, chains,
      static_cast<cudaStream_t>(stream));
}

extern "C" int mimo_estep_grid_wide(int v, int k, int m8, int rows,
                                    long long n) {
  return estep_grid_variants<kMaxNarrow + 1, kMaxWidth, true>(v, k, m8, rows,
                                                              n);
}
