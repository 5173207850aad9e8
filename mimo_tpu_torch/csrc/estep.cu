// Kernel B1's C entries (the kernel: estep.cuh). The wide widths and the
// chunked layout are compiled in estep_wide.cu.
#include "estep.cuh"

// Bytes of shared memory a block stages at (k, m8) over `rows` input rows
// (d + p): those of the variant that runs, or past every variant those
// of the chunked layout, so the launch check can name the size.
extern "C" size_t mimo_estep_smem_bytes(int k, int m8, int rows) {
  const int v = estep_variant(k, m8, rows);
  return sizeof(float) * estep_floats(v ? v : kChunked, k, m8, rows);
}

// The persistent grid along x of B1 (and of its probes) at (k, m8, rows)
// over n points, the same for every chain: 0 for a shape past shared
// memory's limit, minus a CUDA error code on failure.
extern "C" int mimo_estep_grid(int k, int m8, int rows, long long n) {
  const int v = estep_variant(k, m8, rows);
  if (!v) return 0;
  if (is_wide(v)) return mimo_estep_grid_wide(v, k, m8, rows, n);
  return estep_grid_variants<1, kMaxNarrow, false>(v, k, m8, rows, n);
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag, the maps without y), points 0..n-1, shared by the chains;
// theta (chains, k, m8) f32; part (chains, grid, k*m8+1) scratch; out
// (chains, k*m8+1) = [acc row-major, lse] per chain. Returns a cudaError_t
// code.
extern "C" int mimo_estep(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, float* part, float* out, int grid,
                          int chains, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535)
    return cudaErrorInvalidValue;
  const int v = estep_variant(k, m8, d + p);
  const int err =
      is_wide(v) ? mimo_estep_wide(v, xt, ld, d, p, kind, n, theta, k, m8,
                                   part, grid, chains, stream)
                 : estep_variants<1, kMaxNarrow, false>(
                       v, xt, ld, d, p, kind, n, theta, k, m8, part, grid,
                       chains, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s, chains);
}

extern "C" const char* mimo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
