// Kernel B2's C entries (the kernel: gibbs.cuh). The wide widths and the
// chunked layout are compiled in gibbs_wide.cu.
#include "gibbs.cuh"

// Bytes of shared memory a block stages at (k, m8) over `rows` input
// rows: those of the variant that runs, or past every variant those of
// the chunked layout.
extern "C" size_t mimo_gibbs_smem_bytes(int k, int m8, int rows) {
  const int v = gibbs_variant(k, m8, rows);
  return sizeof(float) * gibbs_floats(v ? v : kChunked, k, m8, rows);
}

// out[m] = gumbel_fast(m 2^-23) for every m < 2^23: B2's fast draw, for
// the check of its error bound against the accurate one.
extern "C" int mimo_gumbel_fast(float* out, void* stream) {
  gumbel_fast_table<<<(1 << 23) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(out);
  return cudaGetLastError();
}

// The persistent grid along x of B2 at (k, m8, rows) over n points, the
// same for every chain: 0 for a shape past shared memory's limit, minus a
// CUDA error code on failure.
extern "C" int mimo_gibbs_grid(int k, int m8, int rows, long long n) {
  const int v = gibbs_variant(k, m8, rows);
  if (!v) return 0;
  if (is_wide(v)) return mimo_gibbs_grid_wide(v, k, m8, rows, n);
  return gibbs_grid_variants<1, kMaxNarrow, false>(v, k, m8, rows, n);
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag, the maps without y), points 0..n-1, shared by the chains;
// theta (chains, k, m8) f32; seed (chains,) int64 on the device; labels
// (chains, n) int32; part (chains, grid, k*m8) scratch; out (chains, k*m8)
// acc row-major. Returns a cudaError_t code.
extern "C" int mimo_gibbs(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, const long long* seed, int* labels,
                          float* part, float* out, int grid, int chains,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535)
    return cudaErrorInvalidValue;
  const int v = gibbs_variant(k, m8, d + p);
  const int err =
      is_wide(v) ? mimo_gibbs_wide(v, xt, ld, d, p, kind, n, theta, k, m8,
                                   seed, labels, part, grid, chains, stream)
                 : gibbs_variants<1, kMaxNarrow, false>(
                       v, xt, ld, d, p, kind, n, theta, k, m8, seed, labels,
                       part, grid, chains, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8, out, s, chains);
}
