// Kernel B2's C entries (the kernel: gibbs.cuh). The wide widths and the
// streamed layout are compiled in gibbs_wide.cu.
#include "gibbs.cuh"

namespace {

// The plain layout's persistent grid along x at width v: minus a CUDA
// error code on failure.
int gibbs_grid(int v, int k, int m8, int rows, long long n) {
  if (v > kMaxNarrow) return mimo_gibbs_grid_wide(v, k, m8, rows, n);
  return gibbs_grid_variants<1, kMaxNarrow>(v, k, m8, rows, n);
}

}  // namespace

// out[m] = gumbel_fast(m 2^-23) for every m < 2^23: B2's fast draw, for
// the check of its error bound against the accurate one.
extern "C" int mimo_gumbel_fast(float* out, void* stream) {
  gumbel_fast_table<<<(1 << 23) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(out);
  return cudaGetLastError();
}

// Floats of scratch B2 needs at (k, m8, rows) over n points and `chains`
// chains: the plain layout's per-block partials (chains, grid, k m8) or
// the streamed layout's buffers (tc.cuh st_scratch); minus a CUDA error
// code on failure. Every shape has a layout.
extern "C" long long mimo_gibbs_scratch(int k, int m8, int rows, long long n,
                                        int chains) {
  if (k < 1 || m8 < 1 || rows < 1 || chains < 1 || chains > 65535)
    return -(long long)cudaErrorInvalidValue;
  const int v = gibbs_variant(k, m8, rows);
  if (v == kStreamed) return mimo_gibbs_streamed_scratch(k, m8, rows, chains);
  const int grid = gibbs_grid(v, k, m8, rows, n);
  if (grid < 0) return grid;
  return (long long)chains * grid * k * m8;
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag, the maps without y), points 0..n-1, shared by the chains;
// theta (chains, k, m8) f32; seed (chains,) int64 on the device; labels
// (chains, n) int32; work the mimo_gibbs_scratch floats; out (chains,
// k*m8) acc row-major. Returns a cudaError_t code.
extern "C" int mimo_gibbs(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, const long long* seed, int* labels,
                          float* work, float* out, int chains,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535)
    return cudaErrorInvalidValue;
  const int v = gibbs_variant(k, m8, d + p);
  if (v == kStreamed)
    return mimo_gibbs_streamed(xt, ld, d, p, kind, n, theta, k, m8, seed,
                               labels, work, out, chains, stream);
  const int grid = gibbs_grid(v, k, m8, d + p, n);
  if (grid < 0) return -grid;
  const int err =
      v > kMaxNarrow ? mimo_gibbs_wide(v, xt, ld, d, p, kind, n, theta, k,
                                       m8, seed, labels, work, grid, chains,
                                       stream)
                     : gibbs_variants<1, kMaxNarrow>(
                           v, xt, ld, d, p, kind, n, theta, k, m8, seed,
                           labels, work, grid, chains, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(work, grid, k * m8, out, s, chains);
}
