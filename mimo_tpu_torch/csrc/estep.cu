// Kernel B1's C entries (the kernel: estep.cuh). The wide widths and the
// streamed layout are compiled in estep_wide.cu.
#include "estep.cuh"

namespace {

// The plain layout's persistent grid along x at width v: minus a CUDA
// error code on failure.
int estep_grid(int v, int k, int m8, int rows, long long n) {
  if (v > kMaxNarrow) return mimo_estep_grid_wide(v, k, m8, rows, n);
  return estep_grid_variants<1, kMaxNarrow>(v, k, m8, rows, n);
}

}  // namespace

// Floats of scratch B1 needs at (k, m8, rows) over n points and `chains`
// chains: the plain layout's per-block partials (chains, grid, k m8 + 1)
// or the streamed layout's buffers (tc.cuh st_scratch); minus a CUDA
// error code on failure. Every shape has a layout.
extern "C" long long mimo_estep_scratch(int k, int m8, int rows, long long n,
                                        int chains) {
  if (k < 1 || m8 < 1 || rows < 1 || chains < 1 || chains > 65535)
    return -(long long)cudaErrorInvalidValue;
  const int v = estep_variant(k, m8, rows);
  if (v == kStreamed) return mimo_estep_streamed_scratch(k, m8, rows, chains);
  const int grid = estep_grid(v, k, m8, rows, n);
  if (grid < 0) return grid;
  return (long long)chains * grid * ((long long)k * m8 + 1);
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag, the maps without y), points 0..n-1, shared by the chains;
// theta (chains, k, m8) f32; work the mimo_estep_scratch floats; out
// (chains, k*m8+1) = [acc row-major, lse] per chain. Returns a
// cudaError_t code.
extern "C" int mimo_estep(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, float* work, float* out, int chains,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535)
    return cudaErrorInvalidValue;
  const int v = estep_variant(k, m8, d + p);
  if (v == kStreamed)
    return mimo_estep_streamed(xt, ld, d, p, kind, n, nullptr, kCountArg, 1,
                               theta, k, m8, work, out, chains, stream);
  const int grid = estep_grid(v, k, m8, d + p, n);
  if (grid < 0) return -grid;
  const int err =
      v > kMaxNarrow ? mimo_estep_wide(v, xt, ld, d, p, kind, n, theta, k,
                                       m8, work, grid, chains, stream)
                     : estep_variants<1, kMaxNarrow>(v, xt, ld, d, p, kind,
                                                     n, theta, k, m8, work,
                                                     grid, chains, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(work, grid, k * m8 + 1, out, s, chains);
}

extern "C" const char* mimo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
