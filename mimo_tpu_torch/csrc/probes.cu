// Probes S1 and S2 of kernel B1's cost: B1's own kernel (estep.cuh) with
// other template parameters, over the Gauss map, compiled for the plain
// layout's two narrowest widths (m8 <= 16, d <= 3) and the chunked layout,
// which takes every other shape B1 takes. See the note at the top of
// estep.cuh.
#include "estep.cuh"

namespace {

constexpr int kMaxProbeWidth = 2;

// B1's variant where the probes compile it, else the chunked layout where
// it fits; 0 past both.
int probe_variant(int k, int m8, int d) {
  const int v = estep_variant(k, m8, d);
  if (v >= 1 && v <= kMaxProbeWidth) return v;
  return pick_variant(k, m8, [&](int u) {
    return u == kChunked ? estep_floats(u, k, m8, d) : ~(size_t)0 >> 8;
  });
}

}  // namespace

// S1: B1 over the Gauss map (xt (d, ld), points 0..n-1), with (divide =
// 1, B1 itself) or without the normalisation; out as mimo_estep.
extern "C" int mimo_regf(const float* xt, long long ld, int d, long long n,
                         const float* theta, int k, int m8, int divide,
                         float* part, float* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0)) return cudaErrorInvalidValue;
  const int v = probe_variant(k, m8, d);
  const FactorTable tab =
      factor_table(kKindGauss, d, 0, v ? layout(v, k, m8).mpf : 0);
  const cudaError_t err = dispatch_variant<1, kMaxProbeWidth, true>(
      v, cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        return divide ? launch_estep<V, true, kCountArg>(
                            xt, ld, d, n, nullptr, theta, k, m8, tab, part,
                            grid, s)
                      : launch_estep<V, false, kCountArg>(
                            xt, ld, d, n, nullptr, theta, k, m8, tab, part,
                            grid, s);
      });
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}

// S2: B1 over the Gauss map with the valid count given by `mode`
// (CountMode): 1 none, 2 the int32 *nv in device memory passed and not
// read, 3 *nv read and used (points >= min(*nv, n) masked). Modes 1
// and 2 take every point of n, which must be a multiple of 128.
extern "C" int mimo_estep_count(const float* xt, long long ld, int d,
                                long long n, const int* nv, int mode,
                                const float* theta, int k, int m8,
                                float* part, float* out, int grid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0) || mode < kCountNone ||
      mode > kCountMemUsed || (mode != kCountMemUsed && n % 128 != 0))
    return cudaErrorInvalidValue;
  const int v = probe_variant(k, m8, d);
  const FactorTable tab =
      factor_table(kKindGauss, d, 0, v ? layout(v, k, m8).mpf : 0);
  const cudaError_t err = dispatch_variant<1, kMaxProbeWidth, true>(
      v, cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        if (mode == kCountNone)
          return launch_estep<V, true, kCountNone>(
              xt, ld, d, n, nv, theta, k, m8, tab, part, grid, s);
        if (mode == kCountMemUnused)
          return launch_estep<V, true, kCountMemUnused>(
              xt, ld, d, n, nv, theta, k, m8, tab, part, grid, s);
        return launch_estep<V, true, kCountMemUsed>(
            xt, ld, d, n, nv, theta, k, m8, tab, part, grid, s);
      });
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}
