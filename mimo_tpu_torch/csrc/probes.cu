// Probes S1 and S2 of kernel B1's cost: B1's own kernel (estep.cuh) with
// other template parameters, over the Gauss map, compiled for the plain
// layout's two narrowest widths (m8 <= 16, d <= 3); every other shape
// runs B1's streamed layout with the same options (estep_wide.cu). See
// the note at the top of estep.cuh.
#include "estep.cuh"

namespace {

constexpr int kMaxProbeWidth = 2;

// B1's width where the probes compile it, else the streamed layout.
int probe_variant(int k, int m8, int d) {
  const int v = estep_variant(k, m8, d);
  return v >= 1 && v <= kMaxProbeWidth ? v : kStreamed;
}

}  // namespace

// Floats of scratch the probes need at (k, m8) over d rows and n points;
// minus a CUDA error code on failure.
extern "C" long long mimo_probe_scratch(int k, int m8, int d, long long n) {
  if (k < 1 || m8 < 1 || d < 1) return -(long long)cudaErrorInvalidValue;
  const int v = probe_variant(k, m8, d);
  if (v == kStreamed) return mimo_estep_streamed_scratch(k, m8, d, 1);
  const int grid = estep_grid_variants<1, kMaxProbeWidth>(v, k, m8, d, n);
  if (grid < 0) return grid;
  return (long long)grid * ((long long)k * m8 + 1);
}

// S1: B1 over the Gauss map (xt (d, ld), points 0..n-1), with (divide =
// 1, B1 itself) or without the normalisation; work the
// mimo_probe_scratch floats; out as mimo_estep.
extern "C" int mimo_regf(const float* xt, long long ld, int d, long long n,
                         const float* theta, int k, int m8, int divide,
                         float* work, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0)) return cudaErrorInvalidValue;
  const int v = probe_variant(k, m8, d);
  if (v == kStreamed)
    return mimo_estep_streamed(xt, ld, d, 0, kKindGauss, n, nullptr,
                               kCountArg, divide, theta, k, m8, work, out, 1,
                               stream);
  const int grid = estep_grid_variants<1, kMaxProbeWidth>(v, k, m8, d, n);
  if (grid < 0) return -grid;
  const FactorTable tab = factor_table(kKindGauss, d, 0, 8 * v);
  const cudaError_t err = dispatch_variant<1, kMaxProbeWidth>(
      v, cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        return divide ? launch_estep<V, true, kCountArg>(
                            xt, ld, d, n, nullptr, theta, k, m8, tab, work,
                            grid, s)
                      : launch_estep<V, false, kCountArg>(
                            xt, ld, d, n, nullptr, theta, k, m8, tab, work,
                            grid, s);
      });
  if (err != cudaSuccess) return err;
  return launch_reduce(work, grid, k * m8 + 1, out, s);
}

// S2: B1 over the Gauss map with the valid count given by `mode`
// (CountMode): 1 none, 2 the int32 *nv in device memory passed and not
// read, 3 *nv read and used (points >= min(*nv, n) masked). Modes 1
// and 2 take every point of n, which must be a multiple of 128.
extern "C" int mimo_estep_count(const float* xt, long long ld, int d,
                                long long n, const int* nv, int mode,
                                const float* theta, int k, int m8,
                                float* work, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0) || mode < kCountNone ||
      mode > kCountMemUsed || (mode != kCountMemUsed && n % 128 != 0))
    return cudaErrorInvalidValue;
  const int v = probe_variant(k, m8, d);
  if (v == kStreamed)
    return mimo_estep_streamed(xt, ld, d, 0, kKindGauss, n, nv, mode, 1,
                               theta, k, m8, work, out, 1, stream);
  const int grid = estep_grid_variants<1, kMaxProbeWidth>(v, k, m8, d, n);
  if (grid < 0) return -grid;
  const FactorTable tab = factor_table(kKindGauss, d, 0, 8 * v);
  const cudaError_t err = dispatch_variant<1, kMaxProbeWidth>(
      v, cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        if (mode == kCountNone)
          return launch_estep<V, true, kCountNone>(
              xt, ld, d, n, nv, theta, k, m8, tab, work, grid, s);
        if (mode == kCountMemUnused)
          return launch_estep<V, true, kCountMemUnused>(
              xt, ld, d, n, nv, theta, k, m8, tab, work, grid, s);
        return launch_estep<V, true, kCountMemUsed>(
            xt, ld, d, n, nv, theta, k, m8, tab, work, grid, s);
      });
  if (err != cudaSuccess) return err;
  return launch_reduce(work, grid, k * m8 + 1, out, s);
}
