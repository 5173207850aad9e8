// Kernel B2 at the widths above kMaxNarrow (m8 > 64) and in the streamed
// layout: compiled apart from gibbs.cu so that nvcc builds the two in
// parallel. mimo_gibbs and mimo_gibbs_scratch call these.
#include "gibbs.cuh"

namespace {

// The streamed layout's geometry for B2 at (k, m8, rows) on this card;
// returns a CUDA error code.
inline int gibbs_streamed_shape(int k, int m8, int rows, Streamed* out) {
  Streamed g = streamed_shape(k, m8);
  const long long tiles = g.seg / kStT;
  const int ga = persistent_grid(gibbs_st_logits<kStT>, 32 * g.nw,
                                 sizeof(float) * st_logits_floats(g, rows),
                                 tiles, 1);
  if (ga < 0) return -ga;
  const int sp = dispatch_nt(g.nt, -(int)cudaErrorInvalidValue, [&](auto c) {
    return persistent_grid(gibbs_st_stats<decltype(c)::value>, 32 * g.nw,
                           sizeof(float) * st_stats_floats(g, rows), tiles,
                           g.nchunk * g.mw);
  });
  if (sp < 0) return -sp;
  g.ga = ga;
  g.splits = sp;
  *out = g;
  return cudaSuccess;
}

// B2 in the streamed layout: theta (chains, k, m8), seed (chains,),
// labels (chains, n), work the scratch of st_scratch, out (chains, k m8).
inline cudaError_t launch_gibbs_streamed(const float* xt, long long ld,
                                         int d, int p, int kind, long long n,
                                         const float* theta, int k, int m8,
                                         const long long* seed, int* labels,
                                         float* work, float* out, int chains,
                                         cudaStream_t s) {
  Streamed g;
  cudaError_t err =
      static_cast<cudaError_t>(gibbs_streamed_shape(k, m8, d + p, &g));
  if (err != cudaSuccess) return err;
  const StScratch sc = st_scratch(g, k, m8, chains, false);
  auto* tab = reinterpret_cast<unsigned short*>(work + sc.tab);
  auto* thp = reinterpret_cast<float4*>(work + sc.thp);
  auto* sg = reinterpret_cast<float4*>(work + sc.sg);
  float* part = work + sc.part;
  err = cudaMemsetAsync(part, 0, sizeof(float) * (sc.total - sc.part), s);
  if (err == cudaSuccess)
    err = launch_st_prep(theta, k, m8, g, thp, kind, d, p, tab, chains, s);
  if (err != cudaSuccess) return err;
  const size_t smem_a = sizeof(float) * st_logits_floats(g, d + p);
  const size_t smem_b = sizeof(float) * st_stats_floats(g, d + p);
  err = cudaFuncSetAttribute(gibbs_st_logits<kStT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_a);
  if (err != cudaSuccess) return err;
  return dispatch_nt(g.nt, cudaErrorInvalidValue, [&](auto c) {
    constexpr int NT = decltype(c)::value;
    cudaError_t e = cudaFuncSetAttribute(
        gibbs_st_stats<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_b);
    for (long long s0 = 0; e == cudaSuccess && s0 < n; s0 += g.seg) {
      gibbs_st_logits<kStT><<<dim3(g.ga, 1, chains), 32 * g.nw, smem_a,
                              s>>>(xt, ld, d + p, n, s0, thp, k, tab, g,
                                   seed, sg, labels);
      e = cudaGetLastError();
      if (e != cudaSuccess) break;
      gibbs_st_stats<NT><<<dim3(g.nchunk * g.mw, g.splits, chains),
                           32 * g.nw, smem_b, s>>>(
          xt, ld, d + p, n, s0, k, m8, tab, g, labels, part);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess)
      e = launch_reduce(part, g.splits, k * m8, out, s, chains);
    return e;
  });
}

}  // namespace

extern "C" int mimo_gibbs_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8,
                               const long long* seed, int* labels,
                               float* part, int grid, int chains,
                               void* stream) {
  return gibbs_variants<kMaxNarrow + 1, kMaxWidth>(
      v, xt, ld, d, p, kind, n, theta, k, m8, seed, labels, part, grid,
      chains, static_cast<cudaStream_t>(stream));
}

extern "C" int mimo_gibbs_grid_wide(int v, int k, int m8, int rows,
                                    long long n) {
  return gibbs_grid_variants<kMaxNarrow + 1, kMaxWidth>(v, k, m8, rows, n);
}

// B2 in the streamed layout (any k, m8); work: mimo_gibbs_streamed_scratch
// floats; the rest as mimo_gibbs.
extern "C" int mimo_gibbs_streamed(const float* xt, long long ld, int d,
                                   int p, int kind, long long n,
                                   const float* theta, int k, int m8,
                                   const long long* seed, int* labels,
                                   float* work, float* out, int chains,
                                   void* stream) {
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535 ||
      k < 1 || d + p > 254)
    return cudaErrorInvalidValue;
  return launch_gibbs_streamed(xt, ld, d, p, kind, n, theta, k, m8, seed,
                               labels, work, out, chains,
                               static_cast<cudaStream_t>(stream));
}

extern "C" long long mimo_gibbs_streamed_scratch(int k, int m8, int rows,
                                                 int chains) {
  Streamed g;
  const int err = gibbs_streamed_shape(k, m8, rows, &g);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)st_scratch(g, k, m8, chains, false).total;
}
