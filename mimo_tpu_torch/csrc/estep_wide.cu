// Kernel B1 at the widths above kMaxNarrow (m8 > 64, the ILR maps at
// d >= 5 among them) and in the streamed layout: compiled apart from
// estep.cu so that nvcc builds the two in parallel. mimo_estep,
// mimo_estep_scratch and the probes (probes.cu) call these.
#include "estep.cuh"

namespace {

// out[c ostride] = the compensated sum over blocks b of chain c's lse
// pairs lsep (chains, ga) float2 (sum, compensation).
__global__ void finish_lse(const float2* __restrict__ lsep, int ga,
                           int chains, float* __restrict__ out,
                           size_t ostride) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  float s = 0.0f, cc = 0.0f;
  for (int b = 0; b < ga; ++b) {
    const float2 v = lsep[(size_t)c * ga + b];
    kahan_add(s, cc, v.x - v.y);
  }
  out[(size_t)c * ostride] = s;
}

// The streamed layout's geometry for B1 at (k, m8, rows) on this card;
// returns a CUDA error code.
inline int estep_streamed_shape(int k, int m8, int rows, Streamed* out) {
  Streamed g = streamed_shape(k, m8);
  const long long tiles = g.seg / kStT;
  const int ga = persistent_grid(estep_st_logits<true>, 32 * g.nw,
                                 sizeof(float) * st_logits_floats(g, rows),
                                 tiles, 1);
  if (ga < 0) return -ga;
  const int sp = dispatch_nt(g.nt, -(int)cudaErrorInvalidValue, [&](auto c) {
    return persistent_grid(estep_st_stats<decltype(c)::value>, 32 * g.nw,
                           sizeof(float) * st_stats_floats(g, rows), tiles,
                           g.nchunk * g.mw);
  });
  if (sp < 0) return -sp;
  g.ga = ga;
  g.splits = sp;
  *out = g;
  return cudaSuccess;
}

// B1 in the streamed layout: theta (chains, k, m8), work the scratch of
// st_scratch, out (chains, k m8 + 1) = [acc row-major, lse] per chain.
template <bool kDivide>
cudaError_t launch_estep_streamed(const float* xt, long long ld, int d,
                                  int p, int kind, long long n,
                                  const int* nv, int count,
                                  const float* theta, int k, int m8,
                                  float* work, float* out, int chains,
                                  cudaStream_t s) {
  Streamed g;
  cudaError_t err =
      static_cast<cudaError_t>(estep_streamed_shape(k, m8, d + p, &g));
  if (err != cudaSuccess) return err;
  const StScratch sc = st_scratch(g, k, m8, chains, true);
  auto* tab = reinterpret_cast<unsigned short*>(work + sc.tab);
  auto* thp = reinterpret_cast<float4*>(work + sc.thp);
  auto* sg = reinterpret_cast<float4*>(work + sc.sg);
  auto* md = reinterpret_cast<float2*>(work + sc.md);
  auto* lsep = reinterpret_cast<float2*>(work + sc.lsep);
  float* part = work + sc.part;
  err = cudaMemsetAsync(work + sc.lsep, 0,
                        sizeof(float) * (sc.total - sc.lsep), s);
  if (err == cudaSuccess)
    err = launch_st_prep(theta, k, m8, g, thp, kind, d, p, tab, chains, s);
  if (err != cudaSuccess) return err;
  const size_t smem_a = sizeof(float) * st_logits_floats(g, d + p);
  const size_t smem_b = sizeof(float) * st_stats_floats(g, d + p);
  err = cudaFuncSetAttribute(estep_st_logits<kDivide>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_a);
  if (err != cudaSuccess) return err;
  return dispatch_nt(g.nt, cudaErrorInvalidValue, [&](auto c) {
    constexpr int NT = decltype(c)::value;
    cudaError_t e = cudaFuncSetAttribute(
        estep_st_stats<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_b);
    for (long long s0 = 0; e == cudaSuccess && s0 < n; s0 += g.seg) {
      estep_st_logits<kDivide><<<dim3(g.ga, 1, chains), 32 * g.nw, smem_a,
                                 s>>>(xt, ld, d + p, n, nv, count, s0, thp,
                                      k, tab, g, sg, md, lsep);
      e = cudaGetLastError();
      if (e != cudaSuccess) break;
      estep_st_stats<NT><<<dim3(g.nchunk * g.mw, g.splits, chains),
                           32 * g.nw, smem_b, s>>>(
          xt, ld, d + p, n, nv, count, s0, k, m8, tab, g, sg, md, part);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess)
      e = launch_reduce(part, g.splits, k * m8, out, s, chains,
                        (size_t)k * m8 + 1);
    if (e == cudaSuccess) {
      finish_lse<<<(chains + 127) / 128, 128, 0, s>>>(
          lsep, g.ga, chains, out + (size_t)k * m8, (size_t)k * m8 + 1);
      e = cudaGetLastError();
    }
    return e;
  });
}

}  // namespace

extern "C" int mimo_estep_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8, float* part,
                               int grid, int chains, void* stream) {
  return estep_variants<kMaxNarrow + 1, kMaxWidth>(
      v, xt, ld, d, p, kind, n, theta, k, m8, part, grid, chains,
      static_cast<cudaStream_t>(stream));
}

extern "C" int mimo_estep_grid_wide(int v, int k, int m8, int rows,
                                    long long n) {
  return estep_grid_variants<kMaxNarrow + 1, kMaxWidth>(v, k, m8, rows, n);
}

// B1 in the streamed layout (any k, m8), with the probes' options: the
// valid count `count` (CountMode, nv read for kCountMemUsed) and the
// normalisation `divide`. work: mimo_estep_streamed_scratch floats; out
// as mimo_estep.
extern "C" int mimo_estep_streamed(const float* xt, long long ld, int d,
                                   int p, int kind, long long n,
                                   const int* nv, int count, int divide,
                                   const float* theta, int k, int m8,
                                   float* work, float* out, int chains,
                                   void* stream) {
  if (kind < kKindGauss || kind > kKindLast ||
      m8 < feature_width(kind, d, p) || chains < 1 || chains > 65535 ||
      k < 1 || d + p > 254)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return divide ? launch_estep_streamed<true>(xt, ld, d, p, kind, n, nv,
                                              count, theta, k, m8, work, out,
                                              chains, s)
                : launch_estep_streamed<false>(xt, ld, d, p, kind, n, nv,
                                               count, theta, k, m8, work,
                                               out, chains, s);
}

extern "C" long long mimo_estep_streamed_scratch(int k, int m8, int rows,
                                                 int chains) {
  Streamed g;
  const int err = estep_streamed_shape(k, m8, rows, &g);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)st_scratch(g, k, m8, chains, true).total;
}
