// Kernel B3: fused posterior-predictive mixture density over the
// full-covariance Gaussian or the diagonal feature map. Replaces
// mimo_tpu/ops/pallas_predict.py::_predict_kernel. predict.cu compiles the
// narrow widths (d <= 8) and the runtime width (d > 32) and holds the C
// entry; predict_wide.cu the padded widths d = 12, 16, 24, 32, so nvcc
// builds the two in parallel.
//
// Per point p < n: the quadratic forms Q_k = thq_k . F over F = [1; x;
// x (x) x] (or [1; x; x^2] for the diagonal Gaussian predictive,
// dist='gaussian'), Q_k = (x - mu_k)' Lmbda_k (x - mu_k) clipped at 0, then
//   lp_k = aux_k - h_k log1p(Q_k / df_k)   (Student-t), or
//   lp_k = aux_k - Q_k / 2                 (moment-matched Gaussian),
// and out[p] = logsumexp_k lp_k. aux (K, 8) holds [aux + log w, h, 1/df].
// The kernel works in log2 units: lp log2(e) = aux log2(e) - h log2(1 +
// Q/df) (Student-t) or aux log2(e) - log2(e) Q / 2 (Gaussian).
//
// What bounds it on the H100: instruction issue (K quads of 1 + d + d^2
// FMAs, K logs and K exps per point) against 4 d bytes in and 4 bytes out
// per point; past d ~ 8 the quads' FMAs alone.
//
// Design (serving.cuh): thq and the rows are staged through shared memory
// in K-chunks, so any K launches; lp goes through log2_1p (a few ulps,
// about a quarter of log1pf's instructions) and the blocked fold
// (fold_group: G components, one max, G + 1 exps), so no (K, B) array
// exists.
// - d <= 8: each point's map lives in registers (PointMap: the Gauss map's
//   distinct entries, 45 at d = 8), a thread owns 2-4 points, and one
//   float4 broadcast of a component's row feeds each point's FMA chain.
// - d = 9..32: d is padded to 12, 16, 24 or 32 (the host picks the width,
//   ops/cuda_predict.py's serving_width) with zero x in registers and zero
//   coefficients (fma(0, 0, s) = s: each chain is the same bit for bit),
//   and the component index is the inner loop: the host lays the
//   coefficients out group-major, term-major (G = 8 components a term, one
//   LDS.128 gives four), a thread owns 2 points with G accumulators each,
//   x lives in registers and each entry x_a x_b is formed once per point
//   and group. A GEMM-shaped loop on the f32 units. The terms of padded
//   coordinates are skipped four at a time (the width is a multiple of 4).
// - d > 32: one point a thread, F's entries formed term by term from x
//   where it lies.
// Every chain is one f32 FMA chain in F's column order, as in the plain
// version (the TPU kernel ran this dot with both operands in a bf16 hi/lo
// split to survive the cancelling quadratic); chip_smoke.py's float64
// precision lines hold it, off the origin too.
#pragma once

#include "serving.cuh"

namespace {

constexpr int kPredictGroup = 8;   // components per blocked fold / group

__host__ __device__ constexpr int predict_points(int m) {
  return m <= 8 ? 4 : 2;
}

// lp (log2 units) of a clipped quad q under a component's aux row
// [aux, h, 1/df, 0].
__device__ __forceinline__ float predict_lp(float q, float4 a,
                                            bool studentt) {
  q = fmaxf(q, 0.0f);
  const float a2 = a.x * kLog2e;
  return studentt ? fmaf(-a.y, log2_1p(q * a.z), a2)
                  : fmaf(-0.5f * kLog2e, q, a2);
}

// B3 at d <= 8 (D > 0; PTS points a thread, component-major rows) or past
// 32 (D = 0, one point a thread).
template <int kMap, int D>
__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ xt, long long ld, int d, long long n,
               const float* __restrict__ thq, int k, int m8,
               const float* __restrict__ aux, int studentt, Plan pl,
               float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  using Map = PointMap<kMap, (D > 0 ? D : 1)>;
  constexpr int PTS = D > 0 ? predict_points(Map::M) : 1;
  constexpr int G = kPredictGroup;
  const Strip s[2] = {{thq, m8, 1}, {aux, 8, 1}};
  const long long tile = (long long)kThreads * PTS;
  float f[PTS][Map::S], mx[PTS], sum[PTS];
  long long base = 0;

  // the clipped quads of component c for each point
  auto quads = [&](const float* row, float (&q)[PTS]) {
    if constexpr (D > 0) {
      map_dots<Map>(row, f, q);
    } else {
      const float* xp = xt + min(base, n - 1);
      q[0] = kMap == kGauss ? gauss_dot_rt(row, xp, ld, d)
                            : diag_dot_rt(row, xp, ld, d);
    }
  };

  for_tiles_and_chunks(
      s, pl, k, (n + tile - 1) / tile, reinterpret_cast<float*>(smem4),
      [&](long long t) {
        base = t * tile + threadIdx.x;
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          mx[i] = -INFINITY;
          sum[i] = 0.0f;
          if constexpr (D > 0) {
            float x[D];
#pragma unroll
            for (int a = 0; a < D; ++a) x[a] = p < n ? xt[a * ld + p] : 0.0f;
            Map::feat(x, f[i]);
          }
        }
      },
      [&](const View& v, int k0, int k1) {
        const int kn = k1 - k0;
        // D > 0: always staged (the launch checks), read with LDS
        const float* th0 = D > 0 ? staged_strip<float>(v, 0) : v.p[0];
        const float* aux0 = D > 0 ? staged_strip<float>(v, 1) : v.p[1];
        int c = 0;
        for (; c + G <= kn; c += G) {
          float lp[PTS][G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float q[PTS];
            quads(th0 + (long long)(c + g) * m8, q);
            const float4 a =
                *reinterpret_cast<const float4*>(aux0 + (c + g) * 8);
#pragma unroll
            for (int i = 0; i < PTS; ++i)
              lp[i][g] = predict_lp(q[i], a, studentt);
          }
#pragma unroll
          for (int i = 0; i < PTS; ++i) fold_group<G>(lp[i], mx[i], sum[i]);
        }
        for (; c < kn; ++c) {   // the chunk's tail, one at a time
          float q[PTS];
          quads(th0 + (long long)c * m8, q);
          const float4 a = *reinterpret_cast<const float4*>(aux0 + c * 8);
#pragma unroll
          for (int i = 0; i < PTS; ++i) {
            const float one[1] = {predict_lp(q[i], a, studentt)};
            fold_group<1>(one, mx[i], sum[i]);
          }
        }
      },
      [&]() {
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          if (p < n) out[p] = fold_result(mx[i], sum[i]);
        }
      });
}

// B3 at the padded widths D = 12, 16, 24, 32 (2 points a thread). th is
// (k / G, M, G): group gi, term t, component g at th[(gi M + t) G + g],
// M = the map's width at D; aux (k, 8); k a multiple of G, the padding
// components' aux [-inf, 0, ...] and coefficients zero.
template <int kMap, int D>
__global__ void __launch_bounds__(kThreads)
predict_wide_kernel(const float* __restrict__ xt, long long ld, int d,
                    long long n, const float* __restrict__ th, int k,
                    const float* __restrict__ aux, int studentt, Plan pl,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  constexpr int PTS = 2;
  constexpr int G = kPredictGroup;
  constexpr int M = kMap == kGauss ? gauss_m(D) : diag_m(D);
  static_assert(D % 4 == 0, "the padded loops step by 4");
  const Strip s[2] = {{th, M * G, 1}, {aux, 8 * G, 1}};
  const long long tile = (long long)kThreads * PTS;
  float x[PTS][D], mx[PTS], sum[PTS];
  long long base = 0;

  // q[i][g] += coefficients of term t (G of them, two float4s) times f[i]
  auto term = [](const float* tc, const float (&f)[PTS],
                 float (&q)[PTS][G]) {
#pragma unroll
    for (int h = 0; h < G / 4; ++h) {
      const float4 c = reinterpret_cast<const float4*>(tc)[h];
      const float e[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < PTS; ++i)
          q[i][4 * h + g] = fmaf(e[g], f[i], q[i][4 * h + g]);
    }
  };

  for_tiles_and_chunks(
      s, pl, k / G, (n + tile - 1) / tile, reinterpret_cast<float*>(smem4),
      [&](long long t) {
        base = t * tile + threadIdx.x;
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          mx[i] = -INFINITY;
          sum[i] = 0.0f;
#pragma unroll
          for (int a = 0; a < D; ++a)
            x[i][a] = a < d && p < n ? xt[a * ld + p] : 0.0f;
        }
      },
      [&](const View& v, int g0, int g1) {
        for (int gi = 0; gi < g1 - g0; ++gi) {
          const float* tg = staged_strip<float>(v, 0) + gi * M * G;
          const float* ag = staged_strip<float>(v, 1) + gi * 8 * G;
          float q[PTS][G];
#pragma unroll
          for (int h = 0; h < G / 4; ++h) {     // column 0, the constant
            const float4 c = reinterpret_cast<const float4*>(tg)[h];
#pragma unroll
            for (int i = 0; i < PTS; ++i) {
              q[i][4 * h] = c.x;
              q[i][4 * h + 1] = c.y;
              q[i][4 * h + 2] = c.z;
              q[i][4 * h + 3] = c.w;
            }
          }
          // the loops over x's coordinates skip the padded ones (a >= d:
          // zero terms of zero coefficients) four at a time
#pragma unroll
          for (int a0 = 0; a0 < D; a0 += 4) {   // columns 1..D, x
            if (a0 < d) {
#pragma unroll
              for (int a = a0; a < a0 + 4; ++a) {
                const float f[PTS] = {x[0][a], x[1][a]};
                term(tg + (1 + a) * G, f, q);
              }
            }
          }
          if constexpr (kMap == kGauss) {
            // columns 1 + D + a D + b, x_a x_b; x_a from where it lies
            // (L1), the next one in flight
            long long pi[PTS];
            float xn[PTS];
#pragma unroll
            for (int i = 0; i < PTS; ++i) {
              pi[i] = min(base + i * kThreads, n - 1);
              xn[i] = xt[pi[i]];
            }
#pragma unroll 1
            for (int a = 0; a < d; ++a) {
              float xa[PTS];
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                xa[i] = xn[i];
                if (a + 1 < d) xn[i] = xt[(a + 1) * ld + pi[i]];
              }
              const float* ta = tg + (1 + D + a * D) * G;
#pragma unroll
              for (int b0 = 0; b0 < D; b0 += 4) {
                if (b0 < d) {
#pragma unroll
                  for (int b = b0; b < b0 + 4; ++b) {
                    const float f[PTS] = {xa[0] * x[0][b], xa[1] * x[1][b]};
                    term(ta + b * G, f, q);
                  }
                }
              }
            }
          } else {
#pragma unroll
            for (int a0 = 0; a0 < D; a0 += 4) {  // columns 1 + D + a, x_a^2
              if (a0 < d) {
#pragma unroll
                for (int a = a0; a < a0 + 4; ++a) {
                  const float f[PTS] = {x[0][a] * x[0][a],
                                        x[1][a] * x[1][a]};
                  term(tg + (1 + D + a) * G, f, q);
                }
              }
            }
          }
          float lp[PTS][G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 a = *reinterpret_cast<const float4*>(ag + g * 8);
#pragma unroll
            for (int i = 0; i < PTS; ++i)
              lp[i][g] = predict_lp(q[i][g], a, studentt);
          }
#pragma unroll
          for (int i = 0; i < PTS; ++i) fold_group<G>(lp[i], mx[i], sum[i]);
        }
      },
      [&]() {
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          if (p < n) out[p] = fold_result(mx[i], sum[i]);
        }
      });
}

template <int kMap, int D>
cudaError_t launch_predict(const float* xt, long long ld, int d, long long n,
                           const float* thq, int k, int m8, const float* aux,
                           int studentt, float* out, cudaStream_t st) {
  constexpr int PTS =
      D > 0 ? predict_points(PointMap<kMap, (D > 0 ? D : 1)>::M) : 1;
  const Strip s[2] = {{thq, m8, 1}, {aux, 8, 1}};
  const Plan pl = make_plan(s, 2, k);
  if (D > 0 && !pl.bufs) return cudaErrorInvalidValue;   // reads with LDS
  const size_t smem = plan_bytes(pl, 2);
  const long long tile = (long long)kThreads * PTS;
  int grid = 0;
  cudaError_t err = serving_launch_grid(predict_kernel<kMap, D>, smem,
                                        (n + tile - 1) / tile, &grid);
  if (err != cudaSuccess) return err;
  predict_kernel<kMap, D><<<grid, kThreads, smem, st>>>(
      xt, ld, d, n, thq, k, m8, aux, studentt, pl, out);
  return cudaGetLastError();
}

template <int kMap, int D>
cudaError_t launch_predict_wide(const float* xt, long long ld, int d,
                                long long n, const float* th, int k,
                                const float* aux, int studentt, float* out,
                                cudaStream_t st) {
  constexpr int G = kPredictGroup;
  constexpr int M = kMap == kGauss ? gauss_m(D) : diag_m(D);
  const Strip s[2] = {{th, M * G, 1}, {aux, 8 * G, 1}};
  const Plan pl = make_plan(s, 2, k / G);
  if (!pl.bufs) return cudaErrorInvalidValue;   // reads with LDS
  const size_t smem = plan_bytes(pl, 2);
  const long long tile = (long long)kThreads * 2;
  int grid = 0;
  cudaError_t err = serving_launch_grid(predict_wide_kernel<kMap, D>, smem,
                                        (n + tile - 1) / tile, &grid);
  if (err != cudaSuccess) return err;
  predict_wide_kernel<kMap, D><<<grid, kThreads, smem, st>>>(
      xt, ld, d, n, th, k, aux, studentt, pl, out);
  return cudaGetLastError();
}

}  // namespace

// predict_wide.cu: B3 at the padded widths (width 12, 16, 24 or 32).
extern "C" int mimo_predict_wide(const float* xt, long long ld, int d,
                                 int width, int kind, long long n,
                                 const float* th, int k, const float* aux,
                                 int studentt, float* out, void* stream);
