// Kernels B5 and B6: fused posterior-predictive regression of a mixture
// of linear experts (ILR) — input-conditional Student-t expert weights,
// the moment-matched mixture mean and variance (or the argmax expert's,
// prediction='mode') and, with y, the negative log predictive density,
// in one pass over the points. Replace
// mimo_tpu/ops/pallas_predict.py::_ilr_predict_kernel (B5, p = 1;
// ilr_predict.cu) and ::_ilr_p_predict_kernel (B6, p > 1, MNW or MNG
// experts; ilr_p_predict.cu).
//
// Per point, for each component k (coefficients from
// ops/cuda_ilr_predict.py; rows of stride m8):
//   qb_k = max(th_b . G, 0)      basis Student-t quad
//   c_k  = 1 + max(th_c . G, 0)  the experts' input scale 1 + xt' K^-1 xt
//   mu_kj = th_m . G             expert means (j-major row blocks for B6)
//   lw_k = aux0 - aux1 log1p(qb_k aux2)   unnormalised log weights
// over G = [1; x; x (x) x] (the first 1 + d + d^2 columns of each row).
// B5 (p = 1): with y, bq_k = psi_k (y - mu_k)^2 (MNG experts: psi =
// 1 / (2 beta), y_h = alpha + 1/2, same formula).
// B6 (p > 1): with y, bq_k = max(th_q . F, 0) = (y - mu_k)' psi_k
// (y - mu_k) over the joint map F = [1; x; x (x) x; y; x (x) y; y (x) y].
// lp_y_k = y_aux - p/2 log c_k - y_h log1p(bq_k / c_k), or, for MNG
// experts (`diag`, a product of per-output t's sharing c_k),
// lp_y_k = y_aux - p/2 log c_k - sum_j h_kj log1p(v_kj / c_k) with
// v_kj = max(th_v . F, 0) = (y_j - mu_kj)^2 / (2 beta_kj), and
//   mean_j = sum_k w_k mu_kj,
//   var_j = sum_k w_k (c_k vc_kj + (mu_kj - mean_j)^2),
//   nlpd = -(logsumexp_k (lp_y_k + lw_k) - logsumexp_k lw_k),
// with w the softmax of lw ('average') or the one-hot of its
// first-occurrence argmax ('mode'; the NLPD keeps the soft weights).
// out (2p + 2, n) rows = [mean (p), var (p), nlpd, lse_w]; nlpd = 0
// without y.
//
// What bounds them on the H100: arithmetic. A point is 4 (d + p) bytes
// in and 4 (2p + 2) out, against (3 + p) K quads and ~5 K transcendentals.
//
// Design (serving.cuh). The rows, aux and vc are streamed through shared
// memory in K-chunks (cp.async, two buffers when K does not fit at once),
// so any K launches. At compiled widths (d <= 8; B6 also p = 2, 3) d and
// p are template parameters: a thread owns 1-4 points, holds its points'
// maps (their distinct entries: PointMap, JointMap) and every running sum
// in registers, reads each row once as float4 broadcasts for all of them;
// each quad sums the map's real width, not m8. Wider maps take a
// runtime-width path (one point a thread; B6's running sums in the output
// rows). K is folded once with an online softmax of one exp per fold: a
// running max with the rescaled sum of w, the NLPD's exp-sum and, per
// output, the first and second moments about the mean of the component
// holding the max (moments_add), so the TPU kernel's (K, B) arrays never
// exist and the variance does not cancel; 'mode' carries the running
// best's means and c vc_j instead. Per (component, point) c_k costs one
// reciprocal and one log, shared by its rows, both the MUFU's (__fdividef,
// __logf: ~2^-21 absolute on log c, which enters lp_y times p/2, against
// NLPD roundings of ~1e-5 nats); the log1p's keep the accurate log1pf,
// whose tiny arguments are scaled by h ~ N_k. The TPU kernel ran its dots
// with both operands in a bf16 hi/lo split; here each is one f32 FMA
// chain (chip_smoke.py's float64 precision line holds it).
#pragma once

#include "serving.cuh"

namespace {

__host__ __device__ constexpr int b5_points(int d) {
  return d == 0 ? 1 : d <= 2 ? 4 : 2;
}
__host__ __device__ constexpr int b6_points(int d) {
  return d == 0 || d > 4 ? 1 : 2;
}

// B5: th (3k, m8) rows [basis quad; c quad; expert mean]; aux (k, 8)
// cols [log w + basis aux, basis h, basis 1/df, var coef, psi, y_aux,
// y_h, 0]; xt (d + has_y, ld); out (4, n).
template <int D>
__global__ void __launch_bounds__(kThreads)
ilr_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                   int has_y, long long n, const float* __restrict__ th,
                   int k, int m8, const float* __restrict__ aux, int hard,
                   Plan pl, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  using Map = PointMap<kGauss, (D > 0 ? D : 1)>;
  constexpr int PTS = b5_points(D);
  const Strip s[2] = {{th, m8, 3}, {aux, 8, 1}};
  const long long tile = (long long)kThreads * PTS;
  float f[PTS][Map::S], y[PTS];
  float mw[PTS], s0[PTS], ref[PTS], s1[PTS], s2[PTS], ms[PTS], ss[PTS];
  float bestv[PTS], best_mu[PTS], best_var[PTS];
  long long base = 0;

  // fold component (a0, a4) with quads (qb, cq, mu) into point i's sums
  auto fold = [&](int i, float qb, float cq, float mu, const float4& a0,
                  const float4& a4) {
    const float lw = a0.x - a0.y * log1pf(qb * a0.z);
    const float cvc = cq * a0.w;
    const bool up = lw > mw[i];
    const float s0_before = s0[i];
    float scale;
    const float w = online_add(lw, mw[i], s0[i], scale);
    if (!hard)
      moments_add(up, s0_before, scale, w, mu, cvc, ref[i], s1[i], s2[i]);
    else if (lw > bestv[i]) {  // strict: the first occurrence wins ties
      bestv[i] = lw;
      best_mu[i] = mu;
      best_var[i] = cvc;
    }
    if (has_y) {
      const float yc = y[i] - mu;
      const float lp_y = a4.y - 0.5f * __logf(cq) -
                         a4.z * log1pf(__fdividef(a4.x * yc * yc, cq));
      online_add(lp_y + lw, ms[i], ss[i], scale);
    }
  };

  for_tiles_and_chunks(
      s, pl, k, (n + tile - 1) / tile, reinterpret_cast<float*>(smem4),
      [&](long long t) {
        base = t * tile + threadIdx.x;
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          const bool in = p < n;
          if constexpr (D > 0) {
            float x[D];
#pragma unroll
            for (int a = 0; a < D; ++a) x[a] = in ? xt[a * ld + p] : 0.0f;
            Map::feat(x, f[i]);
          }
          y[i] = in && has_y ? xt[d * ld + p] : 0.0f;
          mw[i] = ms[i] = bestv[i] = -INFINITY;
          s0[i] = ref[i] = s1[i] = s2[i] = ss[i] = 0.0f;
          best_mu[i] = best_var[i] = 0.0f;
        }
      },
      [&](const View& v, int k0, int k1) {
        for (int kk = k0; kk < k1; ++kk) {
          const long long c = kk - k0;
          const float* rb = v.p[0] + c * m8;
          const float4* a = reinterpret_cast<const float4*>(v.p[1] + c * 8);
          const float4 a0 = a[0], a4 = a[1];
          if constexpr (D > 0) {
            float qb[PTS], cq[PTS], mu[PTS];
            map_dots<Map>(rb, f, qb);
            map_dots<Map>(rb + v.bs[0], f, cq);
            map_dots<Map>(rb + 2 * v.bs[0], f, mu);
#pragma unroll
            for (int i = 0; i < PTS; ++i)
              fold(i, fmaxf(qb[i], 0.0f), 1.0f + fmaxf(cq[i], 0.0f), mu[i],
                   a0, a4);
          } else if (base < n) {
            const float* xp = xt + base;
            fold(0, fmaxf(gauss_dot_rt(rb, xp, ld, d), 0.0f),
                 1.0f + fmaxf(gauss_dot_rt(rb + v.bs[0], xp, ld, d), 0.0f),
                 gauss_dot_rt(rb + 2 * v.bs[0], xp, ld, d), a0, a4);
          }
        }
      },
      [&]() {
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          if (p >= n) continue;
          const float lse_w = mw[i] + logf(s0[i]);
          const float2 mv = moments_out(ref[i], s1[i], s2[i], s0[i]);
          out[p] = hard ? best_mu[i] : mv.x;
          out[n + p] = hard ? best_var[i] : mv.y;
          out[2 * n + p] = has_y ? -((ms[i] + logf(ss[i])) - lse_w) : 0.0f;
          out[3 * n + p] = lse_w;
        }
      });
}

// Row blocks of B6's coefficient matrix: basis quad, c quad and np mean
// blocks, then with y the MVT quad (MNW) or np scaled per-output quads
// (MNG, `diag`).
__host__ __device__ inline int p_predict_blocks(int np, int has_y, int diag) {
  return 2 + np + (has_y ? (diag ? np : 1) : 0);
}

// B6: th (p_predict_blocks k, m8) row blocks [basis quad; c quad; expert
// means (np blocks, row j k + kk); with y the MVT quad, or for `diag` the
// scaled quads (np blocks, row (2 + np + j) k + kk)]. The basis, c and
// mean rows read their first 1 + d + d^2 columns (the Gauss map), the
// quads the joint map (m8 pads it with y, the Gauss map without). aux
// (k, 8) cols [log w + basis aux, basis h, basis 1/df, y_aux, y_h, 0, 0,
// 0]; vc (k, np) variance coefficients, or (k, 2 np) [vcoef | h] for
// `diag`; xt (d + has_y np, ld); out (2 np + 2, n). D, P > 0: compiled
// widths (the running sums in registers); D = P = 0: runtime widths, one
// point a thread, its sums kept in its own columns of out and its
// moments' reference means in its columns of `refs` (np, n).
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
ilr_p_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                     int np, int has_y, int diag, long long n,
                     const float* __restrict__ th, int k, int m8,
                     const float* __restrict__ aux,
                     const float* __restrict__ vc, int hard, Plan pl,
                     float* __restrict__ out, float* __restrict__ refs) {
  extern __shared__ float4 smem4[];
  using JMap = JointMap<(D > 0 ? D : 1), (P > 0 ? P : 1)>;
  using GMap = typename JMap::G;
  constexpr int PTS = b6_points(D);
  constexpr int PX = P > 0 ? P : 1;
  const int vs = diag ? 2 * np : np;
  const Strip s[3] = {{th, m8, p_predict_blocks(np, has_y, diag)},
                      {aux, 8, 1}, {vc, vs, 1}};
  const long long tile = (long long)kThreads * PTS;
  // per output j: moments_add's reference mean and sums (or, for 'mode',
  // the running best's mean and c vc_j in am and as)
  float f[PTS][JMap::S], rf[PTS][PX], am[PTS][PX], as[PTS][PX];
  float mw[PTS], s0[PTS], ms[PTS], ss[PTS], bestv[PTS];
  long long base = 0;

  for_tiles_and_chunks(
      s, pl, k, (n + tile - 1) / tile, reinterpret_cast<float*>(smem4),
      [&](long long t) {
        base = t * tile + threadIdx.x;
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          const bool in = p < n;
          if constexpr (D > 0) {
            float x[D], y[P];
#pragma unroll
            for (int a = 0; a < D; ++a) x[a] = in ? xt[a * ld + p] : 0.0f;
#pragma unroll
            for (int j = 0; j < P; ++j) {
              y[j] = in && has_y ? xt[(D + j) * ld + p] : 0.0f;
              rf[i][j] = am[i][j] = as[i][j] = 0.0f;
            }
            JMap::feat(x, y, f[i]);
          } else if (in) {
            for (int j = 0; j < 2 * np; ++j) out[j * n + p] = 0.0f;
            for (int j = 0; j < np; ++j) refs[j * n + p] = 0.0f;
          }
          mw[i] = ms[i] = bestv[i] = -INFINITY;
          s0[i] = ss[i] = 0.0f;
        }
      },
      [&](const View& v, int k0, int k1) {
        const long long bs = v.bs[0];
        for (int kk = k0; kk < k1; ++kk) {
          const long long c = kk - k0;
          const float* r0 = v.p[0] + c * m8;   // block b's row: r0 + b bs
          const float4 a = *reinterpret_cast<const float4*>(v.p[1] + c * 8);
          const float yh = v.p[1][c * 8 + 4];
          const float* vk = v.p[2] + c * vs;
          if constexpr (D > 0) {
            float lw[PTS], cq[PTS], scale[PTS], w[PTS], s0_before[PTS];
            bool up[PTS];
            {
              float qb[PTS];
              map_dots<GMap>(r0, f, qb);
              map_dots<GMap>(r0 + bs, f, cq);
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                lw[i] = a.x - a.y * log1pf(fmaxf(qb[i], 0.0f) * a.z);
                cq[i] = 1.0f + fmaxf(cq[i], 0.0f);
                up[i] = lw[i] > mw[i];
                s0_before[i] = s0[i];
                w[i] = online_add(lw[i], mw[i], s0[i], scale[i]);
              }
            }
#pragma unroll
            for (int j = 0; j < P; ++j) {
              float mu[PTS];
              map_dots<GMap>(r0 + (2 + j) * bs, f, mu);
              const float vcj = vk[j];
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                const float cvc = cq[i] * vcj;
                if (hard) {
                  if (lw[i] > bestv[i]) {  // strict: first occurrence wins
                    am[i][j] = mu[i];
                    as[i][j] = cvc;
                  }
                } else {
                  moments_add(up[i], s0_before[i], scale[i], w[i], mu[i], cvc,
                              rf[i][j], am[i][j], as[i][j]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < PTS; ++i) bestv[i] = fmaxf(bestv[i], lw[i]);
            if (has_y) {
              float tail[PTS], inv_c[PTS];
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                tail[i] = 0.0f;
                inv_c[i] = __fdividef(1.0f, cq[i]);
              }
              if (diag) {  // product of per-output t tails sharing c
#pragma unroll
                for (int j = 0; j < P; ++j) {
                  float v[PTS];
                  map_dots<JMap>(r0 + (2 + P + j) * bs, f, v);
                  const float hj = vk[P + j];
#pragma unroll
                  for (int i = 0; i < PTS; ++i)
                    tail[i] += hj * log1pf(fmaxf(v[i], 0.0f) * inv_c[i]);
                }
              } else {
                float v[PTS];
                map_dots<JMap>(r0 + (2 + P) * bs, f, v);
#pragma unroll
                for (int i = 0; i < PTS; ++i)
                  tail[i] = yh * log1pf(fmaxf(v[i], 0.0f) * inv_c[i]);
              }
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                const float lp_y = a.w - 0.5f * P * __logf(cq[i]) - tail[i];
                float sc;
                online_add(lp_y + lw[i], ms[i], ss[i], sc);
              }
            }
          } else if (base < n) {
            const float* zp = xt + base;
            const float lw =
                a.x - a.y * log1pf(fmaxf(gauss_dot_rt(r0, zp, ld, d), 0.0f) *
                                   a.z);
            const float cq =
                1.0f + fmaxf(gauss_dot_rt(r0 + bs, zp, ld, d), 0.0f);
            const bool up = lw > mw[0];
            const float s0_before = s0[0];
            float scale;
            const float w = online_add(lw, mw[0], s0[0], scale);
            const bool better = lw > bestv[0];  // first occurrence wins
            for (int j = 0; j < np; ++j) {
              const float mu = gauss_dot_rt(r0 + (2 + j) * bs, zp, ld, d);
              const float cvc = cq * vk[j];
              float* om = out + j * n + base;
              float* os = out + (np + j) * n + base;
              if (hard) {
                if (better) {
                  *om = mu;
                  *os = cvc;
                }
              } else {
                moments_add(up, s0_before, scale, w, mu, cvc,
                            refs[j * n + base], *om, *os);
              }
            }
            bestv[0] = fmaxf(bestv[0], lw);
            if (has_y) {
              const float inv_c = __fdividef(1.0f, cq);
              float tail = 0.0f;
              if (diag) {
                for (int j = 0; j < np; ++j)
                  tail += vk[np + j] *
                          log1pf(fmaxf(joint_dot_rt(r0 + (2 + np + j) * bs, zp,
                                                    ld, d, np),
                                       0.0f) * inv_c);
              } else {
                tail = yh * log1pf(fmaxf(joint_dot_rt(r0 + (2 + np) * bs, zp,
                                                      ld, d, np),
                                         0.0f) * inv_c);
              }
              const float lp_y = a.w - 0.5f * np * __logf(cq) - tail;
              online_add(lp_y + lw, ms[0], ss[0], scale);
            }
          }
        }
      },
      [&]() {
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          if (p >= n) continue;
          const float lse_w = mw[i] + logf(s0[i]);
          const int npp = P > 0 ? P : np;
          auto emit = [&](int j, float ref, float a1, float a2) {
            const float2 mv = hard ? make_float2(a1, a2)
                                   : moments_out(ref, a1, a2, s0[i]);
            out[j * n + p] = mv.x;
            out[(npp + j) * n + p] = mv.y;
          };
          if constexpr (P > 0) {
#pragma unroll
            for (int j = 0; j < P; ++j) emit(j, rf[i][j], am[i][j], as[i][j]);
          } else {
            for (int j = 0; j < np; ++j)
              emit(j, refs[j * n + p], out[j * n + p], out[(np + j) * n + p]);
          }
          out[2 * npp * n + p] =
              has_y ? -((ms[i] + logf(ss[i])) - lse_w) : 0.0f;
          out[(2 * npp + 1) * n + p] = lse_w;
        }
      });
}

}  // namespace
