// Kernel B4: fused Student-t posterior-predictive mixture density of a
// diagonal-covariance (Normal-Gamma) Gaussian mixture. Replaces
// mimo_tpu/ops/pallas_predict.py::_diag_predict_kernel.
//
// The joint predictive of a component is a product of per-dimension
// univariate t's, so the tail transform is per (component, dim):
//   u_kj   = max(thu_kj . F, 0) = (lam_kj / df_kj) (x_j - mu_kj)^2,
//   lp_k   = aux_k - sum_j h_kj log1p(u_kj),
//   out[p] = logsumexp_k lp_k,
// with F = [1; x; x^2] and aux_k the gammaln_diff normaliser plus log w.
// Row (k, j) of the TPU kernel's thu is a square in x_j alone: its nonzero
// columns are 0, 1 + j and 1 + d + j. So B4's coefficients are one float4
// per (k, j), row-major, [th_0, th_{1+j}, th_{1+d+j}, h_kj] with h_kj =
// 0.5 (df_kj + 1), and per component [aux_k, hs_k], hs = h_k where h_kj
// is the same in every dim, else 0 (ops/cuda_diag_predict.py builds both;
// its plain version reads the same rows). The kernel works in log2 units:
// lp log2(e) = aux log2(e) - sum_j h_kj log2(1 + u_kj).
//
// Quadratic form: the expanded form, as on the TPU, summed in column order
// th_0 + th_{1+j} x_j + th_{1+d+j} x_j^2. Its cancellation (r mu^2 -
// 2 r mu x + r x^2) costs ~eps r x^2 absolutely; chip_smoke.py's float64
// precision lines hold the kernel to the f32 plain version's error, 10
// sigma off the origin too.
//
// What bounds it on the H100: instruction issue. A point is 4 d bytes in
// and 4 bytes out; per (point, component) the least work is the d scaled
// squares and, where h is shared across dims (every component the models
// build: the posterior alpha is the prior's, equal across dims, plus
// N_k / 2), one log and one exp.
//
// Design (serving.cuh):
// - one log per component where h is shared: sum_j h log1p(u_j) =
//   h log1p(U) with 1 + U = prod_j (1 + u_j), U folded as U + u + U u (no
//   term negative, nothing cancels); a point far enough from a component
//   that U overflows takes the per-dim sum for that component instead;
// - log2_1p, a log1p of a few ulps relative for small u at a quarter of
//   log1pf's instructions, in log2 units; components with unequal h take
//   it per dim;
// - the blocked fold: G components' lp in registers, one max and G + 1
//   exps (fold_group);
// - compiled widths d = 1..8, 12, 16, 24, 32 (the host picks one,
//   ops/cuda_predict.py's serving_width): d is padded to it with zero rows
//   (the host lays them out) and zero x in registers, and fma(0, 0, s) =
//   s, so each component's per-dim sum is the same bit for bit;
//   x lives in registers and a thread owns 2-4 points; past d = 32 x_j is
//   read where it lies, one point a thread;
// - the (k, j) float4s and the per-component aux are staged through
//   shared memory in K-chunks, so any K launches.
#include "serving.cuh"

namespace {

constexpr int kGroup = 8;      // components folded at once, d <= 8
constexpr int kGroupWide = 4;  // at the padded widths (code size)

__host__ __device__ constexpr int points_per_thread(int d) {
  return d <= 2 ? 4 : 2;
}

// sum_j h_kj log2(1 + u_kj) of one point over its component's d rows,
// x_j = x[j * xs]: the per-dim form, for components with unequal h, past
// the compiled widths, and for a point whose product 1 + U overflows.
__device__ __noinline__ float per_dim_tail(const float4* rows,
                                           const float* x, long long xs,
                                           int d) {
  float t = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float4 r = rows[j];
    const float xj = x[j * xs];
    const float u = fmaf(r.z, xj * xj, fmaf(r.y, xj, r.x));
    t = fmaf(r.w, log2_1p(fmaxf(u, 0.0f)), t);
  }
  return t;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
diag_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                    long long n, const float* __restrict__ th, int k,
                    const float* __restrict__ aux, Plan pl,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  constexpr int PTS = D > 0 ? points_per_thread(D) : 1;
  constexpr int DX = D > 0 ? D : 1;
  constexpr int G = D > 8 ? kGroupWide : kGroup;
  const int dr = D > 0 ? D : d;           // rows per component
  const Strip s[2] = {{th, 4 * dr, 1}, {aux, 2, 1}};
  const long long tile = (long long)kThreads * PTS;
  float x[PTS][DX], mx[PTS], sum[PTS];
  long long base = 0;

  // lp (log2 units) of one component whose h is shared, for each point:
  // the U fold, one log. Where 1 + U overflows lp comes out -inf (h
  // log2_1p(inf) = inf), or NaN once a later dim adds u = 0 (inf * 0: a
  // padded dim, or a clipped quad); fix_overflow then takes the per-dim
  // sum.
  auto shared_lp = [&](const float4* rows, float2 a, float (&lp)[PTS]) {
    float u1[PTS];
#pragma unroll
    for (int j = 0; j < DX; ++j) {
      const float4 r = rows[j];
#pragma unroll
      for (int i = 0; i < PTS; ++i) {
        const float xj = x[i][j];
        const float u = fmaxf(fmaf(r.z, xj * xj, fmaf(r.y, xj, r.x)), 0.0f);
        u1[i] = j == 0 ? u : fmaf(u1[i], u, u1[i] + u);
      }
    }
#pragma unroll
    for (int i = 0; i < PTS; ++i)
      lp[i] = fmaf(-a.y, log2_1p(u1[i]), a.x * kLog2e);
  };

  // a point whose 1 + U overflowed (lp -inf or NaN where the per-dim sum
  // is finite) takes the per-dim sum; rare, so one test per point and
  // group
  auto fix_overflow = [&](const float4* rows, float2 a, float& lp, int i) {
    if (!(lp > -INFINITY))
      lp = a.x * kLog2e - per_dim_tail(rows, xt + min(base + i * kThreads,
                                                      n - 1), ld, d);
  };

  // lp of any component: shared h, or the per-dim sum
  auto component = [&](const float4* rows, float2 a, float (&lp)[PTS]) {
    if constexpr (D > 0) {
      if (a.y > 0.0f) {
        shared_lp(rows, a, lp);
#pragma unroll
        for (int i = 0; i < PTS; ++i) fix_overflow(rows, a, lp[i], i);
      } else {
#pragma unroll
        for (int i = 0; i < PTS; ++i) lp[i] = a.x * kLog2e;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float4 r = rows[j];
#pragma unroll
          for (int i = 0; i < PTS; ++i) {
            const float xj = x[i][j];
            const float u = fmaf(r.z, xj * xj, fmaf(r.y, xj, r.x));
            lp[i] = fmaf(-r.w, log2_1p(fmaxf(u, 0.0f)), lp[i]);
          }
        }
      }
    } else {
      lp[0] = base < n ? a.x * kLog2e - per_dim_tail(rows, xt + base, ld, d)
                       : -INFINITY;
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
#pragma unroll
            for (int a = 0; a < D; ++a)
              x[i][a] = a < d && p < n ? xt[a * ld + p] : 0.0f;
          }
        }
      },
      [&](const View& v, int k0, int k1) {
        // D > 0: always staged (the launch checks), read with LDS
        const float4* rows0 =
            D > 0 ? staged_strip<float4>(v, 0)
                  : reinterpret_cast<const float4*>(v.p[0]);
        const float2* aux2 = D > 0 ? staged_strip<float2>(v, 1)
                                   : reinterpret_cast<const float2*>(v.p[1]);
        const int kn = k1 - k0;
        for (int c = 0; c < kn;) {
          // a group of G components that share h: G U folds, one blocked
          // fold (the branch is uniform: every thread reads the same aux)
          bool group = D > 0 && c + G <= kn;
#pragma unroll
          for (int g = 0; g < G; ++g)
            group = group && aux2[min(c + g, kn - 1)].y > 0.0f;
          if (group) {
            float lp[PTS][G], lo[PTS];   // lo: -inf or NaN if any lp is
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float l[PTS];
              shared_lp(rows0 + (long long)(c + g) * dr, aux2[c + g], l);
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                lp[i][g] = l[i];
                lo[i] = g ? lo[i] + l[i] : l[i];   // no lp is +inf
              }
            }
#pragma unroll
            for (int i = 0; i < PTS; ++i) {
              if (!(lo[i] > -INFINITY)) {
#pragma unroll
                for (int g = 0; g < G; ++g)
                  fix_overflow(rows0 + (long long)(c + g) * dr, aux2[c + g],
                               lp[i][g], i);
              }
              fold_group<G>(lp[i], mx[i], sum[i]);
            }
            c += G;
          } else {   // unequal h, the chunk's tail, runtime d: one at a time
            float l[PTS];
            component(rows0 + (long long)c * dr, aux2[c], l);
#pragma unroll
            for (int i = 0; i < PTS; ++i) {
              const float one[1] = {l[i]};
              fold_group<1>(one, mx[i], sum[i]);
            }
            ++c;
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

template <int D>
cudaError_t launch_diag_predict(const float* xt, long long ld, int d,
                                long long n, const float* th, int k,
                                const float* aux, float* out,
                                cudaStream_t st) {
  constexpr int PTS = D > 0 ? points_per_thread(D) : 1;
  const Strip s[2] = {{th, 4 * (D > 0 ? D : d), 1}, {aux, 2, 1}};
  const Plan pl = make_plan(s, 2, k);
  if (D > 0 && !pl.bufs) return cudaErrorInvalidValue;   // reads with LDS
  const size_t smem = plan_bytes(pl, 2);
  const long long tile = (long long)kThreads * PTS;
  int grid = 0;
  cudaError_t err = serving_launch_grid(diag_predict_kernel<D>, smem,
                                        (n + tile - 1) / tile, &grid);
  if (err != cudaSuccess) return err;
  diag_predict_kernel<D><<<grid, kThreads, smem, st>>>(xt, ld, d, n, th, k,
                                                       aux, pl, out);
  return cudaGetLastError();
}

}  // namespace

// xt (d, ld) f32, points 0..n-1; width: the compiled width the host laid
// th out for (d itself up to 8, 12, 16, 24 or 32 >= d, or 0: the runtime
// width, d rows); th (k D, 4) f32, D = width (d where that is 0), row (k,
// j) = [th_0, th_{1+j}, th_{1+d+j}, h] of the (k, j) quad row over [1; x;
// x^2] and its tail exponent (rows j >= d zero); aux (k, 2) f32 [aux, hs];
// out (n,) f32. Returns a cudaError_t code (cudaErrorInvalidValue for a
// width it does not compile).
extern "C" int mimo_diag_predict(const float* xt, long long ld, int d,
                                 int width, long long n, const float* th,
                                 int k, const float* aux, float* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || d < 1 || (width && width < d) || (width > 0 && width <= 8
                                                    && width != d))
    return cudaErrorInvalidValue;
  switch (width) {
    case 1: return launch_diag_predict<1>(xt, ld, d, n, th, k, aux, out, s);
    case 2: return launch_diag_predict<2>(xt, ld, d, n, th, k, aux, out, s);
    case 3: return launch_diag_predict<3>(xt, ld, d, n, th, k, aux, out, s);
    case 4: return launch_diag_predict<4>(xt, ld, d, n, th, k, aux, out, s);
    case 5: return launch_diag_predict<5>(xt, ld, d, n, th, k, aux, out, s);
    case 6: return launch_diag_predict<6>(xt, ld, d, n, th, k, aux, out, s);
    case 7: return launch_diag_predict<7>(xt, ld, d, n, th, k, aux, out, s);
    case 8: return launch_diag_predict<8>(xt, ld, d, n, th, k, aux, out, s);
    case 12: return launch_diag_predict<12>(xt, ld, d, n, th, k, aux, out, s);
    case 16: return launch_diag_predict<16>(xt, ld, d, n, th, k, aux, out, s);
    case 24: return launch_diag_predict<24>(xt, ld, d, n, th, k, aux, out, s);
    case 32: return launch_diag_predict<32>(xt, ld, d, n, th, k, aux, out, s);
    case 0: return launch_diag_predict<0>(xt, ld, d, n, th, k, aux, out, s);
    default: return cudaErrorInvalidValue;
  }
}
