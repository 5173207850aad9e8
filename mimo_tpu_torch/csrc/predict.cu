// Kernel B3: fused posterior-predictive mixture density over the
// full-covariance Gaussian or the diagonal feature map. Replaces
// mimo_tpu/ops/pallas_predict.py::_predict_kernel.
//
// Per point p < n: the quadratic forms Q_k = thq_k . F over F = [1; x;
// x (x) x] (or [1; x; x^2] for the diagonal Gaussian predictive,
// dist='gaussian'), Q_k = (x - mu_k)' Lmbda_k (x - mu_k) clipped at 0, then
//   lp_k = aux_k - h_k log1p(Q_k / df_k)   (Student-t), or
//   lp_k = aux_k - Q_k / 2                 (moment-matched Gaussian),
// and out[p] = logsumexp_k lp_k. aux (K, 8) holds [aux + log w, h, 1/df].
//
// What bounds it on the H100: arithmetic (K quads of 1 + d + d^2 FMAs, K
// log1p and K exp per point) against 4 d bytes in and 4 bytes out per
// point.
//
// Design (serving.cuh): thq and aux are staged through shared memory in
// K-chunks, so any K launches; K is folded once per point with the online
// logsumexp (one exp per component), so no (K, B) array exists. At d <= 8
// each point's map lives in registers (PointMap: the Gauss map's distinct
// entries, 45 at d = 8) and a thread owns 2-4 points (one float4 broadcast
// of the row feeds each point's FMA chain); wider d forms F's entries
// term by term from x where it lies, so no F column limits d. The TPU kernel ran this dot with both operands in
// a bf16 hi/lo split to survive the cancelling quadratic; here it is one
// f32 FMA chain in F's column order, as in the plain version
// (chip_smoke.py's float64 precision line holds it, off the origin too).
#include "serving.cuh"

namespace {

constexpr int kMaxFastD = 8;   // compile-time d up to this

__host__ __device__ constexpr int points_per_thread(int m) {
  return m <= 8 ? 4 : 2;
}

// B3 at compile-time d (D > 0; PTS points a thread) or runtime d (D = 0,
// one point a thread).
template <int kMap, int D>
__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ xt, long long ld, int d, long long n,
               const float* __restrict__ thq, int k, int m8,
               const float* __restrict__ aux, int studentt, Plan pl,
               float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  using Map = PointMap<kMap, (D > 0 ? D : 1)>;
  constexpr int PTS = D > 0 ? points_per_thread(Map::M) : 1;
  const Strip s[2] = {{thq, m8, 1}, {aux, 8, 1}};
  const long long tile = (long long)kThreads * PTS;
  float f[PTS][Map::S], mx[PTS], sum[PTS];
  long long base = 0;
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
        for (int kk = k0; kk < k1; ++kk) {
          const float* row = v.p[0] + (long long)(kk - k0) * m8;
          const float4 a = *reinterpret_cast<const float4*>(
              v.p[1] + (long long)(kk - k0) * 8);
          float scale;
          if constexpr (D > 0) {
            float q[PTS];
            map_dots<Map>(row, f, q);
#pragma unroll
            for (int i = 0; i < PTS; ++i) {
              const float qi = fmaxf(q[i], 0.0f);
              const float lp = studentt ? a.x - a.y * log1pf(qi * a.z)
                                        : a.x - 0.5f * qi;
              online_add(lp, mx[i], sum[i], scale);
            }
          } else {
            if (base < n) {
              const float* xp = xt + base;
              const float q = fmaxf(kMap == kGauss
                                        ? gauss_dot_rt(row, xp, ld, d)
                                        : diag_dot_rt(row, xp, ld, d),
                                    0.0f);
              const float lp = studentt ? a.x - a.y * log1pf(q * a.z)
                                        : a.x - 0.5f * q;
              online_add(lp, mx[0], sum[0], scale);
            }
          }
        }
      },
      [&]() {
#pragma unroll
        for (int i = 0; i < PTS; ++i) {
          const long long p = base + i * kThreads;
          if (p < n) out[p] = mx[i] + logf(sum[i]);
        }
      });
}

template <int kMap, int D>
cudaError_t launch_predict(const float* xt, long long ld, int d, long long n,
                           const float* thq, int k, int m8, const float* aux,
                           int studentt, float* out, cudaStream_t st) {
  constexpr int PTS =
      D > 0 ? points_per_thread(PointMap<kMap, (D > 0 ? D : 1)>::M) : 1;
  const Strip s[2] = {{thq, m8, 1}, {aux, 8, 1}};
  const Plan pl = make_plan(s, 2, k);
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

template <int kMap>
cudaError_t dispatch_predict(const float* xt, long long ld, int d,
                             long long n, const float* thq, int k, int m8,
                             const float* aux, int studentt, float* out,
                             cudaStream_t st) {
  switch (d) {
    case 1: return launch_predict<kMap, 1>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 2: return launch_predict<kMap, 2>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 3: return launch_predict<kMap, 3>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 4: return launch_predict<kMap, 4>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 5: return launch_predict<kMap, 5>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 6: return launch_predict<kMap, 6>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 7: return launch_predict<kMap, 7>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 8: return launch_predict<kMap, 8>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    default: return launch_predict<kMap, 0>(xt, ld, d, n, thq, k, m8, aux,
                                            studentt, out, st);
  }
}

static_assert(kMaxFastD == 8, "dispatch_predict compiles d = 1..8");

}  // namespace

// xt (d, ld) f32, points 0..n-1; kind kKindGauss or kKindDiag; thq
// (k, m8) f32; aux (k, 8) f32; out (n,) f32. Returns a cudaError_t code.
extern "C" int mimo_predict(const float* xt, long long ld, int d, int kind,
                            long long n, const float* thq, int k, int m8,
                            const float* aux, int studentt, float* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((kind != kKindGauss && kind != kKindDiag) || k < 1 || m8 % 8 != 0 ||
      m8 < feature_width(kind, d, 0))
    return cudaErrorInvalidValue;
  return kind == kKindGauss
             ? dispatch_predict<kGauss>(xt, ld, d, n, thq, k, m8, aux,
                                        studentt, out, s)
             : dispatch_predict<kDiag>(xt, ld, d, n, thq, k, m8, aux,
                                       studentt, out, s);
}
