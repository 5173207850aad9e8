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
// 0.5 (df_kj + 1) (ops/cuda_diag_predict.py builds them; its plain version
// reads the same rows).
//
// Quadratic form: the expanded form, as on the TPU, summed in column order
// th_0 + th_{1+j} x_j + th_{1+d+j} x_j^2 (the TPU's full dot adds exact
// zeros besides). Its cancellation (r mu^2 - 2 r mu x + r x^2) costs
// ~eps r x^2 absolutely; chip_smoke.py's float64 precision line holds the
// kernel to the f32 plain version's error, 10 sigma off the origin too.
//
// What bounds it on the H100: the SFU, not memory. A point is 4 d bytes in
// and 4 bytes out against K d log1p and K exp.
//
// Design (serving.cuh): the (k, j) float4s and aux are staged through
// shared memory in K-chunks, so any K launches; K is folded once per point
// with the online logsumexp. At d <= 8 x lives in registers and a thread
// owns 2-4 points; wider d reads x_j where it lies.
#include "serving.cuh"

namespace {

__host__ __device__ constexpr int points_per_thread(int d) {
  return d <= 2 ? 4 : 2;
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
  const Strip s[2] = {{th, 4 * d, 1}, {aux, 1, 1}};
  const long long tile = (long long)kThreads * PTS;
  float x[PTS][DX], mx[PTS], sum[PTS];
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
#pragma unroll
            for (int a = 0; a < D; ++a) x[i][a] = p < n ? xt[a * ld + p] : 0.0f;
          }
        }
      },
      [&](const View& v, int k0, int k1) {
        for (int kk = k0; kk < k1; ++kk) {
          const int c = kk - k0;
          const float4* rows =
              reinterpret_cast<const float4*>(v.p[0]) + (long long)c * d;
          float scale;
          if constexpr (D > 0) {
            float lp[PTS];
#pragma unroll
            for (int i = 0; i < PTS; ++i) lp[i] = v.p[1][c];
#pragma unroll
            for (int j = 0; j < D; ++j) {
              const float4 r = rows[j];   // [th_0, th_{1+j}, th_{1+d+j}, h]
#pragma unroll
              for (int i = 0; i < PTS; ++i) {
                const float xj = x[i][j];
                const float u = fmaf(r.z, xj * xj, fmaf(r.y, xj, r.x));
                lp[i] -= r.w * log1pf(fmaxf(u, 0.0f));
              }
            }
#pragma unroll
            for (int i = 0; i < PTS; ++i)
              online_add(lp[i], mx[i], sum[i], scale);
          } else if (base < n) {
            float lp = v.p[1][c];
            for (int j = 0; j < d; ++j) {
              const float4 r = rows[j];
              const float xj = xt[j * ld + base];
              const float u = fmaf(r.z, xj * xj, fmaf(r.y, xj, r.x));
              lp -= r.w * log1pf(fmaxf(u, 0.0f));
            }
            online_add(lp, mx[0], sum[0], scale);
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

template <int D>
cudaError_t launch_diag_predict(const float* xt, long long ld, int d,
                                long long n, const float* th, int k,
                                const float* aux, float* out,
                                cudaStream_t st) {
  constexpr int PTS = D > 0 ? points_per_thread(D) : 1;
  const Strip s[2] = {{th, 4 * d, 1}, {aux, 1, 1}};
  const Plan pl = make_plan(s, 2, k);
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

// xt (d, ld) f32, points 0..n-1; th (k d, 4) f32, row (k, j) = [th_0,
// th_{1+j}, th_{1+d+j}, h] of the (k, j) quad row over [1; x; x^2] and its
// tail exponent; aux (k) f32; out (n,) f32. Returns a cudaError_t code.
extern "C" int mimo_diag_predict(const float* xt, long long ld, int d,
                                 long long n, const float* th, int k,
                                 const float* aux, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || d < 1) return cudaErrorInvalidValue;
  switch (d) {
    case 1: return launch_diag_predict<1>(xt, ld, d, n, th, k, aux, out, s);
    case 2: return launch_diag_predict<2>(xt, ld, d, n, th, k, aux, out, s);
    case 3: return launch_diag_predict<3>(xt, ld, d, n, th, k, aux, out, s);
    case 4: return launch_diag_predict<4>(xt, ld, d, n, th, k, aux, out, s);
    case 5: return launch_diag_predict<5>(xt, ld, d, n, th, k, aux, out, s);
    case 6: return launch_diag_predict<6>(xt, ld, d, n, th, k, aux, out, s);
    case 7: return launch_diag_predict<7>(xt, ld, d, n, th, k, aux, out, s);
    case 8: return launch_diag_predict<8>(xt, ld, d, n, th, k, aux, out, s);
    default: return launch_diag_predict<0>(xt, ld, d, n, th, k, aux, out, s);
  }
}
