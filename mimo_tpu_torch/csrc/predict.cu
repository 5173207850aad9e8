// Kernel B3: fused posterior-predictive mixture density over the
// full-covariance Gaussian or the diagonal feature map. Replaces
// mimo_tpu/ops/pallas_predict.py::_predict_kernel.
//
// Per point p < n: F = [1; x; x (x) x] (or [1; x; x^2] for the diagonal
// Gaussian predictive, dist='gaussian'), the quadratic forms
// Q_k = thq_k . F = (x - mu_k)' Lmbda_k (x - mu_k) clipped at 0, then
//   lp_k = aux_k - h_k log1p(Q_k / df_k)   (Student-t), or
//   lp_k = aux_k - Q_k / 2                 (moment-matched Gaussian),
// and out[p] = logsumexp_k lp_k. aux (K, 8) holds [aux + log w, h, 1/df].
//
// What bounds it on the H100: arithmetic (K dots of depth m8, K log1p
// and K exp per point) against 4 d bytes in and 4 bytes out per point.
//
// Design: no cross-point reduction, so each thread owns whole points in
// a grid-stride loop; thq and the three aux columns are staged in shared
// memory. The feature map is a template parameter, as in B1, so the
// Gaussian instantiation is unchanged. The TPU kernel ran this dot with
// both operands in a bf16 hi/lo split to survive the cancelling
// quadratic; here it is one f32 FMA dot.
#include "common.cuh"

namespace {

template <int kMap>
__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ xt, long long ld, int d, long long n,
               const float* __restrict__ thq, int k, int m8,
               const float* __restrict__ aux, int studentt,
               float* __restrict__ out) {
  extern __shared__ float smem[];
  float* th = smem;               // (k, m8)
  float* ax = th + k * m8;        // (k, 3): aux + log w, h, 1/df
  float* F = ax + 3 * k;          // (m8, kStride)
  float* R = F + m8 * kStride;    // (k, kStride)
  const int tid = threadIdx.x;
  for (int i = tid; i < k * m8; i += kThreads) th[i] = thq[i];
  for (int i = tid; i < k; i += kThreads) {
    ax[3 * i] = aux[8 * i];
    ax[3 * i + 1] = aux[8 * i + 1];
    ax[3 * i + 2] = aux[8 * i + 2];
  }
  __syncthreads();

  float* col = F + tid;
  float* rcol = R + tid;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + tid; p < n;
       p += step) {
    features<kMap>(xt, ld, d, p, col, m8);
    float mx = -INFINITY;
    for (int kk = 0; kk < k; ++kk) {
      const float q = fmaxf(row_dot(th + kk * m8, col, m8), 0.0f);
      const float lp = studentt
                           ? ax[3 * kk] - ax[3 * kk + 1] *
                                              log1pf(q * ax[3 * kk + 2])
                           : ax[3 * kk] - 0.5f * q;
      rcol[kk * kStride] = lp;
      mx = fmaxf(mx, lp);
    }
    float s = 0.0f;
    for (int kk = 0; kk < k; ++kk) s += expf(rcol[kk * kStride] - mx);
    out[p] = mx + logf(s);
  }
}

template <int kMap>
cudaError_t launch_predict(const float* xt, long long ld, int d, long long n,
                           const float* thq, int k, int m8, const float* aux,
                           int studentt, float* out, int grid, size_t smem,
                           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      predict_kernel<kMap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  predict_kernel<kMap><<<grid, kThreads, smem, s>>>(xt, ld, d, n, thq, k, m8,
                                                    aux, studentt, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mimo_predict_smem_bytes(int k, int m8) {
  return sizeof(float) * ((size_t)k * m8 + 3 * (size_t)k +
                          (size_t)(m8 + k) * kStride);
}

// xt (d, ld) f32, points 0..n-1; kind kKindGauss or kKindDiag; thq
// (k, m8) f32; aux (k, 8) f32; out (n,) f32. Returns a cudaError_t code.
extern "C" int mimo_predict(const float* xt, long long ld, int d, int kind,
                            long long n, const float* thq, int k, int m8,
                            const float* aux, int studentt, float* out,
                            int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((kind != kKindGauss && kind != kKindDiag) ||
      m8 < feature_width(kind, d, 0))
    return cudaErrorInvalidValue;
  const size_t smem = mimo_predict_smem_bytes(k, m8);
  return kind == kKindGauss
             ? launch_predict<kGauss>(xt, ld, d, n, thq, k, m8, aux, studentt,
                                      out, grid, smem, s)
             : launch_predict<kDiag>(xt, ld, d, n, thq, k, m8, aux, studentt,
                                     out, grid, smem, s);
}
