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
// thu (K d, m8) rows are (k, j) row-major; h (K d) holds 0.5 (df_kj + 1).
//
// Quadratic form: the expanded dot over F, as on the TPU, so B4 takes
// the same coefficient rows and the plain version mirrors the TPU
// kernel's formulas. Its cancellation (r mu^2 - 2 r mu x + r x^2) costs
// ~eps r x^2 absolutely; at a fit's scales (r ~ 1/(var N_k)) that is
// ~1e-5 nats after the factor h ~ N_k / 2, inside the serving tolerance,
// and each term is one f32 FMA instead of the TPU's bf16 hi/lo passes.
//
// What bounds it on the H100: the SFU and FMA pipes, not memory. A point
// is 4 d bytes in and 4 bytes out against K d dots of depth m8, K d
// log1p and ~K exp.
//
// Design: each point is independent, so one thread owns whole points in
// a grid-stride loop (the tail is masked by n); thu, h and aux are
// staged in shared memory and read as warp-wide broadcasts; F is one
// shared-memory column per thread; K is streamed once with a running
// max and rescaled sum (online logsumexp), so no (K, B) array exists.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
diag_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                    long long n, const float* __restrict__ thu, int k,
                    int m8, const float* __restrict__ h,
                    const float* __restrict__ aux, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int kd = k * d;
  float* th = smem;               // (k d, m8)
  float* hh = th + kd * m8;       // (k d)
  float* ax = hh + kd;            // (k)
  float* F = ax + k;              // (m8, kStride)
  const int tid = threadIdx.x;
  for (int i = tid; i < kd * m8; i += kThreads) th[i] = thu[i];
  for (int i = tid; i < kd; i += kThreads) hh[i] = h[i];
  for (int i = tid; i < k; i += kThreads) ax[i] = aux[i];
  __syncthreads();

  float* col = F + tid;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + tid; p < n;
       p += step) {
    diag_features(xt, ld, d, p, col, m8);
    float mx = -INFINITY, s = 0.0f, scale;
    for (int kk = 0; kk < k; ++kk) {
      float lp = ax[kk];
      for (int j = 0; j < d; ++j) {
        const int r = kk * d + j;
        const float u = fmaxf(row_dot(th + r * m8, col, m8), 0.0f);
        lp -= hh[r] * log1pf(u);
      }
      online_add(lp, mx, s, scale);
    }
    out[p] = mx + logf(s);
  }
}

}  // namespace

extern "C" size_t mimo_diag_predict_smem_bytes(int k, int d, int m8) {
  return sizeof(float) * ((size_t)k * d * (m8 + 1) + (size_t)k +
                          (size_t)m8 * kStride);
}

// xt (d, ld) f32, points 0..n-1; thu (k d, m8) f32; h (k d) f32; aux (k)
// f32; out (n,) f32. Returns a cudaError_t code.
extern "C" int mimo_diag_predict(const float* xt, long long ld, int d,
                                 long long n, const float* thu, int k, int m8,
                                 const float* h, const float* aux, float* out,
                                 int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindDiag, d, 0)) return cudaErrorInvalidValue;
  const size_t smem = mimo_diag_predict_smem_bytes(k, d, m8);
  cudaError_t err = cudaFuncSetAttribute(
      diag_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  diag_predict_kernel<<<grid, kThreads, smem, s>>>(xt, ld, d, n, thu, k, m8,
                                                   h, aux, out);
  return cudaGetLastError();
}
