// Kernels B5 and B6: fused posterior-predictive regression of a mixture
// of linear experts (ILR) — input-conditional Student-t expert weights,
// the moment-matched mixture mean and variance (or the argmax expert's,
// prediction='mode') and, with y, the negative log predictive density,
// in one pass over the points. Replace
// mimo_tpu/ops/pallas_predict.py::_ilr_predict_kernel (B5, p = 1) and
// ::_ilr_p_predict_kernel (B6, p > 1, MNW or MNG experts).
//
// Per point, for each component k (coefficients from
// ops/cuda_ilr_predict.py, rows over the feature column F):
//   qb_k = max(th_b . F, 0)      basis Student-t quad
//   c_k  = 1 + max(th_c . F, 0)  the experts' input scale 1 + xt' K^-1 xt
//   mu_kj = th_m . F             expert means (j-major rows for B6)
//   lw_k = aux0 - aux1 log1p(qb_k aux2)   unnormalised log weights
// B5 (p = 1, F = [1; x; x (x) x]): with y, bq_k = psi_k (y - mu_k)^2
// (MNG experts: psi = 1 / (2 beta), y_h = alpha + 1/2, same formula).
// B6 (p > 1): with y, F is the joint map [1; x; x (x) x; y; x (x) y;
// y (x) y] and bq_k = max(th_q . F, 0) = (y - mu_k)' psi_k (y - mu_k).
// lp_y_k = y_aux - p/2 log c_k - y_h log1p(bq_k / c_k), or, for MNG
// experts (`diag`, a product of per-output t's sharing c_k),
// lp_y_k = y_aux - p/2 log c_k - sum_j h_kj log1p(v_kj / c_k) with
// v_kj = max(th_v . F, 0) = (y_j - mu_kj)^2 / (2 beta_kj), and
//   mean_j = sum_k w_k mu_kj,  var_j = max(sum_k w_k (c_k vc_kj + mu_kj^2)
//                                          - mean_j^2, 0),
//   nlpd = -(logsumexp_k (lp_y_k + lw_k) - logsumexp_k lw_k),
// with w the softmax of lw ('average') or the one-hot of its
// first-occurrence argmax ('mode'; the NLPD keeps the soft weights).
// out (2p + 2, n) rows = [mean (p), var (p), nlpd, lse_w]; nlpd = 0
// without y.
//
// What bounds them on the H100: arithmetic. A point is 4 (d + p) bytes
// in and 4 (2p + 2) out, against (3 + p) K dots of depth m8 and ~5 K
// transcendentals.
//
// Design: each point is independent, so one thread owns whole points in
// a grid-stride loop; the coefficient rows, aux and vc are staged in
// shared memory and read as warp-wide broadcasts. K is streamed once
// with an online softmax: a running max with rescaled sums of w, w mu_j,
// w (c vc_j + mu_j^2) and the NLPD's exp-sum, so the TPU kernel's (K, B)
// arrays never exist. The TPU kernel ran its dot with both operands in a
// bf16 hi/lo split; here every dot is one f32 FMA chain.
#include "common.cuh"

namespace {

// [1; x; x (x) x; y; x (x) y; y (x) y; 0...] for point p of the stacked
// rows xt = [x (d rows); y (np rows)]. Mirrors
// mimo_tpu/ops/pallas_predict.py::_ilr_joint_features_t.
__device__ __forceinline__ void joint_features(const float* __restrict__ xt,
                                               long long ld, int d, int np,
                                               long long p, float* col,
                                               int m8) {
  gauss_features(xt, ld, d, p, col, 1 + d + d * d);
  int off = 1 + d + d * d;
  for (int j = 0; j < np; ++j)
    col[(off + j) * kStride] = xt[(d + j) * ld + p];
  off += np;
  for (int i = 0; i < d; ++i) {
    const float xi = col[(1 + i) * kStride];
    for (int j = 0; j < np; ++j)
      col[(off + i * np + j) * kStride] =
          xi * col[(1 + d + d * d + j) * kStride];
  }
  off += d * np;
  for (int i = 0; i < np; ++i) {
    const float yi = col[(1 + d + d * d + i) * kStride];
    for (int j = 0; j < np; ++j)
      col[(off + i * np + j) * kStride] =
          yi * col[(1 + d + d * d + j) * kStride];
  }
  for (int j = off + np * np; j < m8; ++j) col[j * kStride] = 0.0f;
}

// B5: th (3k, m8) rows [basis quad; c quad; expert mean]; aux (k, 8)
// cols [log w + basis aux, basis h, basis 1/df, var coef, psi, y_aux,
// y_h, 0]; xt (d + has_y, ld); out (4, n).
__global__ void __launch_bounds__(kThreads)
ilr_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                   int has_y, long long n, const float* __restrict__ thg,
                   int k, int m8, const float* __restrict__ aux, int hard,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* th = smem;               // (3k, m8)
  float* ax = th + 3 * k * m8;    // (k, 7)
  float* F = ax + 7 * k;          // (m8, kStride)
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * k * m8; i += kThreads) th[i] = thg[i];
  for (int i = tid; i < 7 * k; i += kThreads)
    ax[i] = aux[8 * (i / 7) + i % 7];
  __syncthreads();

  float* col = F + tid;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + tid; p < n;
       p += step) {
    gauss_features(xt, ld, d, p, col, m8);
    const float y = has_y ? xt[d * ld + p] : 0.0f;
    float mw = -INFINITY, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;  // soft weights
    float ms = -INFINITY, ss = 0.0f;                         // NLPD sum
    float bestv = -INFINITY, best_mu = 0.0f, best_second = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      const float* a = ax + 7 * kk;
      const float qb = fmaxf(row_dot(th + kk * m8, col, m8), 0.0f);
      const float c = 1.0f + fmaxf(row_dot(th + (k + kk) * m8, col, m8),
                                   0.0f);
      const float mu = row_dot(th + (2 * k + kk) * m8, col, m8);
      const float lw = a[0] - a[1] * log1pf(qb * a[2]);
      const float second = c * a[3] + mu * mu;
      float scale;
      const float e = online_add(lw, mw, s0, scale);
      s1 = s1 * scale + e * mu;
      s2 = s2 * scale + e * second;
      if (hard && lw > bestv) {  // strict: the first occurrence wins ties
        bestv = lw;
        best_mu = mu;
        best_second = second;
      }
      if (has_y) {
        const float yc = y - mu;
        const float lp_y = a[5] - 0.5f * logf(c) -
                           a[6] * log1pf(a[4] * yc * yc * (1.0f / c));
        online_add(lp_y + lw, ms, ss, scale);
      }
    }
    const float lse_w = mw + logf(s0);
    const float mean = hard ? best_mu : s1 / s0;
    const float second = hard ? best_second : s2 / s0;
    out[p] = mean;
    out[n + p] = fmaxf(second - mean * mean, 0.0f);
    out[2 * n + p] = has_y ? -((ms + logf(ss)) - lse_w) : 0.0f;
    out[3 * n + p] = lse_w;
  }
}

// Rows of B6's coefficient matrix: basis quad, c quad and np mean rows
// per component, then with y the MVT quad (MNW) or np scaled per-output
// quads (MNG, `diag`).
__host__ __device__ inline int p_predict_rows(int k, int np, int has_y,
                                              int diag) {
  return (2 + np + (has_y ? (diag ? np : 1) : 0)) * k;
}

// B6: th (p_predict_rows, m8) rows [basis quad (k); c quad (k); expert
// means (np k, row j k + kk); with y the MVT quad (k), or for `diag` the
// scaled quads (np k, row (2 + np + j) k + kk)] over the joint map with
// y, [1; x; x (x) x] without; aux (k, 8) cols [log w + basis aux,
// basis h, basis 1/df, y_aux, y_h, 0, 0, 0]; vc (k, np) variance
// coefficients, or (k, 2 np) [vcoef | h] for `diag`; xt (d + has_y np,
// ld); out (2 np + 2, n).
__global__ void __launch_bounds__(kThreads)
ilr_p_predict_kernel(const float* __restrict__ xt, long long ld, int d,
                     int np, int has_y, int diag, long long n,
                     const float* __restrict__ thg, int k, int m8,
                     const float* __restrict__ aux,
                     const float* __restrict__ vcg, int hard,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const int rows = p_predict_rows(k, np, has_y, diag);
  const int vs = diag ? 2 * np : np;   // vc row stride
  float* th = smem;               // (rows, m8)
  float* ax = th + rows * m8;     // (k, 5)
  float* vc = ax + 5 * k;         // (k, vs)
  float* F = vc + k * vs;         // (m8, kStride)
  float* S = F + m8 * kStride;    // (2 np, kStride): sums of w mu, w second
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * m8; i += kThreads) th[i] = thg[i];
  for (int i = tid; i < 5 * k; i += kThreads)
    ax[i] = aux[8 * (i / 5) + i % 5];
  for (int i = tid; i < k * vs; i += kThreads) vc[i] = vcg[i];
  __syncthreads();

  float* col = F + tid;
  float* acc = S + tid;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + tid; p < n;
       p += step) {
    if (has_y)
      joint_features(xt, ld, d, np, p, col, m8);
    else
      gauss_features(xt, ld, d, p, col, m8);
    for (int j = 0; j < 2 * np; ++j) acc[j * kStride] = 0.0f;
    float mw = -INFINITY, s0 = 0.0f, ms = -INFINITY, ss = 0.0f;
    float bestv = -INFINITY, best_c = 1.0f;
    int best = 0;
    for (int kk = 0; kk < k; ++kk) {
      const float* a = ax + 5 * kk;
      const float qb = fmaxf(row_dot(th + kk * m8, col, m8), 0.0f);
      const float c = 1.0f + fmaxf(row_dot(th + (k + kk) * m8, col, m8),
                                   0.0f);
      const float lw = a[0] - a[1] * log1pf(qb * a[2]);
      float scale;
      const float e = online_add(lw, mw, s0, scale);
      if (hard) {
        if (lw > bestv) {  // strict: the first occurrence wins ties
          bestv = lw;
          best = kk;
          best_c = c;
        }
      } else {
        for (int j = 0; j < np; ++j) {
          const float mu = row_dot(th + ((2 + j) * k + kk) * m8, col, m8);
          float* sm = acc + j * kStride;
          float* sv = acc + (np + j) * kStride;
          *sm = *sm * scale + e * mu;
          *sv = *sv * scale + e * (c * vc[kk * vs + j] + mu * mu);
        }
      }
      if (has_y) {
        const float inv_c = 1.0f / c;
        float tail;
        if (diag) {  // product of per-output t tails sharing c
          tail = 0.0f;
          for (int j = 0; j < np; ++j) {
            const float v = fmaxf(
                row_dot(th + ((2 + np + j) * k + kk) * m8, col, m8), 0.0f);
            tail += vc[kk * vs + np + j] * log1pf(v * inv_c);
          }
        } else {
          const float bq =
              fmaxf(row_dot(th + ((2 + np) * k + kk) * m8, col, m8), 0.0f);
          tail = a[4] * log1pf(bq * inv_c);
        }
        const float lp_y = a[3] - 0.5f * np * logf(c) - tail;
        online_add(lp_y + lw, ms, ss, scale);
      }
    }
    const float lse_w = mw + logf(s0);
    for (int j = 0; j < np; ++j) {
      float mean, second;
      if (hard) {
        mean = row_dot(th + ((2 + j) * k + best) * m8, col, m8);
        second = best_c * vc[best * vs + j] + mean * mean;
      } else {
        mean = acc[j * kStride] / s0;
        second = acc[(np + j) * kStride] / s0;
      }
      out[j * n + p] = mean;
      out[(np + j) * n + p] = fmaxf(second - mean * mean, 0.0f);
    }
    out[2 * np * n + p] = has_y ? -((ms + logf(ss)) - lse_w) : 0.0f;
    out[(2 * np + 1) * n + p] = lse_w;
  }
}

}  // namespace

extern "C" size_t mimo_ilr_predict_smem_bytes(int k, int m8) {
  return sizeof(float) * (3 * (size_t)k * m8 + 7 * (size_t)k +
                          (size_t)m8 * kStride);
}

extern "C" size_t mimo_ilr_p_predict_smem_bytes(int k, int m8, int p,
                                                int has_y, int diag) {
  return sizeof(float) *
         ((size_t)p_predict_rows(k, p, has_y, diag) * m8 + 5 * (size_t)k +
          (size_t)k * p * (diag ? 2 : 1) + (size_t)(m8 + 2 * p) * kStride);
}

// xt (d + has_y, ld) f32, points 0..n-1; th (3k, m8) f32; aux (k, 8)
// f32; out (4, n) f32. Returns a cudaError_t code.
extern "C" int mimo_ilr_predict(const float* xt, long long ld, int d,
                                int has_y, long long n, const float* th,
                                int k, int m8, const float* aux, int hard,
                                float* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < 1 + d + d * d) return cudaErrorInvalidValue;
  const size_t smem = mimo_ilr_predict_smem_bytes(k, m8);
  cudaError_t err = cudaFuncSetAttribute(
      ilr_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ilr_predict_kernel<<<grid, kThreads, smem, s>>>(xt, ld, d, has_y, n, th, k,
                                                  m8, aux, hard, out);
  return cudaGetLastError();
}

// xt (d + has_y p, ld) f32, points 0..n-1; th (p_predict_rows, m8)
// f32; aux (k, 8) f32; vc (k, p) f32, or (k, 2p) for `diag`; out
// (2p + 2, n) f32. Returns a cudaError_t code.
extern "C" int mimo_ilr_p_predict(const float* xt, long long ld, int d,
                                  int p, int has_y, int diag, long long n,
                                  const float* th, int k, int m8,
                                  const float* aux, const float* vc,
                                  int hard, float* out, int grid,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = 1 + d + d * d + (has_y ? p + d * p + p * p : 0);
  if (m8 < width) return cudaErrorInvalidValue;
  const size_t smem = mimo_ilr_p_predict_smem_bytes(k, m8, p, has_y, diag);
  cudaError_t err = cudaFuncSetAttribute(
      ilr_p_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ilr_p_predict_kernel<<<grid, kThreads, smem, s>>>(
      xt, ld, d, p, has_y, diag, n, th, k, m8, aux, vc, hard, out);
  return cudaGetLastError();
}
