// Kernel B1: fused mixture E-step for the full-covariance Gaussian
// feature map. Replaces mimo_tpu/ops/pallas_estep.py::_estep_kernel2.
//
// Per point p < n: F = [1; x; x (x) x], logp_k = theta_k . F (theta's
// column 0 carries c + log pi, so counts fall out of acc[:, 0]), a
// softmax over K with the 1e-37 denominator floor of the TPU kernel,
//   acc(K, m8) += (ex / denom) F^T,   lse += max + log(denom).
//
// What bounds it on the H100: arithmetic, not memory. At d=2 a point is
// 8 bytes of input against ~3 K m8 f32 FMAs (the logp dots plus its
// share of the statistics reduction) and K exps; at N=1e7, K=50 that is
// ~1.2e10 FMAs per sweep against 80 MB read. The dot depth is m=7, far
// too shallow for tensor cores, so the dots are f32 FMAs (which also
// drops the TPU kernel's bf16 hi/lo split of theta: f32 FMA is exact to
// f32 rounding).
//
// Design: the TPU grid was sequential and carried acc across grid steps;
// CUDA blocks run concurrently. So a bounded grid (a small multiple of
// the SM count) grid-strides over tiles of kThreads points. Each thread
// assembles its point's F and responsibilities into shared-memory
// columns; the block then reduces the tile into its (K, m8) accumulator,
// one output per thread, summing the tile's columns in order. Per-block
// partials go to a scratch buffer and a second kernel sums them in block
// order: no float atomics, so a sweep is bitwise repeatable. theta
// (K x m8 f32, 1.6 KB at K=50, d=2) is staged in shared memory.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
estep_partial(const float* __restrict__ xt, long long ld, int d, long long n,
              const float* __restrict__ theta, int k, int m8,
              float* __restrict__ part) {
  extern __shared__ float smem[];
  const int km = k * m8;
  float* th = smem;              // (k, m8)
  float* acc = th + km;          // (k, m8)
  float* F = acc + km;           // (m8, kStride)
  float* R = F + m8 * kStride;   // (k, kStride)
  float* red = R + k * kStride;  // (kThreads,)
  const int tid = threadIdx.x;
  for (int i = tid; i < km; i += kThreads) {
    th[i] = theta[i];
    acc[i] = 0.0f;
  }
  float lse = 0.0f;
  __syncthreads();

  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p = tile * kThreads + tid;
    float* col = F + tid;
    float* rcol = R + tid;
    if (p < n) {
      gauss_features(xt, ld, d, p, col, m8);
      float mx = -INFINITY;
      for (int kk = 0; kk < k; ++kk) {
        const float s = row_dot(th + kk * m8, col, m8);
        rcol[kk * kStride] = s;
        mx = fmaxf(mx, s);
      }
      float den = 0.0f;
      for (int kk = 0; kk < k; ++kk) {
        const float e = expf(rcol[kk * kStride] - mx);
        rcol[kk * kStride] = e;
        den += e;
      }
      den = fmaxf(den, 1e-37f);
      lse += mx + logf(den);
      // normalize through F (m8 rows) rather than the K responsibilities
      const float inv = 1.0f / den;
      for (int j = 0; j < m8; ++j) col[j * kStride] *= inv;
    } else {  // masked tail: contributes nothing
      for (int j = 0; j < m8; ++j) col[j * kStride] = 0.0f;
      for (int kk = 0; kk < k; ++kk) rcol[kk * kStride] = 0.0f;
    }
    __syncthreads();
    for (int o = tid; o < km; o += kThreads) {
      const int kk = o / m8;
      const float* r = R + kk * kStride;
      const float* f = F + (o - kk * m8) * kStride;
      float s = 0.0f;
      for (int t = 0; t < kThreads; ++t) s = fmaf(r[t], f[t], s);
      acc[o] += s;
    }
    __syncthreads();
  }

  red[tid] = lse;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * (km + 1);
  for (int o = tid; o < km; o += kThreads) out[o] = acc[o];
  if (tid == 0) out[km] = red[0];
}

}  // namespace

extern "C" size_t mimo_estep_smem_bytes(int k, int m8) {
  return sizeof(float) *
         (2 * (size_t)k * m8 + (size_t)(m8 + k) * kStride + kThreads);
}

// xt (d, ld) f32, points 0..n-1; theta (k, m8) f32; part (grid, k*m8+1)
// scratch; out (k*m8+1) = [acc row-major, lse]. Returns cudaGetLastError().
extern "C" int mimo_estep(const float* xt, long long ld, int d, long long n,
                          const float* theta, int k, int m8, float* part,
                          float* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = mimo_estep_smem_bytes(k, m8);
  cudaError_t err = cudaFuncSetAttribute(
      estep_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  estep_partial<<<grid, kThreads, smem, s>>>(xt, ld, d, n, theta, k, m8,
                                             part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}

extern "C" const char* mimo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
