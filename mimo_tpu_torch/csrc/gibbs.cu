// Kernel B2: fused blocked-Gibbs label sweep over the full-covariance
// Gaussian, the diagonal Gaussian or the ILR product feature map. Replaces
// mimo_tpu/ops/pallas_gibbs.py::_gibbs_kernel.
//
// Per point p < n: F = features(p) (common.cuh), plug-in logp_k =
// theta_k . F (log pi folded into theta's column 0), Gumbel noise
// g = -log(-log(u + 1e-20) + 1e-20) from 23-bit uniforms
// u = (bits >> 9) 2^-23, label = the first-occurrence argmax over K of
// logp + g, and acc(K, m8) += one_hot(label) F^T.
//
// What bounds it on the H100: arithmetic, as in B1 (K dots of depth m8
// per point), plus one Philox4x32-10 call per 4 components.
//
// Design: the TPU kernel seeded its on-core PRNG by (seed, block), so its
// labels depended on the block size. Here Philox is keyed by the sweep
// seed (64 bits from the engine's generator, read from device memory so
// the sweep loop never syncs the host) and countered by the global point
// index and the component group, so labels are independent of the grid
// and match the plain PyTorch Philox draw for draw (up to near-ties of
// the f32 summation order). The statistics use B1's bounded grid and
// per-block partials with a fixed-order second pass (no float atomics);
// a tile's labels are staged in shared memory and each (k, j) output
// sums the F rows of the points labelled k, in point order. The feature
// map is a template parameter, as in B1.
#include "common.cuh"

namespace {

template <int kMap>
__global__ void __launch_bounds__(kThreads)
gibbs_partial(const float* __restrict__ xt, long long ld, int d, int np,
              bool affine, long long n, const float* __restrict__ theta,
              int k, int m8, const long long* __restrict__ seed,
              int* __restrict__ labels, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int km = k * m8;
  float* th = smem;                                 // (k, m8)
  float* acc = th + km;                             // (k, m8)
  float* F = acc + km;                              // (m8, kStride)
  int* L = reinterpret_cast<int*>(F + m8 * kStride);  // (kThreads,)
  const int tid = threadIdx.x;
  for (int i = tid; i < km; i += kThreads) {
    th[i] = theta[i];
    acc[i] = 0.0f;
  }
  const unsigned long long s64 = static_cast<unsigned long long>(*seed);
  const uint2 key = make_uint2(static_cast<unsigned>(s64),
                               static_cast<unsigned>(s64 >> 32));
  __syncthreads();

  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p = tile * kThreads + tid;
    float* col = F + tid;
    int best = -1;
    if (p < n) {
      features<kMap>(xt, ld, d, np, affine, p, col, m8);
      const unsigned long long up = static_cast<unsigned long long>(p);
      float bestv = -INFINITY;
      best = 0;
      for (int g = 0; 4 * g < k; ++g) {
        const uint4 r = philox4x32_10(
            make_uint4(static_cast<unsigned>(up),
                       static_cast<unsigned>(up >> 32),
                       static_cast<unsigned>(g), 0u),
            key);
        const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = 4 * g + c;
          if (kk < k) {
            const float u = (float)(bits[c] >> 9) * 1.1920928955078125e-07f;
            const float gmb = -logf(-logf(u + 1e-20f) + 1e-20f);
            const float v = row_dot(th + kk * m8, col, m8) + gmb;
            if (v > bestv) {  // strict: the first occurrence wins ties
              bestv = v;
              best = kk;
            }
          }
        }
      }
      labels[p] = best;
    }
    L[tid] = best;
    __syncthreads();
    for (int o = tid; o < km; o += kThreads) {
      const int kk = o / m8;
      const float* f = F + (o - kk * m8) * kStride;
      float s = 0.0f;
      for (int t = 0; t < kThreads; ++t)
        if (L[t] == kk) s += f[t];
      acc[o] += s;
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.x * km;
  for (int o = tid; o < km; o += kThreads) out[o] = acc[o];
}

template <int kMap>
cudaError_t launch_gibbs(const float* xt, long long ld, int d, int np,
                         bool affine, long long n, const float* theta, int k,
                         int m8, const long long* seed, int* labels,
                         float* part, int grid, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_partial<kMap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gibbs_partial<kMap><<<grid, kThreads, smem, s>>>(
      xt, ld, d, np, affine, n, theta, k, m8, seed, labels, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mimo_gibbs_smem_bytes(int k, int m8) {
  return sizeof(float) * (2 * (size_t)k * m8 + (size_t)m8 * kStride) +
         sizeof(int) * kThreads;
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag),
// points 0..n-1; theta (k, m8) f32; seed: one int64 on the device;
// labels (n,) int32; part (grid, k*m8) scratch; out (k*m8) acc
// row-major. Returns a cudaError_t code.
extern "C" int mimo_gibbs(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, const long long* seed, int* labels,
                          float* part, float* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindDiag ||
      m8 < feature_width(kind, d, p))
    return cudaErrorInvalidValue;
  const size_t smem = mimo_gibbs_smem_bytes(k, m8);
  cudaError_t err;
  if (kind == kKindGauss)
    err = launch_gibbs<kGauss>(xt, ld, d, 0, false, n, theta, k, m8, seed,
                               labels, part, grid, smem, s);
  else if (kind == kKindDiag)
    err = launch_gibbs<kDiag>(xt, ld, d, 0, false, n, theta, k, m8, seed,
                              labels, part, grid, smem, s);
  else
    err = launch_gibbs<kIlr>(xt, ld, d, p, kind == kKindIlrAffine, n, theta,
                             k, m8, seed, labels, part, grid, smem, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8, out, s);
}
