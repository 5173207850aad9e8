// Kernel B1: fused mixture E-step over the full-covariance Gaussian, the
// diagonal Gaussian or the ILR product feature map. Replaces
// mimo_tpu/ops/pallas_estep.py::_estep_kernel2.
//
// Per point p < n: F = features(p) (common.cuh; [1; x; x (x) x] for a
// Gaussian, [1; x; x^2] for a diagonal Gaussian, [1; x; x (x) x;
// y (x) xa; xa (x) xa; y (x) y] for ILR with MNW or MNG experts),
// logp_k = theta_k . F (theta's column 0 carries c + log pi, so counts
// fall out of acc[:, 0]), a softmax over K with the 1e-37 denominator
// floor of the TPU kernel,
//   acc(K, m8) += (ex / denom) F^T,   lse += max + log(denom).
//
// What bounds it on the H100: arithmetic and shared-memory issue, not
// memory. A point is 4 (d + p) bytes of input against ~2 K m8 f32 FMAs
// (the logp dots plus its share of the statistics reduction), each with
// two shared-memory operands, and K exps. At d=2 (m8=8) the dots are far
// too shallow for tensor cores; at the ILR q8 shape (m8=168) they are
// deeper but still K=50 wide, and f32 FMA also drops the TPU kernel's
// bf16 hi/lo splits of theta and F (f32 FMA is exact to f32 rounding,
// which the linear experts' cancelling M-step needs).
//
// Design: the TPU grid was sequential and carried acc across grid steps;
// CUDA blocks run concurrently. So a bounded grid (a small multiple of
// the SM count) grid-strides over tiles of kThreads points. Each thread
// assembles its point's F and responsibilities into shared-memory
// columns; the block then reduces the tile into its (K, m8) accumulator,
// one output per thread, summing the tile's columns in order. Per-block
// partials go to a scratch buffer and a second kernel sums them in block
// order: no float atomics, so a sweep is bitwise repeatable. theta is
// staged in shared memory. The feature map is a template parameter, so
// the Gaussian instantiation is the same code as before the ILR and
// diagonal maps existed. At m8=168, K=50 a block stages ~180 KB, so one
// 128-thread block fits per SM: low occupancy, accepted for now (ROADMAP
// A10b).
//
// Two probes of B1's cost, the ports of the TPU bisection kernels, are
// template parameters of the same kernel over the Gauss map; no model
// launches them:
//   S1 (scripts/bisect_pallas.py::_regf_kernel): kDivide = false skips
//      the per-point normalisation, so acc accumulates sum ex F^T with ex
//      = exp(logp - max) (lse is unchanged). It isolates what the divide
//      costs.
//   S2 (scripts/bisect_smem.py::kern_*): where the valid count lives. The
//      TPU probe read a scalar from SMEM; here kCount selects the count
//      as a kernel argument (B1 itself), none at all (N a multiple of the
//      tile: no per-point test), an int32 in device memory passed and not
//      read, or one read once per block and used to mask the points at or
//      past it, which then contribute nothing (as B1's tail; the TPU
//      probe's masked columns divide by a zero denominator).
#include "common.cuh"

namespace {

enum CountMode { kCountArg = 0, kCountNone = 1, kCountMemUnused = 2,
                 kCountMemUsed = 3 };

template <int kMap, bool kDivide = true, int kCount = kCountArg>
__global__ void __launch_bounds__(kThreads)
estep_partial(const float* __restrict__ xt, long long ld, int d, int np,
              bool affine, long long n, const int* __restrict__ nv,
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
  long long valid = n;
  if constexpr (kCount == kCountMemUsed) valid = min(n, (long long)*nv);
  __syncthreads();

  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p = tile * kThreads + tid;
    float* col = F + tid;
    float* rcol = R + tid;
    constexpr bool kAllValid = kCount == kCountNone ||
                               kCount == kCountMemUnused;
    if (kAllValid || p < valid) {
      features<kMap>(xt, ld, d, np, affine, p, col, m8);
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
      if constexpr (kDivide) {
        // normalize through F (m8 rows) rather than the K responsibilities
        const float inv = 1.0f / den;
        for (int j = 0; j < m8; ++j) col[j * kStride] *= inv;
      }
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

template <int kMap, bool kDivide = true, int kCount = kCountArg>
cudaError_t launch_estep(const float* xt, long long ld, int d, int np,
                         bool affine, long long n, const int* nv,
                         const float* theta, int k, int m8, float* part,
                         int grid, size_t smem, cudaStream_t s) {
  auto kernel = estep_partial<kMap, kDivide, kCount>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(xt, ld, d, np, affine, n, nv, theta, k,
                                      m8, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mimo_estep_smem_bytes(int k, int m8) {
  return sizeof(float) *
         (2 * (size_t)k * m8 + (size_t)(m8 + k) * kStride + kThreads);
}

// xt (d + p, ld) f32: x rows then y rows (p = 0 for kKindGauss and
// kKindDiag),
// points 0..n-1; theta (k, m8) f32; part (grid, k*m8+1) scratch;
// out (k*m8+1) = [acc row-major, lse]. Returns a cudaError_t code.
extern "C" int mimo_estep(const float* xt, long long ld, int d, int p,
                          int kind, long long n, const float* theta, int k,
                          int m8, float* part, float* out, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < kKindGauss || kind > kKindDiag ||
      m8 < feature_width(kind, d, p))
    return cudaErrorInvalidValue;
  const size_t smem = mimo_estep_smem_bytes(k, m8);
  cudaError_t err;
  if (kind == kKindGauss)
    err = launch_estep<kGauss>(xt, ld, d, 0, false, n, nullptr, theta, k, m8,
                               part, grid, smem, s);
  else if (kind == kKindDiag)
    err = launch_estep<kDiag>(xt, ld, d, 0, false, n, nullptr, theta, k, m8,
                              part, grid, smem, s);
  else
    err = launch_estep<kIlr>(xt, ld, d, p, kind == kKindIlrAffine, n,
                             nullptr, theta, k, m8, part, grid, smem, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}

// S1: B1 over the Gauss map (xt (d, ld), points 0..n-1), with (divide =
// 1, B1 itself) or without the per-point normalisation; out as mimo_estep.
extern "C" int mimo_regf(const float* xt, long long ld, int d, long long n,
                         const float* theta, int k, int m8, int divide,
                         float* part, float* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0)) return cudaErrorInvalidValue;
  const size_t smem = mimo_estep_smem_bytes(k, m8);
  cudaError_t err =
      divide ? launch_estep<kGauss, true>(xt, ld, d, 0, false, n, nullptr,
                                          theta, k, m8, part, grid, smem, s)
             : launch_estep<kGauss, false>(xt, ld, d, 0, false, n, nullptr,
                                           theta, k, m8, part, grid, smem, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}

// S2: B1 over the Gauss map with the valid count given by `mode`
// (CountMode): 1 none, 2 the int32 *nv in device memory passed and not
// read, 3 *nv read and used (points >= min(*nv, n) masked). Modes 1
// and 2 take every point of n, which must be a multiple of the tile.
extern "C" int mimo_estep_count(const float* xt, long long ld, int d,
                                long long n, const int* nv, int mode,
                                const float* theta, int k, int m8,
                                float* part, float* out, int grid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m8 < feature_width(kKindGauss, d, 0) || mode < kCountNone ||
      mode > kCountMemUsed || (mode != kCountMemUsed && n % kThreads != 0))
    return cudaErrorInvalidValue;
  const size_t smem = mimo_estep_smem_bytes(k, m8);
  cudaError_t err;
  if (mode == kCountNone)
    err = launch_estep<kGauss, true, kCountNone>(
        xt, ld, d, 0, false, n, nv, theta, k, m8, part, grid, smem, s);
  else if (mode == kCountMemUnused)
    err = launch_estep<kGauss, true, kCountMemUnused>(
        xt, ld, d, 0, false, n, nv, theta, k, m8, part, grid, smem, s);
  else
    err = launch_estep<kGauss, true, kCountMemUsed>(
        xt, ld, d, 0, false, n, nv, theta, k, m8, part, grid, smem, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, grid, k * m8 + 1, out, s);
}

extern "C" const char* mimo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
