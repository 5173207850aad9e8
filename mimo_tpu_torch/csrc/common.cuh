// Shared device code of the mimo_tpu_torch kernels (B1 estep.cuh, B2
// gibbs.cuh, B3 predict.cu, B4 diag_predict.cu, B5/B6 ilr_predict.cuh): the
// feature maps' kinds and widths, the factor tables from which B1 and B2
// assemble every map, the online logsumexp, the counter-based Philox
// generator, and the fixed-order cross-block reduction.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block (power of two)

// Feature maps of the predictive kernel B3, a compile-time choice (its
// template parameter, like the static `features_t` of the TPU kernels).
// The C entries take a runtime `kind`: kKindGauss, the ILR map with
// (kKindIlrAffine) or without (kKindIlrLinear) the experts' ones column,
// kKindDiag, or the ILR map over a diagonal basis, [1; x; x^2] in place
// of [1; x; x (x) x], with (kKindIlrDiagAffine) or without
// (kKindIlrDiagLinear) the ones column; B1 and B2 assemble each of them
// from a FactorTable.
enum FeatureMap { kGauss = 0, kDiag = 2 };
constexpr int kKindGauss = 0, kKindIlrAffine = 1, kKindIlrLinear = 2,
              kKindDiag = 3, kKindIlrDiagAffine = 4, kKindIlrDiagLinear = 5;
constexpr int kKindLast = kKindIlrDiagLinear;

__host__ __device__ inline bool kind_is_ilr(int kind) {
  return kind == kKindIlrAffine || kind == kKindIlrLinear ||
         kind == kKindIlrDiagAffine || kind == kKindIlrDiagLinear;
}
// A diagonal basis block: [1; x; x^2].
__host__ __device__ inline bool kind_diag_basis(int kind) {
  return kind == kKindDiag || kind == kKindIlrDiagAffine ||
         kind == kKindIlrDiagLinear;
}
// The experts' ones column: xa = [x; 1].
__host__ __device__ inline bool kind_affine(int kind) {
  return kind == kKindIlrAffine || kind == kKindIlrDiagAffine;
}

// Width of a feature map (without the zero padding to m8).
inline int feature_width(int kind, int d, int np) {
  const int basis = kind_diag_basis(kind) ? 1 + 2 * d : 1 + d + d * d;
  if (!kind_is_ilr(kind)) return basis;
  const int q = d + (kind_affine(kind) ? 1 : 0);
  return basis + np * q + q * q + np * np;
}

// Every row of every map is the product of two entries of a point's
// z = [1; x (d rows); y (np rows); 0]: row j = z[a] * z[b] with
// ab[j] = a | b << 8, one f32 multiply, so a map assembled from its table
// equals the plain versions' maps (family_estep.py) bit for bit. Rows
// past the map's width are 0 * 0. The ILR table follows
// mimo_tpu/ops/family_estep.py::_product_features_t over
// (gauss_features_t, linear_features_t(affine)): [1; x; x (x) x;
// y (x) xa; xa (x) xa; y (x) y] with xa = [x; 1] when affine, and over
// a diagonal basis (diag_gauss_features_t) [1; x; x^2; ...] the same.
// fill_factor_table writes the first `rows` entries, on the host (the
// plain layout's FactorTable, a kernel parameter of up to kMaxTableRows
// rows, its widest F tile) or on the device (the streamed layout's table
// in device memory, any number of rows: tc.cuh st_prep).
__host__ __device__ inline void fill_factor_table(int kind, int d, int np,
                                                  int rows,
                                                  unsigned short* ab) {
  int j = 0;
  auto put = [&](int a, int b) {
    if (j < rows) ab[j++] = static_cast<unsigned short>(a | (b << 8));
  };
  auto xa = [d](int a) { return a < d ? 1 + a : 0; };   // [x; 1]
  put(0, 0);
  for (int a = 0; a < d; ++a) put(1 + a, 0);
  for (int a = 0; a < d; ++a) {
    if (kind_diag_basis(kind)) {
      put(1 + a, 1 + a);
    } else {
      for (int b = 0; b < d; ++b) put(1 + a, 1 + b);
    }
  }
  if (kind_is_ilr(kind)) {
    const int q = d + (kind_affine(kind) ? 1 : 0);
    for (int i = 0; i < np; ++i)
      for (int a = 0; a < q; ++a) put(1 + d + i, xa(a));
    for (int a = 0; a < q; ++a)
      for (int b = 0; b < q; ++b) put(xa(a), xa(b));
    for (int i = 0; i < np; ++i)
      for (int b = 0; b < np; ++b) put(1 + d + i, 1 + d + b);
  }
  const int zero = 1 + d + np;
  while (j < rows) put(zero, zero);
}

constexpr int kMaxTableRows = 256;
struct FactorTable {
  unsigned short ab[kMaxTableRows];
};

inline FactorTable factor_table(int kind, int d, int np, int rows) {
  FactorTable t;
  fill_factor_table(kind, d, np, rows, t.ab);
  return t;
}

// Online logsumexp of the serving kernels: fold v into (mx, s), s = sum
// exp(v_i - mx), with one exp: when v beats the running max the sum is
// rescaled by exp(mx - v) and gains 1, else it gains exp(v - mx). Sets
// `scale` to the factor the earlier terms were rescaled by (1 when mx
// stands, 0 for the first term) and returns v's weight exp(v - mx)
// against the new max. The exp is the MUFU's (__expf: within ~2^-21
// relative where a term weighs, against f32 roundings of 2^-24 in every
// lw; chip_smoke.py's float64 precision lines hold it).
__device__ __forceinline__ float online_add(float v, float& mx, float& s,
                                            float& scale) {
  const bool up = v > mx;
  const float e = __expf(up ? mx - v : v - mx);
  scale = up ? e : 1.0f;
  const float w = up ? 1.0f : e;
  s = s * scale + w;
  mx = up ? v : mx;
  return w;
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32 with 10
// rounds). Counter-based: the output depends only on (counter, key), so
// a point's draws do not depend on which block or thread produced them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// s += x, compensated (Kahan): c carries the low-order bits s lost.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// out[c ostride + o] = sum_b part[(c grid + b) w + o] in block order b =
// 0, 1, ..., a compensated sum for each chain c (blockIdx.y): the second
// pass of the bounded-grid reductions. Fixed order, no atomics, so a run
// is bitwise repeatable on a given grid.
__global__ void reduce_partials(const float* __restrict__ part, int grid,
                                int w, float* __restrict__ out,
                                size_t ostride) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= w) return;
  const float* pc = part + (size_t)blockIdx.y * grid * w;
  float s = 0.0f, c = 0.0f;
  for (int b = 0; b < grid; ++b) kahan_add(s, c, pc[(size_t)b * w + o]);
  out[(size_t)blockIdx.y * ostride + o] = s;
}

inline cudaError_t launch_reduce(const float* part, int grid, int w,
                                 float* out, cudaStream_t stream,
                                 int chains = 1, size_t ostride = 0) {
  reduce_partials<<<dim3((w + kThreads - 1) / kThreads, chains), kThreads, 0,
                    stream>>>(part, grid, w, out, ostride ? ostride : w);
  return cudaGetLastError();
}

}  // namespace
