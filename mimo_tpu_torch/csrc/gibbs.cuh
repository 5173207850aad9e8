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
// What bounds it on the H100: per point, the K m multiply-adds of the
// logits (six TF32 passes each on the tensor cores, the precision rule of
// estep.cuh) and, for the components that can win, 2 logarithms each and
// a Philox4x32-10 call (~100 integer operations) per group of 4; at K=50,
// d=2 the Philox integer work sets the bound where many groups are live,
// the logits where few are (chip_smoke.py counts each run's). The kernel
// before this design spent most of its time elsewhere: its logits were
// shared-memory dot products as in B1, and its statistics scanned all 128
// labels of a tile for every one of the K m8 outputs, K m8
// compare-and-adds per point where the one-hot needs m8.
//
// Design: the tiles and the logits of B1 (tc.cuh, the same precision
// rule), then, per tile:
//   1. each warp writes its S slab (rows < K) to a shared (K x T) tile;
//   2. one thread per point draws the Philox groups of 4 components and
//      takes the argmax, reading S from shared memory. Philox's groups of
//      4 components do not match the mma fragments (a thread holds rows
//      g and g + 8), so the draw is not made per fragment element, which
//      would repeat each Philox call four times. Groups that cannot win
//      are skipped, and a fast MUFU draw picks the winner, the accurate
//      logs deciding only near-ties (draw_label): the labels are exactly
//      those of the full accurate draw, and in a fitted mixture most
//      components are far from most points;
//   3. the one-hot statistics are one more tensor-core product,
//      one_hot (K x T) F^T: a one-hot is exact in TF32, F is split hi/lo
//      as in B1, so each point adds its F row to its component's slab in
//      two passes, with B1's permuted contraction index.
// In the chunked layout (tc.cuh) steps 1 and 2 run once per chunk of K,
// each point's best draw so far kept in shared memory between them, and
// step 3 adds the block's window. The labels are those of the plain
// version's f32 logf draw, so they match it up to the rounding of the
// logits.
// Philox is keyed by the sweep seed (64 bits from the engine's
// generator, read from device memory so the sweep loop never syncs the
// host) and countered by the global point index and the component group,
// so labels are independent of the grid and match the plain PyTorch
// Philox draw for draw (up to near-ties of the logits' rounding). The
// statistics use B1's persistent grid and per-block partials with a
// fixed-order second pass: no float atomics.
// Chains (tc.cuh): chain c = blockIdx.z draws with its own seed[c] over
// the shared points, so its labels equal a one-chain launch at seed[c]
// exactly, whatever the grid; S sweeps of one fixed theta are S chains of
// that theta (the two-sample check, ops/precision.py).
#pragma once

#include "tc.cuh"

namespace {

// Above the largest Gumbel draw (15.94, at u = 1 - 2^-23; the fast one
// within 6e-5 of it): a component whose logit plus kGumbelMax stays below
// the best logit + draw found so far (in f32, whose rounding is monotone)
// cannot win the argmax.
constexpr float kGumbelMax = 16.0f;

__device__ __forceinline__ float sv_at(const float* sp, int fs, int base,
                                       int kk) {
  return sp[(kk - base) * fs];
}

// The Gumbel draw g = -log(-log(u + 1e-20) + 1e-20) from the MUFU's
// __logf: -log(u) by __logf (CUDA's bound: 2^-21.41 absolute on [0.5, 2],
// so relative 2^-21.41 / 2^-7 where -log u >= 2^-7; 3 ulp below 0.5) or,
// where -log u < 2^-7 and that absolute error would not do, by its series
// in the exact r = 1 - u (4 terms, relative error under 2^-28); then the
// outer __logf (2^-21.41 absolute, or 3 ulp of a result below 16).
// Together under 6e-5 from the accurate draw for every u of the 2^23.
__device__ __forceinline__ float gumbel_fast(float u) {
  const float r = 1.0f - u;
  const float w =
      r <= 0.0078125f
          ? r * fmaf(r, fmaf(r, fmaf(r, 0.25f, 1.0f / 3), 0.5f), 1.0f)
          : -__logf(u + 1e-20f);
  return -__logf(w + 1e-20f);
}

__device__ __forceinline__ float gumbel_exact(unsigned bits) {
  const float u = (float)(bits >> 9) * 1.1920928955078125e-07f;
  return -logf(-logf(u + 1e-20f) + 1e-20f);
}

__global__ void gumbel_fast_table(float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  out[m] = gumbel_fast((float)m * 1.1920928955078125e-07f);
}

// Below x minus this a fast logit + draw is certainly below the accurate
// logit + draw of x: 2^-10 against the fast draw's 6e-5, and 2^-18 |x|
// for the f32 rounding of logit + draw.
__device__ __forceinline__ float fast_margin(float x) {
  return 0x1p-10f + fabsf(x) * 0x1p-18f;
}

// The label draw of one point over the components [base, kend) of the
// logits column sp (row stride fs, row 0 = component base), merged into
// (bestv, best): the accurate draw's best logit + draw so far and its
// component, earlier components winning ties (the first occurrence).
// The label is the argmax of logit + the accurate draw, exactly:
//   - a Philox group none of whose components can win (each logit plus
//     the largest draw, kGumbelMax, below the best so far) is skipped,
//     Philox call and logs;
//   - the others take the fast draw; f1 is the best fast value, k1 its
//     component (b1 its Philox bits), f2 the best of the others;
//   - the winner's fast value is within fast_margin of f1. Where f1 leads
//     f2 and the best so far by more, k1 wins, and the accurate draw is
//     taken only for the value the chunked layout carries to its next
//     chunk (kValue). Else the range is drawn again, every component
//     accurately.
// Near-ties within 2^-10 are rare (the top two of K Gumbel draws are
// ~Exp(1) apart), so few warps ever run the accurate logs.
template <bool kValue>
__device__ __forceinline__ void draw_label(const float* sp, int fs, int base,
                                           int kend, int k,
                                           unsigned long long up, uint2 key,
                                           float& bestv, int& best) {
  auto group_bits = [&](int gr) {
    return philox4x32_10(
        make_uint4(static_cast<unsigned>(up), static_cast<unsigned>(up >> 32),
                   static_cast<unsigned>(gr), 0u),
        key);
  };
  auto logits = [&](int gr, float (&sv)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sv[e] = 4 * gr + e < k ? sp[(4 * gr + e - base) * fs] : -INFINITY;
    return fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
  };
  float f1 = -INFINITY, f2 = -INFINITY, lo = bestv;
  int k1 = -1;
  unsigned b1 = 0;
  for (int gr = base / 4; 4 * gr < kend; ++gr) {
    float sv[4];
    if (logits(gr, sv) + kGumbelMax < lo) continue;
    const uint4 r = group_bits(gr);
    const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * gr + e >= k) continue;
      const float v =
          sv[e] + gumbel_fast((float)(bits[e] >> 9) * 1.1920928955078125e-07f);
      if (v > f1) {
        f2 = f1;
        f1 = v, k1 = 4 * gr + e, b1 = bits[e];
        lo = fmaxf(bestv, f1 - fast_margin(f1));
      } else {
        f2 = fmaxf(f2, v);
      }
    }
  }
  if (k1 < 0) return;
  const float m1 = f1 - fast_margin(f1);
  if (f2 < m1 && (kValue || bestv < m1)) {
    if (!kValue) {
      best = k1;
      return;
    }
    const float v = sv_at(sp, fs, base, k1) + gumbel_exact(b1);
    if (v > bestv) bestv = v, best = k1;
    return;
  }
  for (int gr = base / 4; 4 * gr < kend; ++gr) {
    float sv[4];
    if (logits(gr, sv) + kGumbelMax < bestv) continue;
    const uint4 r = group_bits(gr);
    const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = sv[e] + gumbel_exact(bits[e]);
      if (4 * gr + e < k && v > bestv) bestv = v, best = 4 * gr + e;
    }
  }
}

// One thread per point draws the labels, so a tile holds as many points
// as a K=50 block has threads where the widths allow.
__host__ __device__ constexpr int gibbs_tile(int v) {
  return v == kChunked ? kChunkT : v <= 2 ? 128 : v <= 8 ? 64 : 32;
}

// The plain layout's logits tile holds all of K; the chunked layout's one
// chunk, and it keeps each point's best draw across the chunks.
inline size_t gibbs_floats(int v, int k, int m8, int rows) {
  const Layout l = layout(v, k, m8);
  const int t = gibbs_tile(v);
  return tile_floats(l, t, rows) +
         (size_t)std::min(k, 16 * l.nw) * (t + 8) +
         (v == kChunked ? 2 : 1) * (size_t)t;
}

template <int V>
__global__ void __launch_bounds__(max_threads(variant_nt(V)))
gibbs_tc(const float* __restrict__ xt, long long ld, int rows, long long n,
         const float* __restrict__ theta, int k, int m8,
         const FactorTable tab, const long long* __restrict__ seed,
         int* __restrict__ labels, float* __restrict__ part) {
  using L = Tile<variant_nt(V), gibbs_tile(V)>;
  constexpr int NT = L::NT;
  const Layout ly = layout(V, k, m8);
  extern __shared__ __align__(16) float smem[];
  const int nw = ly.nw, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = 16 * nw;                             // rows of a chunk
  float* tha = smem;                                  // 16 nslab x 8 ntf
  float* zt = tha + 16 * ly.nslab * 8 * ly.ntf;       // 2 x (rows+2) x T
  float* fh = zt + 2 * (rows + 2) * L::T;             // mpf x FS
  float* fr = fh + ly.mpf * L::FS;                    // mpf x FS
  float* st = fr + ly.mpf * L::FS;                    // min(k, ch) x FS
  int* lab = reinterpret_cast<int*>(st + min(k, ch) * L::FS);  // T
  float* bv = reinterpret_cast<float*>(lab + L::T);   // T (chunked)
  // chain blockIdx.z: its theta, its seed, its labels (chains, n)
  const unsigned long long s64 =
      static_cast<unsigned long long>(seed[blockIdx.z]);
  labels += (size_t)blockIdx.z * n;
  const uint2 key = make_uint2(static_cast<unsigned>(s64),
                               static_cast<unsigned>(s64 >> 32));
  // the statistics window: chunk y of K's slabs, columns 8 NT z ..
  const int y = V == kChunked ? blockIdx.y / ly.nz : 0;
  const int z = V == kChunked ? blockIdx.y % ly.nz : 0;

  stage_theta(theta + (size_t)blockIdx.z * k * m8, k, m8, ly, tha);
  const long long ntiles = (n + L::T - 1) / L::T;
  if (blockIdx.x < ntiles) stage_z<L, false>(xt, ld, rows, blockIdx.x, n, zt);
  wait_copies();
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, buf ^= 1) {
    assemble_f<L>(tab, ly.mpf, zt + buf * (rows + 2) * L::T, fh, fr);
    __syncthreads();                       // F ready; this z tile is free
    if (tile + gridDim.x < ntiles)
      stage_z<L, false>(xt, ld, rows, tile + gridDim.x, n,
                        zt + (buf ^ 1) * (rows + 2) * L::T);

    for (int c = 0; c < ly.nchunk; ++c) {
      const int sl = c * nw + w, r0 = 16 * sl + g - c * ch, base = c * ch;
      if (V != kChunked || sl < ly.nslab) {
        float s[L::J][4];
        slab_logits<L>(tha, fh, fr, ly.ntf, sl, lane, s);
#pragma unroll
        for (int j = 0; j < L::J; ++j) {
          if (base + r0 < k)
            *reinterpret_cast<float2*>(st + r0 * L::FS + 8 * j + 2 * t) =
                make_float2(s[j][0], s[j][1]);
          if (base + r0 + 8 < k)
            *reinterpret_cast<float2*>(st + (r0 + 8) * L::FS + 8 * j +
                                       2 * t) = make_float2(s[j][2], s[j][3]);
        }
      }
      __syncthreads();                     // the chunk's logits ready

      const int kend = min(k, base + ch);
      for (int cp = threadIdx.x; cp < L::T; cp += blockDim.x) {
        const long long p = tile * L::T + cp;
        int best = -1;
        float bestv = -INFINITY;
        if (c > 0) {
          best = lab[cp];
          bestv = bv[cp];
        }
        if (p < n) {
          const unsigned long long up = static_cast<unsigned long long>(p);
          if (c == 0) best = 0;
          draw_label<V == kChunked>(st + cp, L::FS, base, kend, k, up, key,
                                    bestv, best);
          if (c == ly.nchunk - 1 && blockIdx.y == 0) labels[p] = best;
        }
        lab[cp] = best;
        if (V == kChunked) bv[cp] = bestv;
      }
      __syncthreads();                     // the draws so far ready
    }

    const int rw = 16 * (y * nw + w) + g;  // the window's rows of the slab
#pragma unroll
    for (int u = 0; u < L::J; ++u) {       // points 8u + 2t, 8u + 2t + 1
      const int2 q = *reinterpret_cast<const int2*>(lab + 8 * u + 2 * t);
      const float a[4] = {q.x == rw ? 1.f : 0.f, q.x == rw + 8 ? 1.f : 0.f,
                          q.y == rw ? 1.f : 0.f, q.y == rw + 8 ? 1.f : 0.f};
      stats_step<L, false>(acc, a, a, fh + 8 * NT * z * L::FS,
                           fr + 8 * NT * z * L::FS, u, lane);
    }
    wait_copies();                         // the next z tile has landed
    __syncthreads();                       // F tiles free for the next tile
  }

  store_slab<L>(acc, k, m8, 16 * (y * nw + w), 8 * NT * z, lane,
                part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * k * m8);
}

// The variant B2 runs at (k, m8) over `rows` input rows.
inline int gibbs_variant(int k, int m8, int rows) {
  return pick_variant(k, m8,
                      [&](int v) { return gibbs_floats(v, k, m8, rows); });
}

// theta (chains, k, m8), seed (chains,), labels (chains, n), part
// (chains, grid, k m8).
template <int V>
cudaError_t launch_gibbs(const float* xt, long long ld, int rows,
                         long long n, const float* theta, int k, int m8,
                         const FactorTable& tab, const long long* seed,
                         int* labels, float* part, int grid, int chains,
                         cudaStream_t s) {
  const Layout ly = layout(V, k, m8);
  const size_t smem = sizeof(float) * gibbs_floats(V, k, m8, rows);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_tc<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gibbs_tc<V><<<dim3(grid, ly.nchunk * ly.nz, chains), 32 * ly.nw, smem,
                s>>>(
      xt, ld, rows, n, theta, k, m8, tab, seed, labels, part);
  return cudaGetLastError();
}

// B2's launch at variant v, compiled here for the widths in [kMin, kMax]
// and, where kChunk, the chunked layout.
template <int kMin, int kMax, bool kChunk>
cudaError_t gibbs_variants(int v, const float* xt, long long ld, int d,
                           int p, int kind, long long n, const float* theta,
                           int k, int m8, const long long* seed, int* labels,
                           float* part, int grid, int chains,
                           cudaStream_t s) {
  const FactorTable tab =
      factor_table(kind, d, p, v ? layout(v, k, m8).mpf : 0);
  return dispatch_variant<kMin, kMax, kChunk>(
      v, cudaErrorInvalidValue, [&](auto c) {
        return launch_gibbs<decltype(c)::value>(
            xt, ld, d + p, n, theta, k, m8, tab, seed, labels, part, grid,
            chains, s);
      });
}

// B2's persistent grid at variant v: minus a CUDA error code on failure.
template <int kMin, int kMax, bool kChunk>
int gibbs_grid_variants(int v, int k, int m8, int rows, long long n) {
  return dispatch_variant<kMin, kMax, kChunk>(
      v, -(int)cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        const Layout ly = layout(V, k, m8);
        const long long ntiles = (n + gibbs_tile(V) - 1) / gibbs_tile(V);
        return persistent_grid(gibbs_tc<V>, 32 * ly.nw,
                               sizeof(float) * gibbs_floats(V, k, m8, rows),
                               ntiles, ly.nchunk * ly.nz);
      });
}

}  // namespace

// The wide widths and the chunked layout (gibbs_wide.cu): B2's launch at
// variant v, without the second pass, and its grid.
extern "C" int mimo_gibbs_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8,
                               const long long* seed, int* labels,
                               float* part, int grid, int chains,
                               void* stream);
extern "C" int mimo_gibbs_grid_wide(int v, int k, int m8, int rows,
                                    long long n);
