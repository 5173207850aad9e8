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
// In the streamed layout (tc.cuh), pass (a) (gibbs_st_logits) forms a
// tile's logits once over K's chunks, as B1's does, writes them to scratch
// and draws the tile's labels from there, each point's draw spread over
// the G lanes a block has for it (G = 32 nw / kStT, up to 4): a lane takes
// every G-th Philox group and the lanes' best values meet by shuffles, so
// the labels stay those of the accurate draw. Pass (b) (gibbs_st_stats)
// adds one_hot F^T for the block's window of the statistics from the
// labels.
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

// The label draw of one point over the components [0, k), at(kk) its
// logit of component kk, shared by the G consecutive lanes (G a power of
// two up to 32; sub = this lane's index among them) that hold the point:
// lane sub takes the Philox groups sub, sub + G, ...; all G lanes return
// the label. It is the argmax of logit + the accurate draw, exactly, the
// first occurrence winning ties:
//   - a Philox group none of whose components can win (each logit plus
//     the largest draw, kGumbelMax, below the lane's best fast value less
//     its margin) is skipped, Philox call and logs;
//   - the others take the fast draw; f1 is the best fast value, k1 its
//     component, f2 the best of the others, over the lanes (shuffles);
//   - the winner's fast value is within fast_margin of f1. Where f1 leads
//     f2 by more, k1 wins. Else every lane draws its groups again
//     accurately, and the lanes' best (value, component) pairs meet.
// Near-ties within 2^-10 are rare (the top two of K Gumbel draws are
// ~Exp(1) apart), so few warps ever run the accurate logs. Every lane of
// the warp must call it (G > 1 shuffles over the whole warp).
template <class At>
__device__ __forceinline__ int draw_label(At&& at, int k, int sub, int lanes,
                                          unsigned long long up, uint2 key) {
  auto group_bits = [&](int gr) {
    return philox4x32_10(
        make_uint4(static_cast<unsigned>(up), static_cast<unsigned>(up >> 32),
                   static_cast<unsigned>(gr), 0u),
        key);
  };
  auto logits = [&](int gr, float (&sv)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sv[e] = 4 * gr + e < k ? at(4 * gr + e) : -INFINITY;
    return fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
  };
  float f1 = -INFINITY, f2 = -INFINITY, lo = -INFINITY;
  int k1 = k;                           // k: none yet
  for (int gr = sub; 4 * gr < k; gr += lanes) {
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
        f1 = v, k1 = 4 * gr + e;
        lo = f1 - fast_margin(f1);
      } else {
        f2 = fmaxf(f2, v);
      }
    }
  }
  for (int o = 1; o < lanes; o <<= 1) {
    const float of1 = __shfl_xor_sync(0xffffffffu, f1, o);
    const float of2 = __shfl_xor_sync(0xffffffffu, f2, o);
    const int ok1 = __shfl_xor_sync(0xffffffffu, k1, o);
    if (of1 > f1 || (of1 == f1 && ok1 < k1)) {
      f2 = fmaxf(of2, f1);
      f1 = of1, k1 = ok1;
    } else {
      f2 = fmaxf(f2, of1);
    }
  }
  const bool fast = f2 < f1 - fast_margin(f1);
  float bv = -INFINITY;
  int bk = k;
  if (!fast) {
    for (int gr = sub; 4 * gr < k; gr += lanes) {
      float sv[4];
      if (logits(gr, sv) + kGumbelMax < bv) continue;
      const uint4 r = group_bits(gr);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = sv[e] + gumbel_exact(bits[e]);
        if (4 * gr + e < k && v > bv) bv = v, bk = 4 * gr + e;
      }
    }
  }
  for (int o = 1; o < lanes; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int ob = __shfl_xor_sync(0xffffffffu, bk, o);
    if (ov > bv || (ov == bv && ob < bk)) bv = ov, bk = ob;
  }
  const int lab = fast ? k1 : bk;
  return lab < k ? lab : 0;
}

// One thread per point draws the labels in the plain layout, so a tile
// holds as many points as a K=50 block has threads where the widths allow.
__host__ __device__ constexpr int gibbs_tile(int nt) {
  return nt <= 2 ? 128 : nt <= 8 ? 64 : 32;
}

// The plain layout's logits tile holds all of K, then the tile's labels.
inline size_t gibbs_floats(int nt, int k, int rows) {
  const Layout l = layout(nt, k);
  const int t = gibbs_tile(nt);
  return tile_floats(l, t, rows) + (size_t)k * (t + 8) + (size_t)t;
}

template <int V>
__global__ void __launch_bounds__(max_threads(V))
gibbs_tc(const float* __restrict__ xt, long long ld, int rows, long long n,
         const float* __restrict__ theta, int k, int m8,
         const FactorTable tab, const long long* __restrict__ seed,
         int* __restrict__ labels, float* __restrict__ part) {
  using L = Tile<V, gibbs_tile(V)>;
  constexpr int NT = L::NT;
  const Layout ly = layout(V, k);
  extern __shared__ __align__(16) float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tha = smem;                                  // 16 nslab x 8 ntf
  float* zt = tha + 16 * ly.nslab * 8 * ly.ntf;       // 2 x (rows+2) x T
  float* fh = zt + 2 * (rows + 2) * L::T;             // mpf x FS
  float* fr = fh + ly.mpf * L::FS;                    // mpf x FS
  float* st = fr + ly.mpf * L::FS;                    // k x FS
  int* lab = reinterpret_cast<int*>(st + k * L::FS);  // T
  // chain blockIdx.z: its theta, its seed, its labels (chains, n)
  const unsigned long long s64 =
      static_cast<unsigned long long>(seed[blockIdx.z]);
  labels += (size_t)blockIdx.z * n;
  const uint2 key = make_uint2(static_cast<unsigned>(s64),
                               static_cast<unsigned>(s64 >> 32));

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

    {
      const int r0 = 16 * w + g;
      float s[L::J][4];
      slab_logits<L>(tha, fh, fr, ly.ntf, w, lane, s);
#pragma unroll
      for (int j = 0; j < L::J; ++j) {
        if (r0 < k)
          *reinterpret_cast<float2*>(st + r0 * L::FS + 8 * j + 2 * t) =
              make_float2(s[j][0], s[j][1]);
        if (r0 + 8 < k)
          *reinterpret_cast<float2*>(st + (r0 + 8) * L::FS + 8 * j + 2 * t) =
              make_float2(s[j][2], s[j][3]);
      }
    }
    __syncthreads();                       // the logits ready

    for (int cp = threadIdx.x; cp < L::T; cp += blockDim.x) {
      const long long p = tile * L::T + cp;
      int best = -1;
      if (p < n) {
        const float* sp = st + cp;
        best = draw_label([&](int kk) { return sp[kk * L::FS]; }, k, 0, 1,
                          static_cast<unsigned long long>(p), key);
        labels[p] = best;
      }
      lab[cp] = best;
    }
    __syncthreads();                       // the draws ready

    const int rw = 16 * w + g;             // the slab's rows
#pragma unroll
    for (int u = 0; u < L::J; ++u) {       // points 8u + 2t, 8u + 2t + 1
      const int2 q = *reinterpret_cast<const int2*>(lab + 8 * u + 2 * t);
      const float a[4] = {q.x == rw ? 1.f : 0.f, q.x == rw + 8 ? 1.f : 0.f,
                          q.y == rw ? 1.f : 0.f, q.y == rw + 8 ? 1.f : 0.f};
      stats_step<L, false>(acc, a, a, fh, fr, u, lane);
    }
    wait_copies();                         // the next z tile has landed
    __syncthreads();                       // F tiles free for the next tile
  }

  store_slab<L>(acc, k, m8, 16 * w, 0, lane,
                part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * k * m8);
}

// The variant B2 runs at (k, m8) over `rows` input rows.
inline int gibbs_variant(int k, int m8, int rows) {
  return pick_variant(k, m8,
                      [&](int nt) { return gibbs_floats(nt, k, rows); });
}

// theta (chains, k, m8), seed (chains,), labels (chains, n), part
// (chains, grid, k m8).
template <int V>
cudaError_t launch_gibbs(const float* xt, long long ld, int rows,
                         long long n, const float* theta, int k, int m8,
                         const FactorTable& tab, const long long* seed,
                         int* labels, float* part, int grid, int chains,
                         cudaStream_t s) {
  const size_t smem = sizeof(float) * gibbs_floats(V, k, rows);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_tc<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gibbs_tc<V><<<dim3(grid, 1, chains), 32 * slabs(k), smem, s>>>(
      xt, ld, rows, n, theta, k, m8, tab, seed, labels, part);
  return cudaGetLastError();
}

// B2's launch at width v, compiled here for the widths in [kMin, kMax].
template <int kMin, int kMax>
cudaError_t gibbs_variants(int v, const float* xt, long long ld, int d,
                           int p, int kind, long long n, const float* theta,
                           int k, int m8, const long long* seed, int* labels,
                           float* part, int grid, int chains,
                           cudaStream_t s) {
  const FactorTable tab = factor_table(kind, d, p, v > 0 ? 8 * v : 0);
  return dispatch_variant<kMin, kMax>(
      v, cudaErrorInvalidValue, [&](auto c) {
        return launch_gibbs<decltype(c)::value>(
            xt, ld, d + p, n, theta, k, m8, tab, seed, labels, part, grid,
            chains, s);
      });
}

// B2's persistent grid at width v: minus a CUDA error code on failure.
template <int kMin, int kMax>
int gibbs_grid_variants(int v, int k, int m8, int rows, long long n) {
  return dispatch_variant<kMin, kMax>(
      v, -(int)cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        const long long ntiles = (n + gibbs_tile(V) - 1) / gibbs_tile(V);
        return persistent_grid(gibbs_tc<V>, 32 * slabs(k),
                               sizeof(float) * gibbs_floats(V, k, rows),
                               ntiles, 1);
      });
}

// -- the streamed layout (tc.cuh) ------------------------------------------

// Pass (a) over the segment of points [s0, s0 + seg): each tile's logits
// into sg (tc.cuh st_store_logits), then each point's label drawn from
// them by its G lanes (draw_label) into labels (chains, n).
template <int T>
__global__ void __launch_bounds__(kStWarps * 32)
gibbs_st_logits(const float* __restrict__ xt, long long ld, int rows,
                long long n, long long s0, const float4* __restrict__ thp,
                int k, const unsigned short* __restrict__ tab,
                const Streamed g, const long long* __restrict__ seed,
                float4* __restrict__ sg, int* __restrict__ labels) {
  constexpr int J = T / 8;
  using L = Tile<1, T>;
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                                    // (rows + 2) x T
  float* fbuf = zt + (rows + 2) * T;                   // 2 x 2 x 8 x FS
  const unsigned long long s64 =
      static_cast<unsigned long long>(seed[blockIdx.z]);
  const uint2 key = make_uint2(static_cast<unsigned>(s64),
                               static_cast<unsigned>(s64 >> 32));
  labels += (size_t)blockIdx.z * n;
  thp += (size_t)blockIdx.z * g.nslab * g.ntf * 32;
  sg += (size_t)blockIdx.z * (g.seg / 8) * g.nslab * 32;
  const long long ntiles = (min(g.seg, n - s0) + T - 1) / T;
  // G lanes a point, blockDim.x / G points a pass over the tile
  const int lanes = max(1, (int)blockDim.x / T);
  const int per = blockDim.x / lanes, sub = threadIdx.x % lanes;

  for (long long tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    stage_z<L, false>(xt, ld, rows, s0 / T + tl, n, zt);
    wait_copies();
    __syncthreads();
    for (int c = 0; c < g.nchunk; ++c) {
      float s[kStSpw][J][4];
      st_chunk_logits(thp, g, c, tab, zt, fbuf, s);
      st_store_logits(s, g, c, k, tl, sg);
    }
    __syncthreads();                       // the tile's logits visible
    const float* sgt =
        reinterpret_cast<const float*>(sg + (size_t)tl * J * g.nslab * 32);
    for (int base = 0; base < T; base += per) {
      const int col = base + threadIdx.x / lanes;
      const long long p = s0 + tl * T + col;
      const int lab = draw_label(
          [&](int kk) { return st_logit(sgt, g.nslab, kk, col); }, k, sub,
          lanes, static_cast<unsigned long long>(p), key);
      if (sub == 0 && p < n) labels[p] = lab;
    }
    __syncthreads();                       // z tile free
  }
}

// Pass (b) over the segment: acc += one_hot(labels) F^T for the block's
// window (as estep_st_stats) over its split of the segment's tiles, added
// into part (chains, gridDim.y, k m8). One-hots are exact in TF32; F
// enters in two passes (stats_step).
template <int NT>
__global__ void __launch_bounds__(kStWarps * 32)
gibbs_st_stats(const float* __restrict__ xt, long long ld, int rows,
               long long n, long long s0, int k, int m8,
               const unsigned short* __restrict__ tab, const Streamed g,
               const int* __restrict__ labels, float* __restrict__ part) {
  using L = Tile<NT, kStT>;
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                                    // (rows + 2) x T
  float* fh = zt + (rows + 2) * L::T;                  // 8 NT x FS
  float* fr = fh + 8 * NT * L::FS;                     // 8 NT x FS
  int* lab = reinterpret_cast<int*>(fr + 8 * NT * L::FS);   // T
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  labels += (size_t)blockIdx.z * n;
  part += ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * k * m8;
  const int kc = blockIdx.x / g.mw, col0 = 8 * NT * (blockIdx.x % g.mw);
  const long long ntiles = (min(g.seg, n - s0) + L::T - 1) / L::T;

  float acc[kStSpw][NT][4];
#pragma unroll
  for (int i = 0; i < kStSpw; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
      acc[i][jn][0] = acc[i][jn][1] = acc[i][jn][2] = acc[i][jn][3] = 0.f;
  for (long long tl = blockIdx.y; tl < ntiles; tl += gridDim.y) {
    stage_z<L, false>(xt, ld, rows, s0 / L::T + tl, n, zt);
    for (int c = threadIdx.x; c < L::T; c += blockDim.x) {
      const long long p = s0 + tl * L::T + c;
      lab[c] = p < n ? labels[p] : -1;
    }
    wait_copies();
    __syncthreads();
    st_form_rows(tab, col0, 8 * NT, zt, fh, fr);
    __syncthreads();                       // the window's F rows ready
#pragma unroll
    for (int u = 0; u < L::J; ++u) {       // points 8u + 2t, 8u + 2t + 1
      const int2 q = *reinterpret_cast<const int2*>(lab + 8 * u + 2 * t);
#pragma unroll
      for (int i = 0; i < kStSpw; ++i) {
        const int sl = st_slab(g, kc, i);
        if (sl >= g.nslab) continue;
        const int rw = 16 * sl + gq;
        const float a[4] = {q.x == rw ? 1.f : 0.f, q.x == rw + 8 ? 1.f : 0.f,
                            q.y == rw ? 1.f : 0.f,
                            q.y == rw + 8 ? 1.f : 0.f};
        stats_step<L, false>(acc[i], a, a, fh, fr, u, lane);
      }
    }
    __syncthreads();                       // z, F and label tiles free
  }
#pragma unroll
  for (int i = 0; i < kStSpw; ++i) {
    const int sl = st_slab(g, kc, i);
    if (sl < g.nslab) add_slab<L>(acc[i], k, m8, 16 * sl, col0, lane, part);
  }
}

}  // namespace

// The wide widths and the streamed layout (gibbs_wide.cu): B2's launch
// at width v, without the second pass, and its grid; B2 in the streamed
// layout and its scratch.
extern "C" int mimo_gibbs_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8,
                               const long long* seed, int* labels,
                               float* part, int grid, int chains,
                               void* stream);
extern "C" int mimo_gibbs_grid_wide(int v, int k, int m8, int rows,
                                    long long n);
extern "C" int mimo_gibbs_streamed(const float* xt, long long ld, int d,
                                   int p, int kind, long long n,
                                   const float* theta, int k, int m8,
                                   const long long* seed, int* labels,
                                   float* work, float* out, int chains,
                                   void* stream);
extern "C" long long mimo_gibbs_streamed_scratch(int k, int m8, int rows,
                                                 int chains);
