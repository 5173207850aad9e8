// Kernel B1: fused mixture E-step over the full-covariance Gaussian, the
// diagonal Gaussian or the ILR product feature map. Replaces
// mimo_tpu/ops/pallas_estep.py::_estep_kernel2.
//
// Per point p < n: F = features(p) ([1; x; x (x) x] for a Gaussian,
// [1; x; x^2] for a diagonal Gaussian, [1; x; x (x) x; y (x) xa;
// xa (x) xa; y (x) y] for ILR with MNW or MNG experts; common.cuh),
// logp_k = theta_k . F (theta's column 0 carries c + log pi, so counts
// fall out of acc[:, 0]), a softmax over K with the 1e-37 denominator
// floor of the TPU kernel,
//   acc(K, m8) += (ex / denom) F^T,   lse += max + log(denom).
//
// What bounds it on the H100. A point is 4 (d + p) bytes of input
// against 2 K m multiply-adds (the logits S = theta F and the statistics
// P F^T, m the map's width) and K exponentials. On the tensor cores at the
// precision rule's passes below (six for S, three for P F^T) that is
// 9 K m TF32 multiply-adds, at 247.5e12/s: 0.13 ms at N=1e7, K=50, d=2
// (m = 7), where the K exps on the MUFU (4.2e12/s) take 0.12 ms, and
// 0.30 ms at the ILR q8 shape (N=1e6, m = 164). The same products on the
// f32 units, one pass each (33.5e12 FMA/s), would take 0.21 and 0.49 ms;
// bytes bound nothing (chip_smoke.py computes each run's bound). The
// kernel before this design reached 6% of the f32 bound: each FMA of its
// (K, m8) tile reduction took two shared-memory operands, one warp-wide
// LDS per clock per SM against four FFMAs.
//
// Design. Both products run on the tensor cores, warp-level
// mma.sync.m16n8k8 TF32 with f32 accumulation (tc.cuh); wgmma is not
// needed while the kernel is far from the tensor-core limit. In the plain
// layout (tc.cuh) a block has one warp per 16-row slab of K (padded, rows
// >= K are -inf logits) and walks tiles of T points (64 to m8 = 64, else
// 32):
//   1. the tile's inputs z = [1; x; y] (copied the tile before) become
//      the F tiles, each row one product z_a z_b (FactorTable);
//   2. each warp forms its S slab in registers and, per column, the
//      slab's max and sum exp(S - max) by shuffles over the 8 lanes that
//      hold it; the (max, sum) pairs go through shared memory;
//   3. each warp folds the W pairs of a column into the column's max M
//      and denominator, and its own factor exp(max_w - M) / den: the
//      normalisation is one multiply of the S fragments in registers, no
//      per-point divide (what probe S1 measured);
//   4. P F^T accumulates into the warp's (16 x m8) statistics slab, kept
//      in registers across all of the block's tiles (84 registers a
//      thread at m8 = 168). The C fragment of S is not the A fragment
//      of the second product (columns 2t, 2t+1 against t, t+4), so the
//      contraction index is permuted instead (k = t <-> point 2t,
//      k = t + 4 <-> point 2t + 1; tc.cuh stats_step): P passes from
//      the first product to the second in the same registers, through
//      neither shared memory nor shuffles.
// In the streamed layout (tc.cuh; a K or m8 the plain one cannot hold:
// the Gauss map at d >= 16, the ILR map at d >= 16, K > 256) no block
// holds theta, F or the statistics whole. Pass (a) (estep_st_logits)
// forms each point's logits once, walking theta's 8-feature steps from
// device memory (L2) and forming F's rows a step at a time from the z
// tile; it folds each point's (max, sum exp) over K's chunks and writes
// the logits, (max, 1 / denominator) and the lse partials to scratch.
// Pass (b) (estep_st_stats) accumulates P F^T output-stationary: a block
// owns a (K chunk x 8 NT columns) window, re-forms those F rows from z,
// forms P = exp(S - max) / denominator from the scratch and adds its
// window into its split's partials. The segments of points go in order
// and every partial belongs to one block, so no float atomics: a run is
// bitwise repeatable. The alternative, re-forming the logits for every
// window of statistics (the chunked layout before it), costs (m8 / 32)
// times the logits' work: 34x at d=32.
// In the plain layout shared memory holds theta, the z and F tiles and
// the per-column pairs (estep_floats): 101 KB at K=50, m8=168, so two
// blocks fit per SM. A persistent grid (SMs x resident blocks,
// estep_grid_variants) strides over the tiles; per-block partials go to
// a scratch buffer and a second kernel sums them in block order: no float
// atomics, so a run is bitwise repeatable on a given card. With C chains (tc.cuh, blockIdx.z)
// each chain has the one-chain grids, its own partials and its own second
// pass, so a chain's result is bitwise that of a one-chain launch.
//
// Precision rule (tests/test_torch_precision.py emulates it on the CPU;
// chip_smoke.py measures it against float64 on the card). One TF32 pass
// keeps 11 significant bits. The logits take six passes per 8-feature
// step, theta and F each split exactly in three tf32 parts (an f32 has
// 24 bits): every product term down to 2^-22 relative, lo F_hi + hi F_lo
// + mid F_mid + mid F_hi + hi F_mid + hi F_hi; the terms dropped are
// below 2^-33. theta's rounding is systematic per component (the TPU
// kernel's argument, pallas_estep.py:53-68): split only in two (3xTF32),
// the emulated B1 at unit-precision components 10 sigma from the origin
// has 23x the lse error and 17x the statistics error of plain f32 against
// float64, the rule 0.9x and 0.5x. F's rounding is per point: in two
// parts (to 2^-22, 4x f32's rounding) it averages out at fitted theta,
// but at probe S1's inputs (precisions ~5e8, logits cancelling terms two
// orders larger) S1's statistics reached 1.33e-5 of their summed
// magnitude against the bound of 1e-5, 7.9e-6 with F exact (chip_smoke.py
// phase 13 on an H100). The statistics take three passes, P and
// F in two: P_lo F_hi + P_hi F_lo + P_hi F_hi; with P in one pass (the
// TPU kernel's single pass) the emulated statistics error is 54-114x
// plain f32's. Passes chain in the tensor core, whose adds truncate, only
// within one 8-feature or 8-point step and are added to f32 registers
// outside it; the lse and the cross-block pass are compensated sums.
//
// Two probes of B1's cost, the ports of the TPU bisection kernels, are
// template parameters of the same kernel, run over the Gauss map
// (probes.cu); no model launches them:
//   S1 (scripts/bisect_pallas.py::_regf_kernel): kDivide = false drops
//      the normalisation, so acc accumulates sum ex F^T with ex =
//      exp(logp - max) (lse is unchanged). It isolates what the divide
//      costs.
//   S2 (scripts/bisect_smem.py::kern_*): where the valid count lives. The
//      TPU probe read a scalar from SMEM; here kCount selects the count
//      as a kernel argument (B1 itself), none at all (N a multiple of the
//      tile: no per-point test), an int32 in device memory passed and not
//      read, or one read once per block and used to mask the points at or
//      past it, which then contribute nothing (as B1's tail; the TPU
//      probe's masked columns divide by a zero denominator).
#pragma once

#include "tc.cuh"

namespace {

enum CountMode { kCountArg = 0, kCountNone = 1, kCountMemUnused = 2,
                 kCountMemUsed = 3 };

__host__ __device__ constexpr int estep_tile(int nt) {
  return nt <= 8 ? 64 : 32;
}

inline size_t estep_floats(int nt, int k, int rows) {
  const Layout l = layout(nt, k);
  const int t = estep_tile(nt);
  return tile_floats(l, t, rows) + 3 * (size_t)l.nslab * t;
}

// (mr, er) <- the (max, sum exp(. - max)) pair of the union of the terms
// of (mr, er) and (m, e); -inf maxima (no terms) carry no weight.
__device__ __forceinline__ void fold_max_sum(float& mr, float& er, float m,
                                             float e) {
  const float mx = fmaxf(mr, m);
  if (mx == -INFINITY) return;
  er = er * exp_neg(mr - mx) + e * exp_neg(m - mx);
  mr = mx;
}

template <int V, bool kDivide = true, int kCount = kCountArg>
__global__ void __launch_bounds__(max_threads(V))
estep_tc(const float* __restrict__ xt, long long ld, int rows, long long n,
         const int* __restrict__ nv, const float* __restrict__ theta, int k,
         int m8, const FactorTable tab, float* __restrict__ part) {
  using L = Tile<V, estep_tile(V)>;
  constexpr int NT = L::NT;
  const Layout ly = layout(V, k);
  extern __shared__ __align__(16) float smem[];
  const int nw = ly.nslab, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tha = smem;                                  // 16 nslab x 8 ntf
  float* zt = tha + 16 * ly.nslab * 8 * ly.ntf;       // 2 x (rows+2) x T
  float* fh = zt + 2 * (rows + 2) * L::T;             // mpf x FS
  float* fr = fh + ly.mpf * L::FS;                    // mpf x FS
  float2* red = reinterpret_cast<float2*>(fr + ly.mpf * L::FS);  // W x T
  float* sc = reinterpret_cast<float*>(red + nw * L::T);          // W x T
  constexpr bool kAllValid =
      kCount == kCountNone || kCount == kCountMemUnused;
  long long valid = n;
  if constexpr (kCount == kCountMemUsed) valid = min(n, (long long)*nv);

  stage_theta(theta + (size_t)blockIdx.z * k * m8, k, m8, ly, tha);
  const long long ntiles = (n + L::T - 1) / L::T;
  if (blockIdx.x < ntiles)
    stage_z<L, kAllValid>(xt, ld, rows, blockIdx.x, valid, zt);
  wait_copies();
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
  float lse = 0.0f, lse_c = 0.0f;     // compensated over the tiles
  const int g = lane >> 2, t = lane & 3;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, buf ^= 1) {
    assemble_f<L>(tab, ly.mpf, zt + buf * (rows + 2) * L::T, fh, fr);
    __syncthreads();                       // F ready; this z tile is free
    if (tile + gridDim.x < ntiles)
      stage_z<L, kAllValid>(xt, ld, rows, tile + gridDim.x, valid,
                            zt + (buf ^ 1) * (rows + 2) * L::T);

    // per column 8j + 2t + h: the slab's (max, sum exp(S - max)), and
    // exp(S - the slab's max) kept in s
    const int r0 = 16 * w + g;
    float s[L::J][4];
    slab_logits<L>(tha, fh, fr, ly.ntf, w, lane, s);
#pragma unroll
    for (int j = 0; j < L::J; ++j) {
      if (r0 >= k) s[j][0] = s[j][1] = -INFINITY;
      if (r0 + 8 >= k) s[j][2] = s[j][3] = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // columns 8j + 2t + h
        float m = fmaxf(s[j][h], s[j][2 + h]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        const float mm = m == -INFINITY ? 0.0f : m;
        s[j][h] = exp_neg(s[j][h] - mm);
        s[j][2 + h] = exp_neg(s[j][2 + h] - mm);
        float e = s[j][h] + s[j][2 + h];
        e += __shfl_xor_sync(0xffffffffu, e, 4);
        e += __shfl_xor_sync(0xffffffffu, e, 8);
        e += __shfl_xor_sync(0xffffffffu, e, 16);
        if (g == 0) red[w * L::T + 8 * j + 2 * t + h] = make_float2(m, e);
      }
    }
    __syncthreads();                       // every slab's (max, sum) ready

    for (int c = lane; c < L::T; c += 32) {
      float mx = -INFINITY;
      for (int v = 0; v < nw; ++v) mx = fmaxf(mx, red[v * L::T + c].x);
      float den = 0.0f;
      for (int v = 0; v < nw; ++v) {
        const float2 q = red[v * L::T + c];
        den += q.y * exp_neg(q.x - mx);
      }
      den = fmaxf(den, 1e-37f);
      float f = exp_neg(red[w * L::T + c].x - mx);
      if constexpr (kDivide) f /= den;
      sc[w * L::T + c] = f;
      if (w == 0 && (kAllValid || tile * L::T + c < valid))
        kahan_add(lse, lse_c, mx + logf(den));
    }
    __syncwarp();

#pragma unroll
    for (int u = 0; u < L::J; ++u) {
      const float2 q = *reinterpret_cast<const float2*>(
          sc + w * L::T + 8 * u + 2 * t);
      const float p[4] = {s[u][0] * q.x, s[u][2] * q.x, s[u][1] * q.y,
                          s[u][3] * q.y};
      float ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split2(p[e], ph[e], pl[e]);
      stats_step<L, true>(acc, ph, pl, fh, fr, u, lane);
    }
    wait_copies();                         // the next z tile has landed
    __syncthreads();                       // F tiles free for the next tile
  }

  // this chain's partials: part (chains, gridDim.x, k m8 + 1)
  float* out =
      part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * (k * m8 + 1);
  store_slab<L>(acc, k, m8, 16 * w, 0, lane, out);
  if (w == 0) {
    for (int o = 16; o > 0; o >>= 1)
      lse += __shfl_xor_sync(0xffffffffu, lse, o);
    if (lane == 0) out[k * m8] = lse;
  }
}

// The variant B1 (and its probes) run at (k, m8) over `rows` input rows.
inline int estep_variant(int k, int m8, int rows) {
  return pick_variant(k, m8,
                      [&](int nt) { return estep_floats(nt, k, rows); });
}

// theta (chains, k, m8); part (chains, grid, k m8 + 1).
template <int V, bool kDivide, int kCount>
cudaError_t launch_estep(const float* xt, long long ld, int rows,
                         long long n, const int* nv, const float* theta,
                         int k, int m8, const FactorTable& tab, float* part,
                         int grid, cudaStream_t s, int chains = 1) {
  auto kernel = estep_tc<V, kDivide, kCount>;
  const size_t smem = sizeof(float) * estep_floats(V, k, rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid, 1, chains), 32 * slabs(k), smem, s>>>(
      xt, ld, rows, n, nv, theta, k, m8, tab, part);
  return cudaGetLastError();
}

// B1's launch at width v, compiled here for the widths in [kMin, kMax].
template <int kMin, int kMax>
cudaError_t estep_variants(int v, const float* xt, long long ld, int d,
                           int p, int kind, long long n, const float* theta,
                           int k, int m8, float* part, int grid, int chains,
                           cudaStream_t s) {
  const FactorTable tab = factor_table(kind, d, p, v > 0 ? 8 * v : 0);
  return dispatch_variant<kMin, kMax>(
      v, cudaErrorInvalidValue, [&](auto c) {
        return launch_estep<decltype(c)::value, true, kCountArg>(
            xt, ld, d + p, n, nullptr, theta, k, m8, tab, part, grid, s,
            chains);
      });
}

// B1's persistent grid at width v: minus a CUDA error code on failure.
template <int kMin, int kMax>
int estep_grid_variants(int v, int k, int m8, int rows, long long n) {
  return dispatch_variant<kMin, kMax>(
      v, -(int)cudaErrorInvalidValue, [&](auto c) {
        constexpr int V = decltype(c)::value;
        const long long ntiles = (n + estep_tile(V) - 1) / estep_tile(V);
        return persistent_grid(estep_tc<V, true, kCountArg>, 32 * slabs(k),
                               sizeof(float) * estep_floats(V, k, rows),
                               ntiles, 1);
      });
}

// -- the streamed layout (tc.cuh) ------------------------------------------

// Pass (a) over the segment of points [s0, s0 + seg): each tile's logits
// into sg (their fragment order, tc.cuh st_store_logits), each point's
// (max, scale) into md, scale = 1 / max(denominator, 1e-37) (1 without
// kDivide, probe S1), and the block's lse over the segment's valid points
// added, compensated, into its (sum, compensation) pair of lsep (chains,
// gridDim.x) float2. The block's warps fold their slabs' (max, sum exp)
// per column through `red`, then into the column's running pair `run`
// over K's chunks. valid: n, or min(n, *nv) for count mode kCountMemUsed
// (probe S2).
template <bool kDivide>
__global__ void __launch_bounds__(kStWarps * 32)
estep_st_logits(const float* __restrict__ xt, long long ld, int rows,
                long long n, const int* __restrict__ nv, int count,
                long long s0, const float4* __restrict__ thp, int k,
                const unsigned short* __restrict__ tab, const Streamed g,
                float4* __restrict__ sg, float2* __restrict__ md,
                float2* __restrict__ lsep) {
  constexpr int T = kStT, J = T / 8;
  using L = Tile<1, T>;
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                                    // (rows + 2) x T
  float* fbuf = zt + (rows + 2) * T;                   // 2 x 2 x 8 x FS
  float2* red = reinterpret_cast<float2*>(fbuf + 32 * L::FS);  // nw x T
  float2* run = red + g.nw * T;                        // T
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const long long valid =
      count == kCountMemUsed ? min(n, (long long)*nv) : n;
  thp += (size_t)blockIdx.z * g.nslab * g.ntf * 32;
  sg += (size_t)blockIdx.z * (g.seg / 8) * g.nslab * 32;
  md += (size_t)blockIdx.z * g.seg;
  const long long ntiles = (min(g.seg, n - s0) + T - 1) / T;

  float lse = 0.0f, lse_c = 0.0f;     // compensated over the tiles
  for (long long tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    stage_z<L, false>(xt, ld, rows, s0 / T + tl, valid, zt);
    wait_copies();
    __syncthreads();
    for (int c = 0; c < g.nchunk; ++c) {
      float s[kStSpw][J][4];
      st_chunk_logits(thp, g, c, tab, zt, fbuf, s);
      st_store_logits(s, g, c, k, tl, sg);
      // per column 8j + 2t + h: the warp's (max, sum exp(S - max))
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = -INFINITY;
#pragma unroll
          for (int i = 0; i < kStSpw; ++i)
            m = fmaxf(m, fmaxf(s[i][j][h], s[i][j][2 + h]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          const float mm = m == -INFINITY ? 0.0f : m;
          float e = 0.0f;
#pragma unroll
          for (int i = 0; i < kStSpw; ++i)
            e += exp_neg(s[i][j][h] - mm) + exp_neg(s[i][j][2 + h] - mm);
          e += __shfl_xor_sync(0xffffffffu, e, 4);
          e += __shfl_xor_sync(0xffffffffu, e, 8);
          e += __shfl_xor_sync(0xffffffffu, e, 16);
          if (gq == 0) red[w * T + 8 * j + 2 * t + h] = make_float2(m, e);
        }
      }
      __syncthreads();                     // every warp's pairs ready
      if (w == 0) {
        for (int col = lane; col < T; col += 32) {
          float2 q = c ? run[col] : make_float2(-INFINITY, 0.0f);
          for (int v = 0; v < g.nw; ++v)
            fold_max_sum(q.x, q.y, red[v * T + col].x, red[v * T + col].y);
          run[col] = q;
        }
      }
      __syncthreads();                     // red free for the next chunk
    }
    if (w == 0) {
      for (int col = lane; col < T; col += 32) {
        const float2 q = run[col];
        const float den = fmaxf(q.y, 1e-37f);
        md[tl * T + col] = make_float2(q.x, kDivide ? 1.0f / den : 1.0f);
        if (s0 + tl * T + col < valid) kahan_add(lse, lse_c, q.x + logf(den));
      }
    }
    __syncthreads();                       // z tile and run free
  }
  if (w == 0) {
    for (int o = 16; o > 0; o >>= 1)
      lse += __shfl_xor_sync(0xffffffffu, lse, o);
    if (lane == 0) {
      float2* q = lsep + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
      float2 v = *q;
      kahan_add(v.x, v.y, lse);
      *q = v;
    }
  }
}

// Pass (b) over the segment: acc += P F^T for the block's window (chunk
// kc of K's slabs, columns 8 NT mc ..; blockIdx.x = kc mw + mc) over its
// split of the segment's tiles (blockIdx.y of gridDim.y), P = exp(S -
// max) scale, the statistics' three passes of the precision rule
// (stats_step), added into part (chains, gridDim.y, k m8).
template <int NT>
__global__ void __launch_bounds__(kStWarps * 32)
estep_st_stats(const float* __restrict__ xt, long long ld, int rows,
               long long n, const int* __restrict__ nv, int count,
               long long s0, int k, int m8,
               const unsigned short* __restrict__ tab, const Streamed g,
               const float4* __restrict__ sg, const float2* __restrict__ md,
               float* __restrict__ part) {
  using L = Tile<NT, kStT>;
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                                    // (rows + 2) x T
  float* fh = zt + (rows + 2) * L::T;                  // 8 NT x FS
  float* fr = fh + 8 * NT * L::FS;                     // 8 NT x FS
  const int lane = threadIdx.x & 31, t = lane & 3;
  const long long valid =
      count == kCountMemUsed ? min(n, (long long)*nv) : n;
  sg += (size_t)blockIdx.z * (g.seg / 8) * g.nslab * 32;
  md += (size_t)blockIdx.z * g.seg;
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
    stage_z<L, false>(xt, ld, rows, s0 / L::T + tl, valid, zt);
    wait_copies();
    __syncthreads();
    st_form_rows(tab, col0, 8 * NT, zt, fh, fr);
    __syncthreads();                       // the window's F rows ready
#pragma unroll
    for (int u = 0; u < L::J; ++u) {
      // (max, scale) of points 8u + 2t and 8u + 2t + 1
      const float4 q = reinterpret_cast<const float4*>(md)[
          (tl * L::T + 8 * u + 2 * t) / 2];
#pragma unroll
      for (int i = 0; i < kStSpw; ++i) {
        const int sl = st_slab(g, kc, i);
        if (sl >= g.nslab) continue;
        const float4 sv = sg[((size_t)(tl * L::J + u) * g.nslab + sl) * 32 +
                             lane];
        const float p[4] = {exp_neg(sv.x - q.x) * q.y,
                            exp_neg(sv.y - q.x) * q.y,
                            exp_neg(sv.z - q.z) * q.w,
                            exp_neg(sv.w - q.z) * q.w};
        float ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(p[e], ph[e], pl[e]);
        stats_step<L, true>(acc[i], ph, pl, fh, fr, u, lane);
      }
    }
    __syncthreads();                       // z and F tiles free
  }
#pragma unroll
  for (int i = 0; i < kStSpw; ++i) {
    const int sl = st_slab(g, kc, i);
    if (sl < g.nslab) add_slab<L>(acc[i], k, m8, 16 * sl, col0, lane, part);
  }
}

}  // namespace

// The wide widths and the streamed layout (estep_wide.cu): B1's launch
// at width v, without the second pass, and its grid; B1 (and its probes)
// in the streamed layout and its scratch.
extern "C" int mimo_estep_wide(int v, const float* xt, long long ld, int d,
                               int p, int kind, long long n,
                               const float* theta, int k, int m8, float* part,
                               int grid, int chains, void* stream);
extern "C" int mimo_estep_grid_wide(int v, int k, int m8, int rows,
                                    long long n);
extern "C" int mimo_estep_streamed(const float* xt, long long ld, int d,
                                   int p, int kind, long long n,
                                   const int* nv, int count, int divide,
                                   const float* theta, int k, int m8,
                                   float* work, float* out, int chains,
                                   void* stream);
extern "C" long long mimo_estep_streamed_scratch(int k, int m8, int rows,
                                                 int chains);
