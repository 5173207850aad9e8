// The tensor-core tile machinery shared by B1 (estep.cuh) and B2
// (gibbs.cuh): warp-level mma.sync.m16n8k8 TF32 products with f32
// accumulation, the hi/lo operand splits of the precision rule (see the
// note at the top of estep.cuh), and the shared-memory tiles they read.
//
// K is cut into 16-row slabs, one warp's share of the logits. Two layouts:
//
//   plain     one warp per slab, NT = m8 / 8 rounded up to the next
//             compiled width (theta columns and F rows beyond m8 are
//             zero): theta (16 nslab x 8 NT) is staged whole in shared
//             memory; a block walks its points in tiles of T, the tile's
//             raw inputs z = [1; x; y; 0] (T columns) copied to shared
//             memory one tile ahead (cp.async), every feature row F_j =
//             z_a z_b (common.cuh FactorTable) assembled by the whole
//             block and stored as its tf32 part and the exact f32
//             remainder, and each warp multiplies its slab of theta
//             against them. The statistics (16 x 8 NT per warp) stay in
//             registers across all of the block's tiles. It takes K's
//             slabs up to a block's warps, m8 up to the widest compiled
//             width (256) and its tiles within shared memory.
//   streamed  every other shape, up to what device memory holds. Neither
//             theta nor F is staged whole, and the (K, m8) statistics do
//             not sit in one block. The points go in segments of `seg`
//             (a fixed count for each K: its logits, 16 MB a chain, stay
//             in L2) and each segment takes two launches:
//             (a) st_*_logits: a block takes tiles of kStT points; for
//                 each chunk of K (16 kStSpw nw rows, nw warps of kStSpw
//                 slabs each) it walks theta's 8-feature steps, theta's
//                 fragments read from device memory (1.1 MB at K=256,
//                 d=32: L2) in A-fragment order (st_prep) and F's 8 rows
//                 of the step formed from the z tile through the table in
//                 device memory (st_form_step, two buffers), and writes
//                 the tile's logits S (K x kStT) to a scratch buffer in
//                 the mma's fragment order. The logits are formed once a
//                 point. B1 folds each point's (max, sum exp) over the
//                 chunks and writes (max, 1 / denominator) and its lse
//                 partials; B2 draws the labels from S.
//             (b) st_*_stats: output-stationary, a block owns a window of
//                 the statistics (one chunk's rows x 8 NT columns, NT in
//                 1, 2, 4, 8) and a split of the segment's tiles, forms
//                 the window's F rows from z, reads P (B1: exp(S - max) /
//                 denominator from the scratch) or the one-hot labels
//                 (B2), and adds its window into its split's partials in
//                 device memory. Every element of the partials belongs to
//                 one block of a launch, and the segments come in order,
//                 so the sums are in a fixed order without atomics.
//             A fixed-order second pass (common.cuh launch_reduce) sums
//             the splits. Every grid depends only on (K, m8, rows) and
//             the card, never on n or the chains.
// Both layouts take a chain axis: blockIdx.z picks one of C thetas
// (C, K, m8) over the same points (restarts of one fit, the counterpart of
// jax.vmap over the Pallas kernels' grid), and a block reads only its
// chain's theta and writes its chain's partials. The x tiles are read
// again for every chain, as the TPU's batching rule reads them. Every
// chain has the one-chain grids (the C x grid blocks run in about C
// waves), so each chain's blocks do exactly the work of a one-chain
// launch and its result is bitwise that launch's.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxWidth = 32;                 // plain layout: m8 <= 256

// Threads a block may have at width NT: 16 warps (K <= 256 in the plain
// layout) up to m8 = 64; above it 8 (K <= 128), so a thread may hold the
// wider slab in up to 255 registers.
__host__ __device__ constexpr int max_threads(int nt) {
  return nt <= 8 ? 512 : 256;
}

__host__ __device__ constexpr int slabs(int k) { return (k + 15) / 16; }

// The compiled widths NT of the plain layout (m8 <= 8 NT); 0 when m8 is
// wider than all.
inline int width_bucket(int m8) {
  constexpr int kWidths[] = {1, 2, 3, 4, 6, 8, 12, 16, 21, 24, kMaxWidth};
  for (int nt : kWidths)
    if (8 * nt >= m8) return nt;
  return 0;
}

// The widest of the narrow widths: each kernel compiles its narrow widths
// in one source and its wide widths and the streamed layout in another,
// which nvcc builds in parallel.
constexpr int kMaxNarrow = 8;

// A kernel's variant is a plain layout's width 1..kMaxWidth or kStreamed.
constexpr int kStreamed = -1;

// How a plain-layout block at width nt and K is laid out: one warp per
// 16-row slab, theta's nt 8-feature steps, 8 nt rows of F.
struct Layout {
  int nslab;   // 16-row slabs of K, one a warp
  int ntf;     // theta's 8-feature steps, the logits' contraction
  int mpf;     // F tile rows, zero past the map
};

__host__ __device__ constexpr Layout layout(int nt, int k) {
  return Layout{slabs(k), nt, 8 * nt};
}

// fn(std::integral_constant<int, V>) for the compiled width v in
// [kMin, kMax]; `bad` for any other.
template <int kMin, int kMax, class R, class Fn>
R dispatch_variant(int v, R bad, Fn&& fn) {
  switch (v) {
#define MIMO_WIDTH(N)                                  \
  case N:                                              \
    if constexpr (N >= kMin && N <= kMax)              \
      return fn(std::integral_constant<int, N>{});     \
    else                                               \
      return bad;
    MIMO_WIDTH(1) MIMO_WIDTH(2) MIMO_WIDTH(3) MIMO_WIDTH(4) MIMO_WIDTH(6)
    MIMO_WIDTH(8) MIMO_WIDTH(12) MIMO_WIDTH(16) MIMO_WIDTH(21)
    MIMO_WIDTH(24) MIMO_WIDTH(32)
#undef MIMO_WIDTH
    default:
      return bad;
  }
}

template <int NT_, int T_>
struct Tile {
  static constexpr int NT = NT_;   // 8-feature steps of a statistics slab
  static constexpr int T = T_;     // points per tile
  static constexpr int MP = 8 * NT;
  static constexpr int FS = T + 8; // F / S tile row stride: 8 mod 32 banks
  static constexpr int J = T / 8;  // 8-point column groups
};

// Floats of shared memory both kernels stage in the plain layout: theta
// (16 nslab x 8 ntf, in A-fragment order), two z tiles ((rows + 2) x T:
// the next tile's inputs arrive while this one computes) and the F tiles,
// tf32 part and remainder (mpf x (T + 8) each; the row stride of 8 mod 32
// banks keeps both products' fragment loads free of bank conflicts).
inline size_t tile_floats(const Layout& l, int t, int rows) {
  return (size_t)16 * l.nslab * 8 * l.ntf + 2 * (size_t)(rows + 2) * t +
         2 * (size_t)l.mpf * (t + 8);
}

// Bytes of shared memory a block may have on the current device; 0 if
// the device cannot be asked.
inline size_t smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// The variant a launch at (k, m8) runs, `floats(nt)` the floats the
// plain layout stages at width nt: the plain layout where K's slabs fit
// one block's warps, m8 a compiled width and its tiles shared memory;
// else the streamed layout, which takes every shape.
template <class Floats>
int pick_variant(int k, int m8, Floats&& floats) {
  const int nt = width_bucket(m8);
  if (nt && 32 * slabs(k) <= max_threads(nt) &&
      sizeof(float) * floats(nt) <= smem_limit())
    return nt;
  return kStreamed;
}

// Blocks along x of a persistent grid: SMs x resident blocks of this
// kernel at this block size and shared memory, shared among the `windows`
// blocks along y, at most one per tile and at least one. Returns minus
// the CUDA error code on failure.
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem,
                    long long ntiles, int windows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long resident = (long long)sms * std::max(per_sm, 1) / windows;
  return (int)std::max(1LL, std::min(resident, ntiles));
}

// cvt.rna.tf32.f32: round to the nearest tf32 (10 mantissa bits), ties
// away from zero; the result is an f32 with its low 13 bits clear.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo to 2^-22 |x|.
__device__ __forceinline__ void split2(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

// The remainder r = x - to_tf32(x) of an f32 x (at most 13 significant
// bits) as mid + lo exactly: mid its tf32 rounding, lo the last bits,
// itself a tf32.
__device__ __forceinline__ void split_rest(float r, float& mid, float& lo) {
  mid = to_tf32(r);
  lo = r - mid;
}

// x = hi + mid + lo exactly.
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = to_tf32(x);
  split_rest(x - hi, mid, lo);
}

// exp(x) for x <= 0 by the MUFU ex2 (2 ulp near 0; flushes below 2^-126).
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// c += a b over one m16n8k8 tile: a (16 x 8, rows g and g+8, columns t
// and t+4), b (8 x 8, rows t and t+4, column g), c (16 x 8, rows g and
// g+8, columns 2t and 2t+1), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4],
                                         const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// theta (k, m8) row-major -> (nslab slabs, ntf steps, 32 lanes) float4 of
// the A fragment {(g, t), (g+8, t), (g, t+4), (g+8, t+4)} of each 16 x 8
// block, zero beyond k rows and m8 columns.
__device__ __forceinline__ void stage_theta(const float* __restrict__ theta,
                                            int k, int m8, const Layout& ly,
                                            float* tha) {
  const int n = 32 * ly.nslab * ly.ntf;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i & 31, s = (i >> 5) % ly.ntf, w = (i >> 5) / ly.ntf;
    const int r0 = 16 * w + (lane >> 2), c0 = 8 * s + (lane & 3);
    auto at = [&](int r, int c) {
      return r < k && c < m8 ? theta[(size_t)r * m8 + c] : 0.0f;
    };
    reinterpret_cast<float4*>(tha)[i] =
        make_float4(at(r0, c0), at(r0 + 8, c0), at(r0, c0 + 4),
                    at(r0 + 8, c0 + 4));
  }
}

// Starts copying one tile's z rows, [1; x; y; 0] for its valid points and
// all zero for the others (which then contribute nothing), to zb: the x
// and y entries by cp.async, which the caller completes with
// wait_copies() before a barrier.
template <class L, bool kAllValid>
__device__ void stage_z(const float* __restrict__ xt, long long ld,
                        int rows, long long tile, long long valid,
                        float* zb) {
  for (int i = threadIdx.x; i < (rows + 2) * L::T; i += blockDim.x) {
    const int r = i / L::T, c = i - r * L::T;
    const long long p = tile * L::T + c;
    const bool ok = kAllValid || p < valid;
    if (r >= 1 && r <= rows && ok) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(zb + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                   "l"(xt + (r - 1) * ld + p));
    } else {
      zb[i] = r == 0 && ok ? 1.0f : 0.0f;
    }
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// F_j = z_a z_b for every row j < mpf and column of the tile, stored as
// its tf32 part (fh) and the exact remainder (fr). A warp's 32 entries
// share one row j (T >= 32), so its table entry is one uniform load.
template <class L>
__device__ __forceinline__ void assemble_f(const FactorTable& tab, int mpf,
                                           const float* zb, float* fh,
                                           float* fr) {
  for (int i = threadIdx.x; i < mpf * L::T; i += blockDim.x) {
    const int j = i / L::T, c = i - j * L::T;
    const unsigned ab = tab.ab[j];
    const float f = zb[(ab & 0xff) * L::T + c] * zb[(ab >> 8) * L::T + c];
    const float hi = to_tf32(f);
    fh[j * L::FS + c] = hi;
    fr[j * L::FS + c] = f - hi;
  }
}

// Slab sl of S = theta F over ntf 8-feature steps: s[j] is the C fragment
// of rows 16 sl + {g, g+8} and tile columns 8 j + {2t, 2t+1}. Six passes per
// 8-feature step, theta and F each split exactly in three, every product
// term down to 2^-22 relative: lo F_hi + hi F_lo + mid F_mid + mid F_hi
// + hi F_mid + hi F_hi (the dropped ones are below 2^-33), chained in the
// tensor core and added to s in f32.
template <class L>
__device__ __forceinline__ void slab_logits(const float* tha, const float* fh,
                                            const float* fr, int ntf, int sl,
                                            int lane, float (&s)[L::J][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < L::J; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
  for (int st = 0; st < ntf; ++st) {
    const float4 th =
        reinterpret_cast<const float4*>(tha)[(sl * ntf + st) * 32 + lane];
    float ah[4], am[4], al[4];
    split3(th.x, ah[0], am[0], al[0]);
    split3(th.y, ah[1], am[1], al[1]);
    split3(th.z, ah[2], am[2], al[2]);
    split3(th.w, ah[3], am[3], al[3]);
    const float* rh = fh + (8 * st + t) * L::FS + g;
    const float* rr = fr + (8 * st + t) * L::FS + g;
#pragma unroll
    for (int j = 0; j < L::J; ++j) {
      const float bh[2] = {rh[8 * j], rh[8 * j + 4 * L::FS]};
      float bm[2], bl[2];
      split_rest(rr[8 * j], bm[0], bl[0]);
      split_rest(rr[8 * j + 4 * L::FS], bm[1], bl[1]);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(c, al, bh);
      mma_tf32(c, ah, bl);
      mma_tf32(c, am, bm);
      mma_tf32(c, am, bh);
      mma_tf32(c, ah, bm);
      mma_tf32(c, ah, bh);
      s[j][0] += c[0];
      s[j][1] += c[1];
      s[j][2] += c[2];
      s[j][3] += c[3];
    }
  }
}

// acc += A F^T over one 8-point step u of the tile, for every 8-feature
// block of the slab. The contraction runs over points, in the order
// k = t <-> point 8u + 2t, k = t + 4 <-> point 8u + 2t + 1: so the C
// fragment of S's column group u is, unchanged, the A fragment
// {c0, c2, c1, c3} here, and the B fragment is the F pair (8 jn + g,
// 8u + 2t .. 2t+1), one 8-byte load per tile and part. F enters as
// F_hi + F_lo (to 2^-22, F_lo the remainder's tf32 rounding); passes:
// (a_lo F_hi when kSplitA) + a_hi F_lo + a_hi F_hi, chained in the
// tensor core and added to acc in f32.
template <class L, bool kSplitA>
__device__ __forceinline__ void stats_step(float (&acc)[L::NT][4],
                                           const float (&ah)[4],
                                           const float (&al)[4],
                                           const float* fh, const float* fr,
                                           int u, int lane) {
  const int off = (lane >> 2) * L::FS + 8 * u + 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < L::NT; ++jn) {
    const float2 h =
        *reinterpret_cast<const float2*>(fh + off + 8 * jn * L::FS);
    const float2 r =
        *reinterpret_cast<const float2*>(fr + off + 8 * jn * L::FS);
    const float bh[2] = {h.x, h.y}, bl[2] = {to_tf32(r.x), to_tf32(r.y)};
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kSplitA) mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, ah, bh);
    acc[jn][0] += c[0];
    acc[jn][1] += c[1];
    acc[jn][2] += c[2];
    acc[jn][3] += c[3];
  }
}

// The warp's statistics slab, rows row0.. and columns col0.. of
// (k, m8), into out (k, m8) row-major.
template <class L>
__device__ void store_slab(const float (&acc)[L::NT][4], int k, int m8,
                           int row0, int col0, int lane, float* out) {
  const int r0 = row0 + (lane >> 2), c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < L::NT; ++jn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * jn + c0 + h;
      if (c >= m8) continue;
      if (r0 < k) out[(size_t)r0 * m8 + c] = acc[jn][h];
      if (r0 + 8 < k) out[(size_t)(r0 + 8) * m8 + c] = acc[jn][2 + h];
    }
  }
}

// -- the streamed layout (the note at the top of this file) ----------------

constexpr int kStT = 64;         // points a tile
constexpr int kStSpw = 2;        // 16-row slabs a warp
constexpr int kStWarps = 8;      // warps a block, at most
// logits a chain holds for a segment: 16 MB, so that pass (b) reads what
// pass (a) wrote from L2
constexpr long long kStSegFloats = 1LL << 22;

__host__ __device__ constexpr int pow2_at_least(int v) {
  return v <= 1 ? 1 : 2 * pow2_at_least((v + 1) / 2);
}

// The streamed layout's geometry at (k, m8): the same for every launch of
// a shape on a card (ga and splits from the kernels' occupancy).
struct Streamed {
  int nslab;       // 16-row slabs of K
  int ntf;         // 8-feature steps of theta and F
  int nw;          // warps a block: a power of two, at most kStWarps
  int chunk;       // slabs a chunk of K: nw kStSpw
  int nchunk;      // chunks of K
  int nt;          // 8-feature steps of a statistics window: 1, 2, 4 or 8
  int mw;          // windows across m8
  long long seg;   // points a segment, a multiple of kStT
  int ga;          // blocks of pass (a) along x
  int splits;      // splits of the segment's tiles in pass (b)
};

inline Streamed streamed_shape(int k, int m8) {
  Streamed g{};
  g.nslab = slabs(k);
  g.ntf = (m8 + 7) / 8;
  g.nw = std::min(kStWarps, pow2_at_least((g.nslab + kStSpw - 1) / kStSpw));
  g.chunk = g.nw * kStSpw;
  g.nchunk = (g.nslab + g.chunk - 1) / g.chunk;
  g.nt = std::min(8, pow2_at_least(g.ntf));
  g.mw = (g.ntf + g.nt - 1) / g.nt;
  g.seg = std::max<long long>(
      kStT, kStSegFloats / (16LL * g.nslab) / kStT * kStT);
  return g;
}

// Rows of the streamed layout's factor table: every window's 8 NT rows.
inline int st_table_rows(const Streamed& g) { return g.mw * 8 * g.nt; }

// Shared memory floats of pass (a): the z tile ((rows + 2) x kStT), two
// buffers of one step's F rows (tf32 part and remainder, 8 x (kStT + 8)
// each) and B1's per-warp and running (max, sum) pairs (nw + 1) x kStT.
inline size_t st_logits_floats(const Streamed& g, int rows) {
  return (size_t)(rows + 2) * kStT + 4 * 8 * (kStT + 8) +
         2 * (size_t)(g.nw + 1) * kStT;
}

// Shared memory floats of pass (b): the z tile, the window's F rows (tf32
// part and remainder, 8 nt x (kStT + 8) each) and B2's tile of labels.
inline size_t st_stats_floats(const Streamed& g, int rows) {
  return (size_t)(rows + 2) * kStT + 2 * (size_t)8 * g.nt * (kStT + 8) +
         kStT;
}

// The streamed layout's scratch in device memory, offsets in floats (each
// 16-byte aligned): the factor table (unsigned short), theta in
// A-fragment order (chains, nslab, ntf, 32) float4, the logits of a
// segment (chains, seg / 8, nslab, 32) float4, B1's per-point (max,
// scale) (chains, seg) float2 and per-block lse (sum, compensation)
// (chains, ga) float2, and the splits' partial statistics (chains,
// splits, k m8).
struct StScratch {
  size_t tab, thp, sg, md, lsep, part, total;
};

inline StScratch st_scratch(const Streamed& g, int k, int m8, int chains,
                            bool estep) {
  StScratch s{};
  size_t o = 0;
  auto take = [&](size_t floats) {
    const size_t at = o;
    o += (floats + 3) & ~(size_t)3;
    return at;
  };
  s.tab = take((st_table_rows(g) + 1) / 2);
  s.thp = take((size_t)chains * g.nslab * g.ntf * 128);
  s.sg = take((size_t)chains * g.seg * g.nslab * 16);
  s.md = take(estep ? (size_t)chains * g.seg * 2 : 0);
  s.lsep = take(estep ? (size_t)chains * g.ga * 2 : 0);
  s.part = take((size_t)chains * g.splits * k * m8);
  s.total = o;
  return s;
}

// theta (chains, k, m8) row-major -> thp (chains, nslab, ntf, 32) float4,
// the A fragment {(g, t), (g+8, t), (g, t+4), (g+8, t+4)} of each 16 x 8
// block, zero beyond k rows and m8 columns (blockIdx.y the chain); and,
// in one thread, the factor table's `tab_rows` rows.
__global__ void st_prep(const float* __restrict__ theta, int k, int m8,
                        int nslab, int ntf, float4* __restrict__ thp,
                        int kind, int d, int np, int tab_rows,
                        unsigned short* __restrict__ tab) {
  const size_t per = (size_t)nslab * ntf * 32;
  const float* th = theta + (size_t)blockIdx.y * k * m8;
  float4* out = thp + blockIdx.y * per;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (size_t)gridDim.x * blockDim.x) {
    const int lane = i & 31, st = (i >> 5) % ntf, sl = (i >> 5) / ntf;
    const int r0 = 16 * sl + (lane >> 2), c0 = 8 * st + (lane & 3);
    auto at = [&](int r, int c) {
      return r < k && c < m8 ? th[(size_t)r * m8 + c] : 0.0f;
    };
    out[i] = make_float4(at(r0, c0), at(r0 + 8, c0), at(r0, c0 + 4),
                         at(r0 + 8, c0 + 4));
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    fill_factor_table(kind, d, np, tab_rows, tab);
}

inline cudaError_t launch_st_prep(const float* theta, int k, int m8,
                                  const Streamed& g, float4* thp, int kind,
                                  int d, int np, unsigned short* tab,
                                  int chains, cudaStream_t s) {
  const size_t per = (size_t)g.nslab * g.ntf * 32;
  const int blocks = (int)std::min<size_t>(1024, (per + 255) / 256);
  st_prep<<<dim3(blocks, chains), 256, 0, s>>>(
      theta, k, m8, g.nslab, g.ntf, thp, kind, d, np, st_table_rows(g), tab);
  return cudaGetLastError();
}

// rows [r0, r0 + nr) of F for the tile's kStT points from the z tile zb
// through the table, as the tf32 part (fh) and the exact remainder (fr),
// row stride kStT + 8. A warp's 32 entries share one row (kStT >= 32), so
// its table entry is one uniform load.
__device__ __forceinline__ void st_form_rows(
    const unsigned short* __restrict__ tab, int r0, int nr, const float* zb,
    float* fh, float* fr) {
  constexpr int T = kStT, FS = kStT + 8;
  for (int i = threadIdx.x; i < nr * T; i += blockDim.x) {
    const int r = i / T, c = i - r * T;
    const unsigned ab = __ldg(tab + r0 + r);
    const float f = zb[(ab & 0xff) * T + c] * zb[(ab >> 8) * T + c];
    const float hi = to_tf32(f);
    fh[r * FS + c] = hi;
    fr[r * FS + c] = f - hi;
  }
}

// The slab of the warp's i-th share of chunk c.
__device__ __forceinline__ int st_slab(const Streamed& g, int c, int i) {
  return c * g.chunk + i * g.nw + (threadIdx.x >> 5);
}

// Pass (a): S = theta F over chunk c of K for the tile whose z is zb,
// into the warp's registers: s[i][j] is the C fragment of rows 16 sl_i +
// {g, g+8} (sl_i = st_slab(g, c, i); all zero where sl_i >= nslab) and
// tile columns 8 j + {2t, 2t+1}. The block walks theta's 8-feature steps;
// F's 8 rows of step st + 1 are formed into one buffer of fbuf (2 x
// (tf32 part, remainder) x 8 x (kStT + 8)) while the warps read step st
// from the other, one barrier a step. Theta's fragments come from device
// memory (thp, A-fragment order), the next step's loaded before this
// step's products. The precision rule of slab_logits: six passes, theta
// and F each split exactly in three.
__device__ __forceinline__ void st_chunk_logits(
    const float4* __restrict__ thp, const Streamed& g, int c,
    const unsigned short* __restrict__ tab, const float* zb, float* fbuf,
    float (&s)[kStSpw][kStT / 8][4]) {
  constexpr int J = kStT / 8, FS = kStT + 8;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  int sl[kStSpw];
  bool on[kStSpw];
#pragma unroll
  for (int i = 0; i < kStSpw; ++i) {
    sl[i] = st_slab(g, c, i);
    on[i] = sl[i] < g.nslab;
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] =
        s[i][j][3] = 0.f;
  }
  auto theta_at = [&](int i, int st) {
    return on[i] ? thp[((size_t)sl[i] * g.ntf + st) * 32 + lane]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 th[kStSpw];
#pragma unroll
  for (int i = 0; i < kStSpw; ++i) th[i] = theta_at(i, 0);
  st_form_rows(tab, 0, 8, zb, fbuf, fbuf + 8 * FS);
  __syncthreads();
#pragma unroll 1
  for (int st = 0; st < g.ntf; ++st) {
    const float* fh = fbuf + (st & 1) * 16 * FS;
    const float* fr = fh + 8 * FS;
    if (st + 1 < g.ntf) {
      float* nh = fbuf + ((st + 1) & 1) * 16 * FS;
      st_form_rows(tab, 8 * (st + 1), 8, zb, nh, nh + 8 * FS);
    }
    float ah[kStSpw][4], am[kStSpw][4], al[kStSpw][4];
#pragma unroll
    for (int i = 0; i < kStSpw; ++i) {
      split3(th[i].x, ah[i][0], am[i][0], al[i][0]);
      split3(th[i].y, ah[i][1], am[i][1], al[i][1]);
      split3(th[i].z, ah[i][2], am[i][2], al[i][2]);
      split3(th[i].w, ah[i][3], am[i][3], al[i][3]);
      if (st + 1 < g.ntf) th[i] = theta_at(i, st + 1);
    }
    const float* rh = fh + t * FS + gq;
    const float* rr = fr + t * FS + gq;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float bh[2] = {rh[8 * j], rh[8 * j + 4 * FS]};
      float bm[2], bl[2];
      split_rest(rr[8 * j], bm[0], bl[0]);
      split_rest(rr[8 * j + 4 * FS], bm[1], bl[1]);
#pragma unroll
      for (int i = 0; i < kStSpw; ++i) {
        if (!on[i]) continue;
        float cc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(cc, al[i], bh);
        mma_tf32(cc, ah[i], bl);
        mma_tf32(cc, am[i], bm);
        mma_tf32(cc, am[i], bh);
        mma_tf32(cc, ah[i], bm);
        mma_tf32(cc, ah[i], bh);
        s[i][j][0] += cc[0];
        s[i][j][1] += cc[1];
        s[i][j][2] += cc[2];
        s[i][j][3] += cc[3];
      }
    }
    __syncthreads();   // step st + 1's rows ready; step st's buffer free
  }
}

// Pass (a): rows past k to -inf, then the warp's slabs of chunk c for
// tile tl into the segment's logits sgc (seg / 8, nslab, 32) float4, each
// lane's C fragment as {c0, c2, c1, c3}: pass (b) loads it as the A
// fragment of P F^T with B1's permuted contraction index (stats_step).
__device__ __forceinline__ void st_store_logits(
    float (&s)[kStSpw][kStT / 8][4], const Streamed& g, int c, int k,
    long long tl, float4* __restrict__ sgc) {
  constexpr int J = kStT / 8;
  const int lane = threadIdx.x & 31, gq = lane >> 2;
#pragma unroll
  for (int i = 0; i < kStSpw; ++i) {
    const int sl = st_slab(g, c, i), r0 = 16 * sl + gq;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (r0 >= k) s[i][j][0] = s[i][j][1] = -INFINITY;
      if (r0 + 8 >= k) s[i][j][2] = s[i][j][3] = -INFINITY;
      if (sl < g.nslab)
        sgc[((size_t)(tl * J + j) * g.nslab + sl) * 32 + lane] =
            make_float4(s[i][j][0], s[i][j][2], s[i][j][1], s[i][j][3]);
    }
  }
}

// The logit of component kk at tile column col from the tile's logits
// sgt (J, nslab, 32) float4 in the layout st_store_logits writes.
__device__ __forceinline__ float st_logit(const float* sgt, int nslab,
                                          int kk, int col) {
  const int j = col >> 3, cc = col & 7, sl = kk >> 4, r = kk & 15;
  const int lane = ((r & 7) << 2) | (cc >> 1);
  const int slot = (r >> 3) | ((cc & 1) << 1);
  return sgt[(((size_t)j * nslab + sl) * 32 + lane) * 4 + slot];
}

// acc added into out (k, m8) row-major at rows row0.., columns col0..:
// the warp's slab of a window into its split's partials (each element
// belongs to one thread of the launch).
template <class L>
__device__ void add_slab(const float (&acc)[L::NT][4], int k, int m8,
                         int row0, int col0, int lane, float* out) {
  const int r0 = row0 + (lane >> 2), c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < L::NT; ++jn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * jn + c0 + h;
      if (c >= m8) continue;
      if (r0 < k) out[(size_t)r0 * m8 + c] += acc[jn][h];
      if (r0 + 8 < k) out[(size_t)(r0 + 8) * m8 + c] += acc[jn][2 + h];
    }
  }
}

// fn(std::integral_constant<int, NT>) for a window width nt in 1, 2, 4, 8.
template <class R, class Fn>
R dispatch_nt(int nt, R bad, Fn&& fn) {
  switch (nt) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return bad;
  }
}

}  // namespace
