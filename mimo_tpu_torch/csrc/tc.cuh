// The tensor-core tile machinery shared by B1 (estep.cuh) and B2
// (gibbs.cuh): warp-level mma.sync.m16n8k8 TF32 products with f32
// accumulation, the hi/lo operand splits of the precision rule (see the
// note at the top of estep.cuh), and the shared-memory tiles they read.
//
// K is cut into 16-row slabs, one warp's share of the logits. A block
// walks its points in tiles of T: the tile's raw inputs z = [1; x; y; 0]
// (T columns) are copied to shared memory one tile ahead (cp.async),
// every feature row F_j = z_a z_b (common.cuh FactorTable) is assembled
// by the whole block and stored as its tf32 part and the exact f32
// remainder, and each warp multiplies its slab of theta against them. The
// statistics (16 x 8 NT per warp) stay in registers across all of the
// block's tiles, so NT is a compile-time width. Two layouts (Layout):
//   plain    one warp per slab, NT = m8 / 8 rounded up to the next
//            compiled width (theta columns and F rows beyond m8 are zero):
//            each block accumulates all of (K, m8);
//   chunked  for a K or m8 past the plain layout (more slabs than a block
//            has warps, a wider m8 than the widest width, or more shared
//            memory than a block can have): the block's nw warps walk K's
//            slabs in chunks of nw for the logits, and each block keeps the
//            statistics of one window, one chunk's rows by 8 NT columns;
//            blockIdx.y picks the window. Every block forms all of the
//            logits, so the chunked layout does (chunks x windows) times
//            the logits' work of the plain one; it exists so that every
//            shape up to shared memory's limit launches.
// Both layouts take a chain axis: blockIdx.z picks one of C thetas
// (C, K, m8) over the same points (restarts of one fit, the counterpart of
// jax.vmap over the Pallas kernels' grid), and the block stages only its
// chain's theta and writes its chain's partials. The x tiles are read
// again for every chain, as the TPU's batching rule reads them. Every
// chain has the one-chain persistent grid along x (the C x grid blocks
// run in about C waves), so each chain's blocks do exactly the work of a
// one-chain launch and its result is bitwise that launch's.
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
// in one source and its wide widths and the chunked layout in another,
// which nvcc builds in parallel.
constexpr int kMaxNarrow = 8;

// A kernel's variant is a plain layout's width 1..kMaxWidth or kChunked,
// the chunked layout, whose windows are kChunkNT 8-feature steps wide and
// whose tiles hold kChunkT points.
constexpr int kChunked = -1, kChunkNT = 4, kChunkT = 32;

__host__ __device__ constexpr int variant_nt(int v) {
  return v == kChunked ? kChunkNT : v;
}

// How a block at (k, m8) is laid out (the note at the top of this file).
struct Layout {
  int nslab;   // 16-row slabs of K
  int nw;      // warps a block
  int ntf;     // theta's 8-feature steps, the logits' contraction
  int mpf;     // F tile rows: 8 NT windows' worth, zero past the map
  int nchunk;  // chunks of nw slabs the logits walk
  int nz;      // windows of 8 NT columns across m8
};

__host__ __device__ constexpr Layout layout(int v, int k, int m8) {
  const int nt = variant_nt(v), nslab = slabs(k);
  if (v != kChunked) return Layout{nslab, nslab, nt, 8 * nt, 1, 1};
  const int nw = nslab < max_threads(nt) / 32 ? nslab : max_threads(nt) / 32;
  const int ntf = (m8 + 7) / 8, nz = (ntf + nt - 1) / nt;
  return Layout{nslab, nw, ntf, 8 * nt * nz, (nslab + nw - 1) / nw, nz};
}

// fn(std::integral_constant<int, V>) for the compiled variant v: a width
// in [kMin, kMax], or kChunked where kChunk; `bad` for any other.
template <int kMin, int kMax, bool kChunk, class R, class Fn>
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
    case kChunked:
      if constexpr (kChunk)
        return fn(std::integral_constant<int, kChunked>{});
      else
        return bad;
    default:
      return bad;
  }
}

// The variants a source compiles beyond the narrow widths.
inline bool is_wide(int v) { return v == kChunked || v > kMaxNarrow; }

template <int NT_, int T_>
struct Tile {
  static constexpr int NT = NT_;   // 8-feature steps of a statistics slab
  static constexpr int T = T_;     // points per tile
  static constexpr int MP = 8 * NT;
  static constexpr int FS = T + 8; // F / S tile row stride: 8 mod 32 banks
  static constexpr int J = T / 8;  // 8-point column groups
};

// Floats of shared memory both kernels stage: theta (16 nslab x 8 ntf, in
// A-fragment order), two z tiles ((rows + 2) x T: the next tile's inputs
// arrive while this one computes) and the F tiles, tf32 part and
// remainder (mpf x (T + 8) each; the row stride of 8 mod 32 banks keeps
// both products' fragment loads free of bank conflicts).
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

// The variant a launch at (k, m8) runs, `floats(v)` the floats variant v
// stages: the plain layout where K's slabs fit one block's warps, m8 a
// compiled width and its tiles shared memory; else the chunked layout
// where its tiles fit (and its F rows the FactorTable); else 0, a shape
// past shared memory's limit.
template <class Floats>
int pick_variant(int k, int m8, Floats&& floats) {
  const size_t limit = smem_limit();
  if (k < 1 || m8 < 1) return 0;
  const int nt = width_bucket(m8);
  if (nt && 32 * slabs(k) <= max_threads(nt) &&
      sizeof(float) * floats(nt) <= limit)
    return nt;
  if (layout(kChunked, k, m8).mpf <= kMaxTableRows &&
      sizeof(float) * floats(kChunked) <= limit)
    return kChunked;
  return 0;
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

}  // namespace
