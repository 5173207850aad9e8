// Shared device and host code of the serving kernels B3 (predict.cu), B4
// (diag_predict.cu), B5 and B6 (ilr_predict.cuh): K-chunked staging of
// the coefficients through shared memory, the quadratic forms over the
// feature maps evaluated from x itself, and the occupancy grid.
//
// Staging. A kernel's coefficients are a few strips, each nb blocks of K
// components of w floats (B5's th is one strip of three blocks: the basis,
// c and mean rows). A chunk holds kc components of every block of every
// strip. When all K fit in kWholeBytes the block stages them once; else
// two chunk buffers alternate: while the block works on one chunk, the
// next is in flight (cp.async), and a tile of points walks every chunk
// with its online softmax state carried across. A component too large for
// a buffer of kMaxBufBytes is read in place from device memory (`View`
// points there), so no shape whose coefficients fit in device memory is
// refused.
//
// Quadratic forms. Each row is a quadratic in x (and y): th . F with F =
// [1; x; x (x) x], [1; x; x^2] or B6's joint map, summed over the map's
// real width (not m8) as one f32 FMA chain in column order over F's
// entries, each product of two coordinates rounded once: the arithmetic
// of the plain versions' features (family_estep.py) and of the
// expanded-form dot the TPU kernels run, so kernel and plain version
// round the cancelling quadratic alike. At compiled widths (d <= 8; B6
// also p = 2, 3) d is a template parameter and each point's map lives in
// registers as its distinct entries (PointMap, JointMap), the row read as
// float4 broadcasts from shared memory and used for every point the
// thread owns; past them d is a runtime value and F's entries are formed
// term by term from x where it lies.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxStrips = 3;
constexpr size_t kWholeBytes = 32 * 1024;   // stage all K once up to this
constexpr size_t kBufBytes = 16 * 1024;     // else two chunk buffers of this
constexpr size_t kMaxBufBytes = 96 * 1024;  // (grown for one component)

struct Strip {
  const float* src;   // component kk of block r at src + (r K + kk) w
  int w, nb;
};

// Where the kernel reads a chunk's component i of strip s, block r:
// p[s] + r * bs[s] + i * w.
struct View {
  const float* p[kMaxStrips];
  long long bs[kMaxStrips];
};

struct Plan {
  int kc;          // components per chunk
  int nch;         // chunks
  int bufs;        // 1 (all K staged once), 2 (alternating), 0 (in place)
  int off[kMaxStrips + 1];   // strip offsets in a buffer, floats
};

inline int round4(long long v) { return (int)((v + 3) / 4 * 4); }

// Floats of one buffer holding kc components of every strip.
inline long long chunk_floats(const Strip* s, int ns, long long kc) {
  long long f = 0;
  for (int i = 0; i < ns; ++i) f += round4(kc * s[i].w * s[i].nb);
  return f;
}

inline Plan make_plan(const Strip* s, int ns, int k) {
  Plan pl{};
  const long long per = chunk_floats(s, ns, 1);
  long long kc;
  if (4 * chunk_floats(s, ns, k) <= (long long)kWholeBytes) {
    kc = k;
    pl.bufs = 1;
  } else if (4 * per <= (long long)kMaxBufBytes) {
    kc = per * 4 > (long long)kBufBytes ? 1 : (long long)kBufBytes / (4 * per);
    kc = kc < k ? kc : k;
    pl.bufs = 2;
  } else {
    kc = k;
    pl.bufs = 0;
  }
  pl.kc = (int)kc;
  pl.nch = (int)((k + kc - 1) / kc);
  pl.off[0] = 0;
  for (int i = 0; i < ns; ++i)
    pl.off[i + 1] = pl.off[i] + round4(kc * s[i].w * s[i].nb);
  return pl;
}

// Dynamic shared memory of the staging buffers.
inline size_t plan_bytes(const Plan& pl, int ns) {
  return sizeof(float) * (size_t)pl.off[ns] * pl.bufs;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The whole block issues the copies of chunk c into buf (16-byte copies
// where the strip allows them); the caller completes them with
// cp_async_wait_all and a barrier.
template <int NS>
__device__ __forceinline__ void stage_chunk(const Strip (&s)[NS],
                                            const Plan& pl, int k, int c,
                                            float* buf) {
  const int k0 = c * pl.kc;
  const int kn = min(pl.kc, k - k0);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int w = s[i].w;
    for (int r = 0; r < s[i].nb; ++r) {
      const float* src = s[i].src + ((long long)r * k + k0) * w;
      float* dst = buf + pl.off[i] + (long long)r * pl.kc * w;
      const int nf = kn * w;
      if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int j = threadIdx.x; j < nf / 4; j += blockDim.x)
          cp_async16(dst + 4 * j, src + 4 * j);
      } else {
        for (int j = threadIdx.x; j < nf; j += blockDim.x)
          cp_async4(dst + j, src + j);
      }
    }
  }
}

// The view of chunk c: in a staging buffer, or in place.
template <int NS>
__device__ __forceinline__ View chunk_view(const Strip (&s)[NS],
                                           const Plan& pl, int k, int c,
                                           const float* buf) {
  View v;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (pl.bufs) {
      v.p[i] = buf + pl.off[i];
      v.bs[i] = (long long)pl.kc * s[i].w;
    } else {
      v.p[i] = s[i].src + (long long)c * pl.kc * s[i].w;
      v.bs[i] = (long long)k * s[i].w;
    }
  }
  return v;
}

// Walks a block's tiles and, per tile, every chunk: at step (tile, c) it
// makes chunk c visible to the block, prefetches the next step's chunk
// into the other buffer, and calls body(view, c, k0, k1); after the last
// chunk of a tile, done(). Every thread of the block takes every step
// (the barriers), whether or not its points are in range.
template <int NS, class Body, class Done, class Init>
__device__ __forceinline__ void for_tiles_and_chunks(
    const Strip (&s)[NS], const Plan& pl, int k, long long ntiles,
    float* smem, Init init, Body body, Done done) {
  float* buf[2] = {smem, smem + pl.off[NS]};
  if (pl.bufs) stage_chunk(s, pl, k, 0, buf[0]);
  long long step = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    init(t);
    for (int c = 0; c < pl.nch; ++c, ++step) {
      const float* b = smem;
      if (pl.bufs) {
        if (pl.bufs == 2 || step == 0) {
          cp_async_wait_all();
          __syncthreads();
        }
        if (pl.bufs == 2) {
          const bool more = c + 1 < pl.nch || t + gridDim.x < ntiles;
          if (more) stage_chunk(s, pl, k, (c + 1) % pl.nch,
                                buf[(step + 1) & 1]);
          b = buf[step & 1];
        }
      }
      const int k0 = c * pl.kc;
      body(chunk_view(s, pl, k, c, b), k0, min(k, k0 + pl.kc));
    }
    done();
  }
  cp_async_wait_all();
}

// Strip i of a view as a pointer the compiler knows to lie in shared
// memory (an offset from the dynamic shared array, taken through the
// shared-window addresses), so that it reads it with LDS and not with
// generic loads; only for a plan that stages (pl.bufs != 0: the launch
// checks).
template <class T>
__device__ __forceinline__ const T* staged_strip(const View& v, int i) {
  extern __shared__ float4 smem4[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(v.p[i]));
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(smem4) +
                                    (at - base));
}

// The grid of a serving kernel: as many blocks as are resident on the
// card at this shared memory (occupancy), at most one per tile.
template <class Kernel>
cudaError_t serving_launch_grid(Kernel kernel, size_t smem, long long ntiles,
                                int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long g = (long long)(per > 0 ? per : 1) * sms;
  *grid = (int)(ntiles < g ? (ntiles > 0 ? ntiles : 1) : g);
  return cudaSuccess;
}

// -- B3/B4's tail transform and softmax fold, in log2 units -------------------
//
// B3 and B4 work in log2 units: lp log2(e) = aux log2(e) - h log2(1 + u)
// (aux log2(e) one multiply per component, shared by a thread's points),
// the fold's exp is a bare ex2 and the output ln 2 (m + log2 sum). The
// plain versions keep natural units.

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(1 + u) for u >= 0, within a few f32 ulps relative everywhere, in
// place of CUDA's log1pf (software, ~4x the instructions). The tail
// exponent h reaches ~N_k / 2 while the relevant u sit near 1e-5, so the
// error must stay relative for small u: lg2.approx(1 + u) is off by
// ~2^-22 absolutely near 1, which h would carry into whole nats. So, for
// u <= 1, 2 atanh(s) log2(e) with s = u / (2 + u) <= 1/3 (one MUFU
// reciprocal), the odd series to s^13 (truncation < 2e-8 relative);
// for u > 1, lg2.approx(1 + u), within 2 ulps there (1 + u > 2). Both
// are formed and one is selected: no divergence.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float log2_1p(float u) {
  constexpr float c0 = 2.8853900817779268f;    // 2 log2(e) / (2i + 1)
  constexpr float c1 = 0.96179669392597560f;
  constexpr float c2 = 0.57707801635558536f;
  constexpr float c3 = 0.41219858311113240f;
  constexpr float c4 = 0.32059889797532520f;
  constexpr float c5 = 0.26230818925253880f;
  constexpr float c6 = 0.22195308321368670f;
  const float s = u * rcp_approx(2.0f + u);
  const float s2 = s * s;
  float p = fmaf(c6, s2, c5);
  p = fmaf(p, s2, c4);
  p = fmaf(p, s2, c3);
  p = fmaf(p, s2, c2);
  p = fmaf(p, s2, c1);
  p = fmaf(p, s2, c0);
  const float big = lg2_approx(1.0f + u);
  return u <= 1.0f ? s * p : big;
}

// The blocked softmax fold of B3/B4: G components' lp (log2 units) folded
// into (mx, sum), sum = sum_i 2^(lp_i - mx), at once: m = max(mx, lp_g),
// sum <- sum 2^(mx - m) + sum_g 2^(lp_g - m). G + 1 exps for G
// components and no serial select chain (online_add takes one exp a
// component but a compare-select-exp chain through the running max).
// Missing components carry lp = -inf (a weight of 0); an all -inf start
// keeps sum = 0 and mx = -inf.
template <int G>
__device__ __forceinline__ void fold_group(const float (&lp)[G], float& mx,
                                           float& sum) {
  float m = mx;
#pragma unroll
  for (int g = 0; g < G; ++g) m = fmaxf(m, lp[g]);
  const float ms = m == -INFINITY ? 0.0f : m;
  float s = sum * ex2_approx(mx - ms);
#pragma unroll
  for (int g = 0; g < G; ++g) s += ex2_approx(lp[g] - ms);
  sum = s;
  mx = m;
}

// out of a point folded by fold_group: ln(sum_i e^lp_i), in nats.
__device__ __forceinline__ float fold_result(float mx, float sum) {
  return 0.69314718055994531f * (mx + log2f(sum));
}

// B5/B6's moments under the online softmax. Per output the sums are
// taken about ref, the mean of the component that holds the running max:
// s1 = sum_k w_k (mu_k - ref), s2 = sum_k w_k ((mu_k - ref)^2 + cvc_k),
// so that mean = ref + s1 / s0 and var = s2 / s0 - (s1 / s0)^2 cancel
// only down to the spread about that component. The expanded E[cvc +
// mu^2] - mean^2 cancels down to the rounding of mean^2 where the means
// sit far from 0 against the variance (in the plain version too, which
// now takes the centred two-pass form), and a Welford running mean,
// whose rounding of ~K eps |mean| enters the variance at first order,
// read 9x the plain error on the sine cell's variance. When this term
// takes the max (`up`) the sums move to its mean first, exactly in the
// algebra:
// s1 += s0 (ref - mu), s2 += (ref - mu) (2 s1 + s0 (ref - mu)), s0 the
// weights' sum before this fold; then online_add's `scale` rescales them
// and the term adds w (mu - ref) and w ((mu - ref)^2 + cvc).
__device__ __forceinline__ void moments_add(bool up, float s0, float scale,
                                            float w, float mu, float cvc,
                                            float& ref, float& s1,
                                            float& s2) {
  const float shift = up ? ref - mu : 0.0f;
  const float dm = up ? 0.0f : mu - ref;
  s2 = fmaf(fmaf(shift, fmaf(s0, shift, 2.0f * s1), s2), scale,
            w * fmaf(dm, dm, cvc));
  s1 = fmaf(fmaf(s0, shift, s1), scale, w * dm);
  ref = up ? mu : ref;
}

// (mean, var) from moments_add's sums.
__device__ __forceinline__ float2 moments_out(float ref, float s1, float s2,
                                              float s0) {
  const float d1 = s1 / s0;
  return make_float2(ref + d1, fmaxf(s2 / s0 - d1 * d1, 0.0f));
}

// -- quadratic forms ----------------------------------------------------------

__host__ __device__ constexpr int gauss_m(int d) { return 1 + d + d * d; }
__host__ __device__ constexpr int diag_m(int d) { return 1 + 2 * d; }
__host__ __device__ constexpr int joint_m(int d, int p) {
  return 1 + d + d * d + p + d * p + p * p;
}

// B3's and B5's map of a point at compile-time d (kGauss: F = [1; x;
// x (x) x]; kDiag: F = [1; x; x^2]), held as F's distinct entries: x_a x_b
// and x_b x_a are one product (they round alike), so the Gauss map takes
// S = 1 + d + d (d + 1) / 2 registers, not M = 1 + d + d^2 (45, not 73,
// at d = 8). Column j of F lies at src(j).
template <int kMap, int D>
struct PointMap {
  static constexpr int M = kMap == kGauss ? gauss_m(D) : diag_m(D);
  static constexpr int S = kMap == kGauss ? 1 + D + D * (D + 1) / 2 : M;

  __host__ __device__ static constexpr int src(int j) {
    if (kMap != kGauss || j <= D) return j;
    const int a = (j - 1 - D) / D, b = (j - 1 - D) % D;
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    return 1 + D + lo * D - lo * (lo - 1) / 2 + hi - lo;
  }

  __device__ __forceinline__ static void feat(const float* x, float* f) {
    f[0] = 1.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      f[1 + a] = x[a];
      if constexpr (kMap == kGauss) {
#pragma unroll
        for (int b = a; b < D; ++b) f[src(1 + D + a * D + b)] = x[a] * x[b];
      } else {
        f[1 + D + a] = x[a] * x[a];
      }
    }
  }
};

// B6's joint map [1; x; x (x) x; y; x (x) y; y (x) y] of a point at
// compile-time d and p, held as its distinct entries in the same way: the
// Gauss map's first (PointMap<kGauss, D>'s layout, so its rows read the
// same storage), then y, x_a y_j, and y_i y_j for i <= j. 78 registers,
// not 109, at d = 8, p = 3.
template <int D, int P>
struct JointMap {
  using G = PointMap<kGauss, D>;
  static constexpr int M = joint_m(D, P);
  static constexpr int S = G::S + P + D * P + P * (P + 1) / 2;

  __host__ __device__ static constexpr int src(int j) {
    if (j < G::M) return G::src(j);
    const int t = j - G::M;
    if (t < P + D * P) return G::S + t;
    const int a = (t - P - D * P) / P, b = (t - P - D * P) % P;
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    return G::S + P + D * P + lo * P - lo * (lo - 1) / 2 + hi - lo;
  }

  __device__ __forceinline__ static void feat(const float* x, const float* y,
                                              float* f) {
    G::feat(x, f);
#pragma unroll
    for (int j = 0; j < P; ++j) f[G::S + j] = y[j];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) f[G::S + P + i * P + j] = x[i] * y[j];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = i; j < P; ++j)
        f[src(G::M + P + D * P + i * P + j)] = y[i] * y[j];
  }
};

// s[i] = th . F_i over Map's M columns for the PTS points a thread owns
// (their maps in f, Map's storage or a larger one that begins with it),
// each one f32 FMA chain in F's column order (f[0] = 1); the row (16-byte
// aligned, loads past M within its padded width) is read once as float4
// broadcasts, each value feeding every point's chain.
template <class Map, int PTS, int S>
__device__ __forceinline__ void map_dots(const float* th,
                                         const float (&f)[PTS][S],
                                         float (&s)[PTS]) {
  const float4* q = reinterpret_cast<const float4*>(th);
#pragma unroll
  for (int j4 = 0; j4 < (Map::M + 3) / 4; ++j4) {
    const float4 v = q[j4];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * j4 + c;
      if (j < Map::M) {
#pragma unroll
        for (int i = 0; i < PTS; ++i)
          s[i] = j == 0 ? e[0] : fmaf(e[c], f[i][Map::src(j)], s[i]);
      }
    }
  }
}

// Runtime-width counterparts: x_a = x[a * xs] (the point's column of xt),
// th where it lies.
__device__ __forceinline__ float gauss_dot_rt(const float* th, const float* x,
                                              long long xs, int d) {
  float s = th[0];
  for (int a = 0; a < d; ++a) s = fmaf(th[1 + a], x[a * xs], s);
  const float* h = th + 1 + d;
  for (int a = 0; a < d; ++a) {
    const float xa = x[a * xs];
    for (int b = 0; b < d; ++b) s = fmaf(h[a * d + b], xa * x[b * xs], s);
  }
  return s;
}

__device__ __forceinline__ float diag_dot_rt(const float* th, const float* x,
                                             long long xs, int d) {
  float s = th[0];
  for (int a = 0; a < d; ++a) s = fmaf(th[1 + a], x[a * xs], s);
  for (int a = 0; a < d; ++a) {
    const float xa = x[a * xs];
    s = fmaf(th[1 + d + a], xa * xa, s);
  }
  return s;
}

// z = [x (d rows); y (p rows)] at z[i * zs].
__device__ __forceinline__ float joint_dot_rt(const float* th, const float* z,
                                              long long zs, int d, int p) {
  float s = gauss_dot_rt(th, z, zs, d);
  const float* y = z + d * zs;
  const float* t = th + 1 + d + d * d;
  for (int j = 0; j < p; ++j) s = fmaf(t[j], y[j * zs], s);
  t += p;
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < p; ++j)
      s = fmaf(t[i * p + j], z[i * zs] * y[j * zs], s);
  t += d * p;
  for (int i = 0; i < p; ++i)
    for (int j = 0; j < p; ++j)
      s = fmaf(t[i * p + j], y[i * zs] * y[j * zs], s);
  return s;
}

}  // namespace
