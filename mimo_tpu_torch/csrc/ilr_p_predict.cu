// Kernel B6, the fused ILR posterior-predictive regression for p > 1
// experts (MNW or MNG): its C entry. The kernel and its note:
// ilr_predict.cuh.
#include "ilr_predict.cuh"

namespace {

// The compiled widths: d <= 8 and p = 2, 3 (the cells' d = 2, p = 3 among
// them); every other (d, p) takes the runtime-width kernel.
inline bool compiled_width(int d, int p) {
  return d >= 1 && d <= 8 && (p == 2 || p == 3);
}

template <int D, int P>
cudaError_t launch_ilr_p_predict(const float* xt, long long ld, int d, int p,
                                 int has_y, int diag, long long n,
                                 const float* th, int k, int m8,
                                 const float* aux, const float* vc, int hard,
                                 float* out, float* refs, cudaStream_t st) {
  const Strip s[3] = {{th, m8, p_predict_blocks(p, has_y, diag)},
                      {aux, 8, 1}, {vc, diag ? 2 * p : p, 1}};
  const Plan pl = make_plan(s, 3, k);
  const size_t smem = plan_bytes(pl, 3);
  const long long tile = (long long)kThreads * b6_points(D);
  int grid = 0;
  cudaError_t err = serving_launch_grid(ilr_p_predict_kernel<D, P>, smem,
                                        (n + tile - 1) / tile, &grid);
  if (err != cudaSuccess) return err;
  ilr_p_predict_kernel<D, P><<<grid, kThreads, smem, st>>>(
      xt, ld, d, p, has_y, diag, n, th, k, m8, aux, vc, hard, pl, out, refs);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_p(int p, const float* xt, long long ld, int d,
                       int has_y, int diag, long long n, const float* th,
                       int k, int m8, const float* aux, const float* vc,
                       int hard, float* out, cudaStream_t st) {
  if (p == 2)
    return launch_ilr_p_predict<D, 2>(xt, ld, d, p, has_y, diag, n, th, k,
                                      m8, aux, vc, hard, out, nullptr, st);
  return launch_ilr_p_predict<D, 3>(xt, ld, d, p, has_y, diag, n, th, k, m8,
                                    aux, vc, hard, out, nullptr, st);
}

}  // namespace

// xt (d + has_y p, ld) f32, points 0..n-1; th (p_predict_blocks k, m8)
// f32; aux (k, 8) f32; vc (k, p) f32, or (k, 2p) for `diag`; out
// (2p + 2, n) f32; refs (p, n) f32 scratch (the runtime-width kernel's
// reference means; the compiled widths leave it alone). Returns a
// cudaError_t code.
extern "C" int mimo_ilr_p_predict(const float* xt, long long ld, int d,
                                  int p, int has_y, int diag, long long n,
                                  const float* th, int k, int m8,
                                  const float* aux, const float* vc,
                                  int hard, float* out, float* refs,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = has_y ? joint_m(d, p) : gauss_m(d);
  if (k < 1 || p < 1 || m8 % 8 != 0 || m8 < width)
    return cudaErrorInvalidValue;
  if (!compiled_width(d, p))
    return launch_ilr_p_predict<0, 0>(xt, ld, d, p, has_y, diag, n, th, k,
                                      m8, aux, vc, hard, out, refs, s);
  switch (d) {
    case 1: return dispatch_p<1>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 2: return dispatch_p<2>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 3: return dispatch_p<3>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 4: return dispatch_p<4>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 5: return dispatch_p<5>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 6: return dispatch_p<6>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    case 7: return dispatch_p<7>(p, xt, ld, d, has_y, diag, n, th, k, m8, aux,
                                 vc, hard, out, s);
    default: return dispatch_p<8>(p, xt, ld, d, has_y, diag, n, th, k, m8,
                                  aux, vc, hard, out, s);
  }
}
