// Kernel B5, the fused ILR posterior-predictive regression for p = 1
// experts: its C entry. The kernel and its note: ilr_predict.cuh.
#include "ilr_predict.cuh"

namespace {

template <int D>
cudaError_t launch_ilr_predict(const float* xt, long long ld, int d,
                               int has_y, long long n, const float* th, int k,
                               int m8, const float* aux, int hard, float* out,
                               cudaStream_t st) {
  const Strip s[2] = {{th, m8, 3}, {aux, 8, 1}};
  const Plan pl = make_plan(s, 2, k);
  const size_t smem = plan_bytes(pl, 2);
  const long long tile = (long long)kThreads * b5_points(D);
  int grid = 0;
  cudaError_t err = serving_launch_grid(ilr_predict_kernel<D>, smem,
                                        (n + tile - 1) / tile, &grid);
  if (err != cudaSuccess) return err;
  ilr_predict_kernel<D><<<grid, kThreads, smem, st>>>(
      xt, ld, d, has_y, n, th, k, m8, aux, hard, pl, out);
  return cudaGetLastError();
}

}  // namespace

// xt (d + has_y, ld) f32, points 0..n-1; th (3k, m8) f32; aux (k, 8)
// f32; out (4, n) f32. Returns a cudaError_t code.
extern "C" int mimo_ilr_predict(const float* xt, long long ld, int d,
                                int has_y, long long n, const float* th,
                                int k, int m8, const float* aux, int hard,
                                float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || m8 % 8 != 0 || m8 < gauss_m(d)) return cudaErrorInvalidValue;
  switch (d) {
    case 1: return launch_ilr_predict<1>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 2: return launch_ilr_predict<2>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 3: return launch_ilr_predict<3>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 4: return launch_ilr_predict<4>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 5: return launch_ilr_predict<5>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 6: return launch_ilr_predict<6>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 7: return launch_ilr_predict<7>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    case 8: return launch_ilr_predict<8>(xt, ld, d, has_y, n, th, k, m8, aux,
                                         hard, out, s);
    default: return launch_ilr_predict<0>(xt, ld, d, has_y, n, th, k, m8,
                                          aux, hard, out, s);
  }
}
