// Kernel B3's C entry and its narrow (d <= 8) and runtime (d > 32) widths;
// the kernel and its note: predict.cuh; the padded widths: predict_wide.cu.
#include "predict.cuh"

namespace {

template <int kMap>
cudaError_t dispatch_predict(const float* xt, long long ld, int width,
                             int d, long long n, const float* thq, int k,
                             int m8, const float* aux, int studentt,
                             float* out, cudaStream_t st) {
  switch (width) {
    case 1: return launch_predict<kMap, 1>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 2: return launch_predict<kMap, 2>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 3: return launch_predict<kMap, 3>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 4: return launch_predict<kMap, 4>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 5: return launch_predict<kMap, 5>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 6: return launch_predict<kMap, 6>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 7: return launch_predict<kMap, 7>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 8: return launch_predict<kMap, 8>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    case 0: return launch_predict<kMap, 0>(xt, ld, d, n, thq, k, m8, aux,
                                           studentt, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xt (d, ld) f32, points 0..n-1; width: the compiled width the host laid
// thq out for: d itself up to 8 or 0 (the runtime width; thq (k, m8) over
// the map at d), or 12, 16, 24 or 32 >= d (thq (k / 8, M_w, 8), group-major,
// term-major, k a multiple of 8 (the extra components' aux [-inf, 0, ...]
// and coefficients zero), m8 = M_w, the map's width at w); kind kKindGauss
// or kKindDiag; aux (k, 8) f32 [aux + log w, h, 1/df, 0, ...]; out (n,)
// f32. Returns a cudaError_t code (cudaErrorInvalidValue for a width it
// does not compile).
extern "C" int mimo_predict(const float* xt, long long ld, int d, int width,
                            int kind, long long n, const float* thq, int k,
                            int m8, const float* aux, int studentt,
                            float* out, void* stream) {
  if ((kind != kKindGauss && kind != kKindDiag) || k < 1 || d < 1)
    return cudaErrorInvalidValue;
  if (width > 8) {
    if (width < d || k % kPredictGroup ||
        m8 != (kind == kKindGauss ? gauss_m(width) : diag_m(width)))
      return cudaErrorInvalidValue;
    return mimo_predict_wide(xt, ld, d, width, kind, n, thq, k, aux,
                             studentt, out, stream);
  }
  if ((width != 0 && width != d) || m8 % 8 != 0 ||
      m8 < feature_width(kind, d, 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == kKindGauss
             ? dispatch_predict<kGauss>(xt, ld, width, d, n, thq, k, m8, aux,
                                        studentt, out, s)
             : dispatch_predict<kDiag>(xt, ld, width, d, n, thq, k, m8, aux,
                                       studentt, out, s);
}
