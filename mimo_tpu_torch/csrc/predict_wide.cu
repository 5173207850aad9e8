// Kernel B3 at the padded widths d = 9..32 (compiled at D = 12, 16, 24,
// 32): compiled apart from predict.cu so that nvcc builds the two in
// parallel. mimo_predict calls this; the layout of th: predict.cuh.
#include "predict.cuh"

namespace {

template <int kMap>
cudaError_t dispatch_wide(const float* xt, long long ld, int d, int width,
                          long long n, const float* th, int k,
                          const float* aux, int studentt, float* out,
                          cudaStream_t st) {
  switch (width) {
    case 12: return launch_predict_wide<kMap, 12>(xt, ld, d, n, th, k, aux,
                                                  studentt, out, st);
    case 16: return launch_predict_wide<kMap, 16>(xt, ld, d, n, th, k, aux,
                                                  studentt, out, st);
    case 24: return launch_predict_wide<kMap, 24>(xt, ld, d, n, th, k, aux,
                                                  studentt, out, st);
    case 32: return launch_predict_wide<kMap, 32>(xt, ld, d, n, th, k, aux,
                                                  studentt, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mimo_predict_wide(const float* xt, long long ld, int d,
                                 int width, int kind, long long n,
                                 const float* th, int k, const float* aux,
                                 int studentt, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == kKindGauss
             ? dispatch_wide<kGauss>(xt, ld, d, width, n, th, k, aux,
                                     studentt, out, s)
             : dispatch_wide<kDiag>(xt, ld, d, width, n, th, k, aux,
                                    studentt, out, s);
}
