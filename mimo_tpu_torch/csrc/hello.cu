// Kernel S3: o = 2 x, the toolchain probe. Replaces
// scripts/pallas_hello.py::kern (an (8, 128) f32 block doubled on the
// TPU). Here it is the first launch of the build phase: it shows that
// nvcc built the library for this card, that ctypes passes pointers and
// the stream through, and that a launch runs, before any real kernel is
// checked. Bound by nothing that matters: one load and one store per
// element.
#include "common.cuh"

namespace {

__global__ void twice_kernel(const float* __restrict__ x, long long n,
                             float* __restrict__ o) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

}  // namespace

// x, o: n contiguous f32. Returns a cudaError_t code.
extern "C" int mimo_hello(const float* x, long long n, float* o,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0)
    twice_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, n, o);
  return cudaGetLastError();
}
