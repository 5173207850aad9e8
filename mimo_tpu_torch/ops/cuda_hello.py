"""Kernel S3, the toolchain probe o = 2 x (csrc/hello.cu), with its plain
PyTorch version. Replaces scripts/pallas_hello.py::kern. `chip_smoke.py`
launches it first, right after the build, and compares it exactly with
2 x: the cheapest proof that nvcc, the ctypes binding and a launch work
on the card."""

import torch

from mimo_tpu_torch.ops import _build

launches = 0          # kernel launches by `twice`, for run accounting


def twice_plain(x):
    return 2.0 * x


def twice(x):
    """2 x. Launches the kernel for a CUDA tensor (contiguous float32; it
    raises on anything else) and runs `twice_plain` for a CPU tensor."""
    global launches
    if not x.is_cuda:
        return twice_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError('cuda_hello: the kernel takes a contiguous float32 '
                         'tensor')
    lib = _build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.mimo_hello(x.data_ptr(), x.numel(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_hello')
    launches += 1
    return out
