"""mimo_tpu_torch: the PyTorch + CUDA port of mimo_tpu.

A second package beside `mimo_tpu` (the JAX reference), mirroring its
layout and names module for module: plain functions on tensors, states
as NamedTuples with the same field names, an explicit `torch.Generator`
wherever the JAX package takes a PRNG key. The hot per-point passes run
through hand-written CUDA kernels (`ops/cuda_*.py`, `csrc/*.cu`) when the
data lies on a CUDA device, and through their plain PyTorch versions when
it lies on the CPU.

This package never imports `jax` or `mimo_tpu`.
"""

import torch as _torch

# Conjugate-update algebra (psi^{-1} + S - kappa' m' m'^T cancellations)
# goes non-PSD at reduced contraction precision, as it did at bf16 on the
# TPU (mimo_tpu/__init__.py sets jax_default_matmul_precision=float32).
# TF32 keeps ~3 decimal digits, so full float32 is the correctness default.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision('highest')

from mimo_tpu_torch import distributions  # noqa: E402
from mimo_tpu_torch import conjugate  # noqa: E402
from mimo_tpu_torch import models  # noqa: E402
from mimo_tpu_torch import ops  # noqa: E402
from mimo_tpu_torch import parallel  # noqa: E402
from mimo_tpu_torch import utils  # noqa: E402

__version__ = "0.1.0"
