"""Kernel B2, the fused blocked-Gibbs label sweep (csrc/gibbs.cu), with
its plain PyTorch version. Replaces mimo_tpu/ops/pallas_gibbs.py::_gibbs_kernel.

Per point: plug-in logp = theta . F over K, Gumbel noise from Philox4x32-10
keyed by (sweep seed, global point index) (ops/philox.py), the
first-occurrence argmax over K as the label, and acc (K, m8) +=
one_hot(label) F^T. The plain version draws the same Philox numbers, so
kernel and plain labels agree draw for draw except at near-ties that the
f32 summation order decides.

What bounds it on the H100, and what the kernel does about it: see the
note at the top of csrc/gibbs.cu.
"""

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.cuda_estep import (
    _CHUNK, assemble_features, pad_theta)
from mimo_tpu_torch.ops.family_estep import FusedEStep, gauss_features_t
from mimo_tpu_torch.ops.philox import gumbel_max_labels

launches = 0          # kernel launches by `gibbs`, for run accounting


def gibbs_plain(xt, theta, seed, n):
    """Plain PyTorch version of B2: xt (d, >=n), theta (K, m8) with log pi
    in column 0, seed a 0-d int64 tensor -> (labels (n,) int32,
    acc (K, m8))."""
    k, m8 = theta.shape
    acc = torch.zeros((k, m8), dtype=theta.dtype, device=theta.device)
    labels = torch.empty((n,), dtype=torch.int32, device=theta.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], m8)
        lab = gumbel_max_labels((theta @ f).T, seed, s)
        labels[s:s + lab.shape[0]] = lab
        oh = torch.nn.functional.one_hot(lab.long(), k).to(f.dtype)
        acc = acc + oh.T @ f.T
    return labels, acc


def gibbs(xt, theta, seed, n):
    """B2 over points 0..n-1 of xt (d, >=n). Launches the kernel for CUDA
    tensors (float32 data, an int64 seed on the same device; it raises on
    anything else) and runs `gibbs_plain` for CPU tensors. Returns
    (labels (n,) int32, acc (K, m8))."""
    global launches
    if not xt.is_cuda:
        return gibbs_plain(xt, theta, seed, n)
    lib = _build.load()
    k, m8 = theta.shape
    grid = _build.check_launch('cuda_gibbs', xt, n, theta,
                               lib.mimo_gibbs_smem_bytes(k, m8))
    if (seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != xt.device):
        raise ValueError('cuda_gibbs: seed must be one int64 on the '
                         "data's device")
    seed = seed.contiguous()
    labels = torch.empty((n,), dtype=torch.int32, device=xt.device)
    part = torch.empty((grid, k * m8), dtype=torch.float32, device=xt.device)
    acc = torch.empty((k, m8), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_gibbs(xt.data_ptr(), xt.stride(0), xt.shape[0], n,
                            theta.data_ptr(), k, m8, seed.data_ptr(),
                            labels.data_ptr(), part.data_ptr(),
                            acc.data_ptr(), grid,
                            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_gibbs')
    launches += 1
    return labels, acc


def fused_gibbs_cuda(spec, seed, params, log_pi, xts, n):
    """Spec-driven fused Gibbs label sweep through B2, the counterpart of
    mimo_tpu's fused_gibbs_pallas. Returns (labels (n,) int32,
    FusedEStep with one-hot stats and lse = 0)."""
    if spec.features_t is not gauss_features_t:
        raise NotImplementedError('kernel B2 assembles the full-covariance '
                                  'Gaussian features only')
    theta, m = pad_theta(spec.theta_plugin(params), log_pi, xts[0].dtype)
    labels, acc = gibbs(xts[0], theta, seed, n)
    return labels, FusedEStep(stats=spec.unpack(acc[:, :m]),
                              lse=acc.new_zeros(()), counts=acc[:, 0])
