"""Kernel B1, the fused mixture E-step (csrc/estep.cu), with its plain
PyTorch version. Replaces mimo_tpu/ops/pallas_estep.py::_estep_kernel2.

Per point: F = [1; x; x (x) x], logp = theta . F over K (theta's column 0
holds c + log pi, so counts = acc[:, 0]), a softmax over K with a 1e-37
denominator floor, acc (K, m8) += (ex / denom) F^T and lse += logsumexp.

What bounds it on the H100, and what the kernel does about it: see the
note at the top of csrc/estep.cu (arithmetic-bound f32 FMA dots of depth
m8, a bounded grid with per-block partials and a fixed-order second
pass, theta staged in shared memory).
"""

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.family_estep import FusedEStep, gauss_features_t

launches = 0          # kernel launches by `estep`, for run accounting
_CHUNK = 1 << 20      # points per step of the plain versions


def assemble_features(xt, m8):
    """gauss_features_t of a (d, B) block, zero-padded to m8 rows."""
    f = gauss_features_t((xt,))
    return torch.cat([f, f.new_zeros((m8 - f.shape[0], f.shape[1]))])


def pad_theta(theta, log_pi, dtype):
    """Fold log_pi into the constant column and zero-pad the feature axis
    to a multiple of 8. Returns (theta (K, m8) contiguous, m)."""
    k, m = theta.shape
    m8 = -(-m // 8) * 8
    theta = torch.cat([theta[:, :1] + log_pi[:, None], theta[:, 1:],
                       theta.new_zeros((k, m8 - m))], -1)
    return theta.to(dtype).contiguous(), m


def estep_plain(xt, theta, n):
    """Plain PyTorch version of B1: xt (d, >=n), theta (K, m8) ->
    (acc (K, m8), lse ()), in xt's dtype."""
    k, m8 = theta.shape
    acc = torch.zeros((k, m8), dtype=theta.dtype, device=theta.device)
    lse = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], m8)
        logp = theta @ f
        mx = torch.max(logp, 0, keepdim=True).values
        ex = torch.exp(logp - mx)
        denom = torch.clamp(torch.sum(ex, 0, keepdim=True), min=1e-37)
        acc = acc + ex @ (f / denom).T
        lse = lse + torch.sum(mx + torch.log(denom))
    return acc, lse


def estep(xt, theta, n):
    """B1 over points 0..n-1 of xt (d, >=n); theta (K, m8) with c + log pi
    in column 0. Launches the kernel for CUDA tensors (float32 only; it
    raises on anything it does not take) and runs `estep_plain` for CPU
    tensors. Returns (acc (K, m8), lse ())."""
    global launches
    if not xt.is_cuda:
        return estep_plain(xt, theta, n)
    lib = _build.load()
    k, m8 = theta.shape
    grid = _build.check_launch('cuda_estep', xt, n, theta,
                               lib.mimo_estep_smem_bytes(k, m8))
    part = torch.empty((grid, k * m8 + 1), dtype=torch.float32,
                       device=xt.device)
    out = torch.empty((k * m8 + 1,), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_estep(xt.data_ptr(), xt.stride(0), xt.shape[0], n,
                            theta.data_ptr(), k, m8, part.data_ptr(),
                            out.data_ptr(), grid,
                            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_estep')
    launches += 1
    return out[:-1].view(k, m8), out[-1]


def fused_estep_cuda(spec, post, log_pi, xts, n):
    """Spec-driven fused E-step through B1, the counterpart of
    mimo_tpu's fused_estep_pallas. xts: the (d, N) transposed data
    (see models.mixture.kernel_xts); n: the number of points."""
    if spec.features_t is not gauss_features_t:
        raise NotImplementedError('kernel B1 assembles the full-covariance '
                                  'Gaussian features only')
    theta, m = pad_theta(spec.theta(post), log_pi, xts[0].dtype)
    acc, lse = estep(xts[0], theta, n)
    return FusedEStep(stats=spec.unpack(acc[:, :m]), lse=lse,
                      counts=acc[:, 0])
