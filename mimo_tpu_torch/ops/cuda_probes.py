"""Kernels S1 and S2, two probes of kernel B1's cost (csrc/probes.cu: B1's
kernel, csrc/estep.cuh, with other template parameters, over the Gauss
map), with their plain PyTorch versions. They replace
scripts/bisect_pallas.py::_regf_kernel
(S1) and scripts/bisect_smem.py::kern_nosmem / kern_smem_unused /
kern_smem_used (S2). No model launches them; `chip_smoke.py` checks and
times them against B1.

S1: B1 with (`divide=True`, B1 itself) or without the per-point division
by the softmax denominator; without it acc accumulates sum_n ex F^T with
ex = exp(logp - max over K). lse is the same in both.

S2: B1 with the valid count given in one of three ways: 'none' (no
per-point test: every point of n, a multiple of 128),
'unused' (an int32 count in device memory, passed and never read) and
'used' (that count read once per block; the points at or past it
contribute nothing). The plain version masks by index.
"""

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.cuda_estep import (
    _CHUNK, GAUSS, assemble_features, feature_width)

COUNT_MODES = {'none': 1, 'unused': 2, 'used': 3}   # csrc/estep.cuh CountMode

# kernel launches, by probe variant, for run accounting
launches = {'S1-divide': 0, 'S1-nodivide': 0, 'S2-none': 0, 'S2-unused': 0,
            'S2-used': 0}


def estep_probe_plain(xt, theta, n, divide=True, nv=None):
    """Plain PyTorch version of S1 and S2 over the Gauss map: xt (d, >=n),
    theta (K, m8) -> (acc (K, m8), lse ()). Without `divide` the
    responsibilities are not normalised; with `nv` the points with index
    >= nv are masked out of acc and lse."""
    k, m8 = theta.shape
    acc = torch.zeros((k, m8), dtype=theta.dtype, device=theta.device)
    lse = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], m8)
        logp = theta @ f
        mx = torch.max(logp, 0, keepdim=True).values
        ex = torch.exp(logp - mx)
        denom = torch.clamp(torch.sum(ex, 0, keepdim=True), min=1e-37)
        keep = torch.ones_like(denom)
        if nv is not None:
            idx = torch.arange(s, s + f.shape[1], device=xt.device)
            keep = (idx < nv).to(theta.dtype)[None]
        w = ex * (keep / denom if divide else keep)
        acc = acc + w @ f.T
        lse = lse + torch.sum(keep * (mx + torch.log(denom)))
    return acc, lse


def _launch(xt, theta, n, desc):
    lib = _build.load()
    k, m8 = theta.shape
    d = xt.shape[0]
    desc = f'{desc}, d={d}'
    _build.check_inputs('cuda_probes', xt, n, theta, feature_width(GAUSS, d),
                        desc)
    work = _build.tc_scratch('cuda_probes', lib, lib.mimo_probe_scratch, xt,
                             n, theta, desc)
    out = torch.empty((k * m8 + 1,), dtype=torch.float32, device=xt.device)
    return lib, work, out


def regf(xt, theta, n, divide=True):
    """S1 over points 0..n-1 of xt (d, >=n). Launches the kernel for CUDA
    tensors (float32; it raises on anything else) and runs
    `estep_probe_plain` for CPU tensors. Returns (acc (K, m8), lse ())."""
    if not xt.is_cuda:
        return estep_probe_plain(xt, theta, n, divide)
    lib, work, out = _launch(xt, theta, n, 'S1 gauss map')
    k, m8 = theta.shape
    with torch.cuda.device(xt.device):
        rc = lib.mimo_regf(xt.data_ptr(), xt.stride(0), xt.shape[0], n,
                           theta.data_ptr(), k, m8, int(divide),
                           work.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_probes.regf')
    launches['S1-divide' if divide else 'S1-nodivide'] += 1
    return out[:-1].view(k, m8), out[-1]


def estep_count(xt, theta, n, mode, nv=None):
    """S2 over points 0..n-1 of xt (d, >=n) with the valid count `mode`
    ('none', 'unused' or 'used'); nv is a one-element int32 tensor on the
    data's device for 'unused' and 'used', and n must be a
    multiple of 128 for 'none' and 'unused'. Launches the kernel for CUDA
    tensors and runs `estep_probe_plain` for CPU tensors. Returns
    (acc (K, m8), lse ())."""
    if mode not in COUNT_MODES:
        raise ValueError(f'unknown count mode: {mode!r}')
    if not xt.is_cuda:
        return estep_probe_plain(xt, theta, n, True,
                                 int(nv) if mode == 'used' else None)
    if mode != 'used' and n % 128:
        raise ValueError(f'cuda_probes: mode {mode!r} takes n a multiple of '
                         f'128, got {n}')
    if mode != 'none' and (nv is None or nv.dtype != torch.int32
                           or nv.numel() != 1 or nv.device != xt.device):
        raise ValueError('cuda_probes: nv must be one int32 on the data\'s '
                         'device')
    lib, work, out = _launch(xt, theta, n, 'S2 gauss map')
    k, m8 = theta.shape
    with torch.cuda.device(xt.device):
        rc = lib.mimo_estep_count(
            xt.data_ptr(), xt.stride(0), xt.shape[0], n,
            nv.data_ptr() if nv is not None else None, COUNT_MODES[mode],
            theta.data_ptr(), k, m8, work.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_probes.estep_count')
    launches[f'S2-{mode}'] += 1
    return out[:-1].view(k, m8), out[-1]
