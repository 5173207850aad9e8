"""Kernel B4, the fused Student-t posterior-predictive mixture density of
a diagonal (Normal-Gamma) Gaussian mixture (csrc/diag_predict.cu), with
its plain PyTorch version and the coefficient builder. Replaces
mimo_tpu/ops/pallas_predict.py::_diag_predict_kernel.

A component's predictive is a product of per-dimension univariate t's,
so per point: u_kj = max(thu_kj . F, 0) over F = [1; x; x^2] (the scaled
quads (lam_kj / df_kj) (x_j - mu_kj)^2), lp_k = aux_k - sum_j h_kj
log1p(u_kj), and out = logsumexp over K. The (N, K) matrix never exists
on the card. What bounds B4 on the H100 and what it does about it: see
the note at the top of csrc/diag_predict.cu.

`diag_predictive_cuda` is the counterpart of mimo_tpu's
diag_predictive_pallas: 'studentt' through B4, 'gaussian' through B3
over the diagonal map.
"""

import math

import torch

from mimo_tpu_torch.distributions.ng import predictive_studentt_params
from mimo_tpu_torch.ops import _build, cuda_predict
from mimo_tpu_torch.ops.cuda_estep import (
    _CHUNK, DIAG, assemble_features, feature_width)
from mimo_tpu_torch.utils.stats import gammaln_diff

launches = 0          # kernel launches by `diag_predict`, for run accounting


def diag_predict_coefficients(post, log_w):
    """(thu (K d, m8), h (K d), aux (K)) of B4 for an NG posterior, in the
    posterior's dtype (mimo_tpu's diag_predictive_pallas, Student-t):
    row (k, j) of thu is r_kj (x_j - mu_kj)^2 with r = lam / df, expanded
    over [1; x; x^2]; h = (df + 1) / 2; aux = the per-component sum of the
    per-dim normalisers plus log w."""
    mu, lam, df = predictive_studentt_params(post)       # (K, d) each
    k, d = mu.shape
    m = 1 + 2 * d
    m8 = -(-m // 8) * 8
    r = lam / df
    eye = torch.eye(d, dtype=mu.dtype, device=mu.device)
    thu = torch.cat([(r * mu * mu).reshape(k * d, 1),
                     ((-2.0 * r * mu)[:, :, None] * eye).reshape(k * d, d),
                     (r[:, :, None] * eye).reshape(k * d, d),
                     mu.new_zeros((k * d, m8 - m))], -1)
    h = (0.5 * (df + 1.0)).reshape(k * d)
    aux = (torch.sum(gammaln_diff(0.5 * df, 0.5)
                     + 0.5 * (torch.log(lam) - torch.log(df)
                              - math.log(math.pi)), -1) + log_w)
    return thu.contiguous(), h.contiguous(), aux.contiguous()


def diag_predict_plain(xt, thu, h, aux, n):
    """Plain PyTorch version of B4: xt (d, >=n), thu (K d, m8), h (K d),
    aux (K) -> (n,) mixture log-densities, in chunks of points."""
    k, d = aux.shape[0], xt.shape[0]
    out = torch.empty((n,), dtype=thu.dtype, device=thu.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], thu.shape[1],
                              DIAG)
        u = torch.clamp(thu @ f, min=0.0)                 # (K d, B)
        t = h[:, None] * torch.log1p(u)
        lp = aux[:, None] - torch.sum(t.reshape(k, d, -1), 1)
        out[s:s + f.shape[1]] = torch.logsumexp(lp, 0)
    return out


def diag_predict(xt, thu, h, aux, n):
    """B4 over points 0..n-1 of xt (d, >=n). Launches the kernel for CUDA
    tensors (float32 only; it raises on anything it does not take) and
    runs `diag_predict_plain` for CPU tensors. Returns (n,)
    log-densities."""
    global launches
    if not xt.is_cuda:
        return diag_predict_plain(xt, thu, h, aux, n)
    lib = _build.load()
    k, d = aux.shape[0], xt.shape[0]
    m8 = thu.shape[1]
    grid = _build.check_launch('cuda_diag_predict', xt, n, thu,
                               lib.mimo_diag_predict_smem_bytes(k, d, m8),
                               feature_width(DIAG, d), f'diag map, d={d}')
    if thu.shape[0] != k * d:
        raise ValueError(f'cuda_diag_predict: {thu.shape[0]} coefficient '
                         f'rows, the kernel reads K d = {k * d}')
    for name, t, size in (('h', h, k * d), ('aux', aux, k)):
        if (t.dtype != torch.float32 or t.shape != (size,)
                or not t.is_contiguous() or t.device != xt.device):
            raise ValueError(f'cuda_diag_predict: {name} must be a '
                             f'contiguous ({size},) float32 tensor on the '
                             "data's device")
    out = torch.empty((n,), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_diag_predict(xt.data_ptr(), xt.stride(0), d, n,
                                   thu.data_ptr(), k, m8, h.data_ptr(),
                                   aux.data_ptr(), out.data_ptr(), grid,
                                   torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_diag_predict')
    launches += 1
    return out


def diag_predictive_cuda(post, log_w, x, dist='studentt'):
    """logsumexp_k [log_w_k + pred_k(x)] -> (N,) for an NG posterior, the
    counterpart of mimo_tpu's diag_predictive_pallas: 'studentt' (the
    product of per-dim t's) through B4, 'gaussian' (its moment-matched
    approximation) through B3 over the diagonal map. x: (N, d); the
    result has x's dtype."""
    if dist not in ('studentt', 'gaussian'):
        raise ValueError(f'unknown dist: {dist!r}')
    xt = x.T.contiguous()
    if dist == 'gaussian':
        thq, aux = cuda_predict.diag_gaussian_coefficients(post, log_w)
        return cuda_predict.predict(xt, thq.to(x.dtype), aux.to(x.dtype),
                                    x.shape[0], False, DIAG)
    thu, h, aux = diag_predict_coefficients(post, log_w)
    return diag_predict(xt, thu.to(x.dtype), h.to(x.dtype), aux.to(x.dtype),
                        x.shape[0])
