"""Kernel B4, the fused Student-t posterior-predictive mixture density of
a diagonal (Normal-Gamma) Gaussian mixture (csrc/diag_predict.cu), with
its plain PyTorch version and the coefficient builder. Replaces
mimo_tpu/ops/pallas_predict.py::_diag_predict_kernel.

A component's predictive is a product of per-dimension univariate t's,
so per point: u_kj = max(thu_kj . F, 0) over F = [1; x; x^2] (the scaled
quads (lam_kj / df_kj) (x_j - mu_kj)^2, each read from its three nonzero
columns), lp_k = aux_k - sum_j h_kj log1p(u_kj), and out = logsumexp
over K. The (N, K) matrix never exists on the card. What bounds B4 on
the H100 and what it does about it: see the note at the top of
csrc/diag_predict.cu. The kernel works in log2 units, at d = 9..32 on
rows padded to the width it compiles (`kernel_coefficients`, laid out
once per coefficient tensor: `cuda_predict.cached_layout`), and where
h_kj is the same in every dim it takes one log per component: sum_j h
log1p(u_j) = h log1p(U), 1 + U = prod_j (1 + u_j). The plain version
keeps natural units and the per-dim sum.

`diag_predictive_cuda` is the counterpart of mimo_tpu's
diag_predictive_pallas: 'studentt' through B4, 'gaussian' through B3
over the diagonal map.
"""

import math

import torch

from mimo_tpu_torch.distributions.ng import predictive_studentt_params
from mimo_tpu_torch.ops import _build, cuda_predict
from mimo_tpu_torch.ops.cuda_estep import _CHUNK, DIAG
from mimo_tpu_torch.utils.stats import gammaln_diff

launches = 0          # kernel launches by `diag_predict`, for run accounting


def diag_predict_coefficients(post, log_w):
    """(rows (K d, 4), aux (K, 2)) of B4 for an NG posterior, in the
    posterior's dtype (mimo_tpu's diag_predictive_pallas, Student-t).
    Row (k, j) of the TPU kernel's thu is r_kj (x_j - mu_kj)^2 with r =
    lam / df, expanded over [1; x; x^2]; its nonzero columns 0, 1 + j and
    1 + d + j and the tail exponent h_kj = (df_kj + 1) / 2 make B4's row
    [r mu^2, -2 r mu, r, h]; aux[:, 0] = the per-component sum of the
    per-dim normalisers plus log w, aux[:, 1] = h_k where h_kj is exactly
    equal across dims j (every posterior the models fit: alpha is the
    prior's, the same in every dim, plus N_k / 2), else 0."""
    mu, lam, df = predictive_studentt_params(post)       # (K, d) each
    k, d = mu.shape
    r = lam / df
    h = 0.5 * (df + 1.0)
    rows = torch.stack([r * mu * mu, -2.0 * r * mu, r, h], -1)
    aux = (torch.sum(gammaln_diff(0.5 * df, 0.5)
                     + 0.5 * (torch.log(lam) - torch.log(df)
                              - math.log(math.pi)), -1) + log_w)
    shared = torch.where((h == h[:, :1]).all(-1), h[:, 0],
                         torch.zeros_like(h[:, 0]))
    return (rows.reshape(k * d, 4).contiguous(),
            torch.stack([aux, shared], -1).contiguous())


def kernel_coefficients(rows, d):
    """B4's own copy of rows (K d, 4) for the width the kernel compiles d
    at (`cuda_predict.serving_width`): (K width, 4), the rows j >= d of
    each component zero (a padded dim adds u = 0: U and the per-dim sum
    stay exactly as they were); the rows themselves at d itself and at the
    runtime width (0)."""
    width = cuda_predict.serving_width(d)
    if width <= d:
        return rows
    k = rows.shape[0] // d
    padded = rows.new_zeros((k, width, 4))
    padded[:, :d] = rows.view(k, d, 4)
    return padded.view(k * width, 4)


def diag_predict_plain(xt, rows, aux, n):
    """Plain PyTorch version of B4: xt (d, >=n), rows (K d, 4), aux (K, 2)
    -> (n,) mixture log-densities, in chunks of points. Each scaled quad
    is the product of row (k, j)'s first three columns with [1; x_j;
    x_j^2], one batched matmul over j: the TPU kernel's dot over [1; x;
    x^2] without its zero terms; the tail is the per-dim sum whatever
    aux[:, 1] says."""
    k, d = aux.shape[0], xt.shape[0]
    th = rows.reshape(k, d, 4).transpose(0, 1)              # (d, K, 4)
    r, h = th[..., :3].contiguous(), th[..., 3:]
    out = torch.empty((n,), dtype=rows.dtype, device=rows.device)
    for s in range(0, n, _CHUNK):
        x = xt[:, s:min(s + _CHUNK, n)].to(rows.dtype)      # (d, B)
        f = torch.stack([torch.ones_like(x), x, x * x], 1)   # (d, 3, B)
        u = torch.clamp(torch.bmm(r, f), min=0.0)            # (d, K, B)
        lp = aux[:, :1] - torch.sum(h * torch.log1p(u), 0)
        out[s:s + x.shape[1]] = torch.logsumexp(lp, 0)
    return out


def diag_predict(xt, rows, aux, n):
    """B4 over points 0..n-1 of xt (d, >=n). Launches the kernel for CUDA
    tensors (float32 only; it raises on anything it does not take) and
    runs `diag_predict_plain` for CPU tensors. Returns (n,)
    log-densities."""
    global launches
    if not xt.is_cuda:
        return diag_predict_plain(xt, rows, aux, n)
    lib = _build.load()
    k, d = aux.shape[0], xt.shape[0]
    _build.check_inputs('cuda_diag_predict', xt, n, rows, 4,
                        f'diag rows, d={d}')
    if rows.shape != (k * d, 4) or rows.data_ptr() % 16:
        raise ValueError(f'cuda_diag_predict: rows must be (K d, 4) = '
                         f'({k * d}, 4) and 16-byte aligned, got '
                         f'{tuple(rows.shape)}')
    if (aux.dtype != torch.float32 or aux.shape != (k, 2)
            or not aux.is_contiguous() or aux.device != xt.device):
        raise ValueError(f'cuda_diag_predict: aux must be a contiguous '
                         f"({k}, 2) float32 tensor on the data's device")
    width = cuda_predict.serving_width(d)
    rows_k = rows if width <= d else cuda_predict.cached_layout(
        rows, (), d, lambda: kernel_coefficients(rows, d))
    out = torch.empty((n,), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_diag_predict(xt.data_ptr(), xt.stride(0), d, width, n,
                                   rows_k.data_ptr(), k, aux.data_ptr(),
                                   out.data_ptr(),
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
    return diag_predictive_cuda_sharded(post, log_w, [x], dist)[0]


def diag_predictive_cuda_sharded(post, log_w, xs, dist='studentt'):
    """diag_predictive_cuda over the shards of a mesh (xs: one (n_j, d)
    tensor a shard, each on its device): the coefficients built once, B4
    (or B3 over the diagonal map) once per non-empty shard on its device,
    no collective. Returns one (n_j,) result a shard."""
    if dist not in ('studentt', 'gaussian'):
        raise ValueError(f'unknown dist: {dist!r}')
    if dist == 'gaussian':
        thq, aux = cuda_predict.diag_gaussian_coefficients(post, log_w)
        return [cuda_predict.serve_shard(x, lambda xt: cuda_predict.predict(
            xt, thq.to(xt.device, xt.dtype), aux.to(xt.device, xt.dtype),
            xt.shape[1], False, DIAG)) for x in xs]
    rows, aux = diag_predict_coefficients(post, log_w)
    return [cuda_predict.serve_shard(x, lambda xt: diag_predict(
        xt, rows.to(xt.device, xt.dtype), aux.to(xt.device, xt.dtype),
        xt.shape[1])) for x in xs]
