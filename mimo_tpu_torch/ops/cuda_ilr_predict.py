"""Kernels B5 and B6, fused ILR posterior-predictive regression
(csrc/ilr_predict.cuh), with their plain PyTorch versions and the
coefficient builders. Replace mimo_tpu/ops/pallas_predict.py::
_ilr_predict_kernel (B5, p = 1 experts) and ::_ilr_p_predict_kernel
(B6, p > 1, MNW or MNG experts).

One pass over the points gives the input-conditional Student-t expert
weights, the moment-matched mixture mean and variance (or the argmax
expert's, prediction='mode') and, with y, the negative log predictive
density; the (N, K) intermediates never exist on the card. Everything is
in standardized units: the model applies the output transform and the
NLPD Jacobian. What bounds the kernels on the H100 and what they do about
it: see the note at the top of csrc/ilr_predict.cuh.

The coefficient functions cover every basis and expert a model makes:
an NIW or HierTied basis (`cuda_predict.basis_studentt_params`, the two
branches of mimo_tpu's `_basis_studentt_params`) and MNW, MNG or
tied-affine experts (the branches of `_expert_rows` and the head of
`_ilr_p_predict_pallas`). Tied-affine experts are repacked into their
block-diagonal MNW (`affine.to_packed_mnw`), whose offset column is the
affine part, so the kernels see MNW coefficients.
"""

import math

import torch

from mimo_tpu_torch.distributions.affine import TiedAffine, to_packed_mnw
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.cuda_estep import _CHUNK, assemble_features, pad_rows
from mimo_tpu_torch.ops.cuda_predict import predictive_coefficients
from mimo_tpu_torch.ops.family_estep import (
    _rows_outer, gauss_features_t, gauss_width, padded_width)
from mimo_tpu_torch.utils.linalg import inv_psd, logdet_psd
from mimo_tpu_torch.utils.stats import gammaln_diff

# kernel launches by `ilr_predict` (B5) and `ilr_p_predict` (B6)
launches = {'ilr_predict': 0, 'ilr_p_predict': 0}


def joint_features_t(xt, yt):
    """[1; x; x (x) x; y; x (x) y; y (x) y] from (d, B), (p, B) blocks,
    the joint rows of B6 (mimo_tpu's _ilr_joint_features_t)."""
    one = torch.ones((1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    return torch.cat([one, xt, _rows_outer(xt, xt), yt, _rows_outer(xt, yt),
                      _rows_outer(yt, yt)], 0)


def joint_width(d, p):
    return gauss_width(d) + p + d * p + p * p


def _pad_cols(a, m8):
    return torch.cat([a, a.new_zeros((a.shape[0], m8 - a.shape[1]))], -1)


def _weights(lw, hard):
    """(w (K, B), lse_w (B,)) of unnormalised log weights lw (K, B): the
    softmax, or the one-hot of the first-occurrence argmax when `hard`."""
    mx = torch.max(lw, 0, keepdim=True).values
    ew = torch.exp(lw - mx)
    denom = torch.sum(ew, 0, keepdim=True)
    lse_w = (mx + torch.log(denom))[0]
    if hard:
        w = torch.nn.functional.one_hot(torch.argmax(lw, 0), lw.shape[0])
        return w.T.to(lw.dtype), lse_w
    return ew * (1.0 / denom), lse_w


def _moments(w, mu, cvc):
    """(mean, var) (B,) of the mixture of experts with weights w, means mu
    and variances cvc (each (K, B)), var in the centred form sum_k w_k
    (cvc_k + (mu_k - mean)^2): E[cvc + mu^2] - mean^2 cancels down to the
    rounding of mean^2 where |mean| is large against the spread. With
    one-hot w it is the chosen expert's cvc exactly."""
    mean = torch.sum(w * mu, 0)
    return mean, torch.sum(w * (cvc + (mu - mean) ** 2), 0)


def _basis_rows(basis_post, log_w):
    """Basis quad rows (K, 1 + d + d^2) over [1; x; x (x) x] and the aux
    columns [log w + basis aux, basis h, basis 1/df] of an NIW or HierTied
    basis."""
    thq, aux = predictive_coefficients(basis_post, log_w)
    return thq[:, :gauss_width(basis_post.dim)], aux[:, :3]


def _packed(models_post, affine):
    """Tied-affine experts as their block-diagonal MNW, whose offset
    column is the affine part (mimo_tpu's `_expert_rows`)."""
    if isinstance(models_post, TiedAffine):
        return to_packed_mnw(models_post), True
    return models_post, affine


def _c_rows(models_post, affine, d):
    """c - 1 = xt' K^-1 xt as rows over [1; x; x (x) x]."""
    g = inv_psd(models_post.K_)                         # (K, q, q)
    k = g.shape[0]
    if affine:
        return torch.cat([g[:, -1, -1][:, None], 2.0 * g[:, :d, -1],
                          g[:, :d, :d].reshape(k, d * d)], -1)
    return torch.cat([g.new_zeros((k, 1 + d)), g.reshape(k, d * d)], -1)


def _mng_tail(models_post):
    """Per-output constants of MNG experts, whose predictive is a product
    of univariate t's t(y_j; mu_j, (alpha_j / beta_j) / c, 2 alpha_j):
    (y_aux_j, h_j = alpha_j + 1/2, vcoef_j = beta_j / (alpha_j - 1)), so
    that log t = y_aux_j - 1/2 log c - h_j log1p(yc_j^2 / (2 beta_j c))
    and var_j = c vcoef_j. Each (K, p)."""
    alpha, beta = models_post.alpha, models_post.beta
    y_aux = (gammaln_diff(alpha, 0.5)
             + 0.5 * (torch.log(alpha) - torch.log(beta))
             - 0.5 * (torch.log(2.0 * alpha) + math.log(math.pi)))
    return y_aux, alpha + 0.5, beta / torch.clamp(alpha - 1.0, min=1e-6)


def ilr_predict_coefficients(basis_post, models_post, log_w, affine=True):
    """(th (3K, m8), aux (K, 8)) of B5 for an NIW or HierTied basis and
    p = 1 MNW, MNG or tied-affine experts, in the posteriors' dtype: th
    rows [basis quad; c quad; expert mean] over [1; x; x (x) x]; aux cols
    [log w + basis aux, basis h, basis 1/df, var coef, psi, y_aux, y_h,
    0]. An MNG expert's univariate t maps onto the same tail with
    psi = 1 / (2 beta) and y_h = alpha + 1/2."""
    th_b, b_aux = _basis_rows(basis_post, log_w)
    k, d = th_b.shape[0], basis_post.dim
    models_post, affine = _packed(models_post, affine)
    if models_post.row_dim != 1:
        raise ValueError('B5 serves p = 1 experts; use B6 for p > 1')
    m = models_post.M
    m1 = m[:, 0, :d]
    m0 = m[:, 0, -1] if affine else m.new_zeros((k,))
    th_m = torch.cat([m0[:, None], m1, m.new_zeros((k, d * d))], -1)
    if isinstance(models_post, MNG):
        y_aux, y_h, vcoef = (t[:, 0] for t in _mng_tail(models_post))
        psi = 0.5 / models_post.beta[:, 0]
    else:
        ydf = models_post.nu                            # nu - p + 1, p = 1
        psi = models_post.psi[:, 0, 0]
        # cov = (c / df) (df / (df - 2)) psi^-1 = c psi^-1 / (df - 2)
        vcoef = (1.0 / psi) / torch.clamp(ydf - 2.0, min=1e-6)
        y_aux = (gammaln_diff(0.5 * ydf, 0.5) + 0.5 * torch.log(psi)
                 - 0.5 * math.log(math.pi))
        y_h = 0.5 * (ydf + 1.0)
    m8 = padded_width(gauss_width(d))
    th = _pad_cols(torch.cat([th_b, _c_rows(models_post, affine, d), th_m]),
                   m8)
    aux = torch.cat([b_aux, torch.stack([vcoef, psi, y_aux, y_h], -1),
                     b_aux.new_zeros((k, 1))], -1)
    return th.contiguous(), aux.contiguous()


def ilr_p_predict_coefficients(basis_post, models_post, log_w, affine=True,
                               has_y=True):
    """(th, aux (K, 8), vc) of B6 for an NIW or HierTied basis and MNW,
    MNG or tied-affine experts, in the posteriors' dtype. th rows: [basis quad (K); c quad
    (K); expert means (p K, row j K + k)] and, with y, the MVT quad
    (y - mu)' psi (y - mu) (K rows, MNW) or the scaled per-output quads
    (y_j - mu_kj)^2 / (2 beta_kj) (p K rows, j-major, MNG), over the
    joint map with y and over [1; x; x (x) x] without; the basis, c and
    mean rows are read over their Gauss-map columns only (their y
    columns are zero). aux cols [log w +
    basis aux, basis h, basis 1/df, y_aux, y_h, 0, 0, 0] (y_h = 0 for
    MNG). vc: the per-output variance coefficients (var_kj = c_k vc_kj),
    (K, p) for MNW and (K, 2p) [vcoef | h] for MNG, h_kj = alpha_kj + 1/2
    the per-output tail exponents."""
    th_b, b_aux = _basis_rows(basis_post, log_w)
    k, d = th_b.shape[0], basis_post.dim
    models_post, affine = _packed(models_post, affine)
    p = models_post.row_dim
    m = models_post.M                                   # (K, p, q)
    m1 = m[:, :, :d]                                    # (K, p, d)
    m0 = m[:, :, -1] if affine else m.new_zeros((k, p))
    th_m = torch.cat([m0.T.reshape(k * p, 1),
                      m1.transpose(0, 1).reshape(k * p, d),
                      m.new_zeros((k * p, d * d))], -1)
    diag = isinstance(models_post, MNG)
    if diag:
        y_aux_j, h, vcoef = _mng_tail(models_post)
        y_aux, y_h = torch.sum(y_aux_j, -1), torch.zeros_like(y_aux_j[:, 0])
        vc = torch.cat([vcoef, h], -1)
    else:
        ydf = models_post.nu - p + 1.0
        psi = models_post.psi
        vc = (torch.diagonal(inv_psd(psi), dim1=-2, dim2=-1)
              / torch.clamp(ydf - 2.0, min=1e-6)[:, None])
        y_aux = (gammaln_diff(0.5 * ydf, 0.5 * p) + 0.5 * logdet_psd(psi)
                 - 0.5 * p * math.log(math.pi))
        y_h = 0.5 * (ydf + p)
    m8 = padded_width(joint_width(d, p) if has_y else gauss_width(d))
    rows = [th_b, _c_rows(models_post, affine, d), th_m]
    if has_y and diag:
        # p K scaled per-output quads, j-major: r (y_j - mu_kj)^2 with
        # r = 1 / (2 beta_kj) and mu_kj = m0_kj + m1_kj . x, expanded over
        # the joint map [1; x; x (x) x; y; x (x) y; y (x) y]
        r = (0.5 / models_post.beta).T                  # (p, K)
        m1j, m0j = m1.transpose(0, 1), m0.T             # (p, K, d), (p, K)
        eye = torch.eye(p, dtype=m.dtype, device=m.device)
        xy = (m1j[:, :, :, None] * eye[:, None, None, :]).reshape(p, k, d * p)
        yy = (eye[:, :, None] * eye[:, None, :]).reshape(p, 1, p * p)
        rows.append(torch.cat([
            (r * m0j * m0j)[:, :, None],                            # 1
            2.0 * (r * m0j)[:, :, None] * m1j,                      # x
            r[:, :, None] * (m1j[:, :, :, None] * m1j[:, :, None, :]
                             ).reshape(p, k, d * d),                # x (x) x
            -2.0 * (r * m0j)[:, :, None] * eye[:, None, :],         # y
            -2.0 * r[:, :, None] * xy,                              # x (x) y
            r[:, :, None] * yy.expand(p, k, p * p),                 # y (x) y
        ], -1).reshape(p * k, -1))
    elif has_y:
        pm1 = torch.einsum('kpr,krd->kpd', psi, m1)     # psi M1
        pm0 = torch.einsum('kpr,kr->kp', psi, m0)       # psi m0
        rows.append(torch.cat([
            torch.einsum('kp,kp->k', m0, pm0)[:, None],             # 1
            2.0 * torch.einsum('kp,kpd->kd', m0, pm1),              # x
            torch.einsum('kpd,kpe->kde', m1, pm1).reshape(k, d * d),
            -2.0 * pm0,                                             # y
            -2.0 * pm1.transpose(1, 2).reshape(k, d * p),           # x (x) y
            psi.reshape(k, p * p)], -1))                            # y (x) y
    th = torch.cat([_pad_cols(t, m8) for t in rows])
    aux = torch.cat([b_aux, torch.stack([y_aux, y_h], -1),
                     b_aux.new_zeros((k, 3))], -1)
    return th.contiguous(), aux.contiguous(), vc.contiguous()


# -- B5 -------------------------------------------------------------------------

def ilr_predict_plain(xt, th, aux, n, has_y, hard):
    """Plain PyTorch version of B5: xt (d + has_y, >=n), th (3K, m8),
    aux (K, 8) -> out (4, n) rows [mean, var, nlpd, lse_w] (nlpd = 0
    without y)."""
    k, m8 = aux.shape[0], th.shape[1]
    d = xt.shape[0] - int(has_y)
    out = torch.zeros((4, n), dtype=th.dtype, device=th.device)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        z = th @ assemble_features(xt[:d, s:e], m8)
        qb = torch.clamp(z[:k], min=0.0)
        c = 1.0 + torch.clamp(z[k:2 * k], min=0.0)
        mu = z[2 * k:]
        lw = aux[:, 0:1] - aux[:, 1:2] * torch.log1p(qb * aux[:, 2:3])
        w, lse_w = _weights(lw, hard)
        out[0, s:e], out[1, s:e] = _moments(w, mu, c * aux[:, 3:4])
        out[3, s:e] = lse_w
        if has_y:
            yc = xt[d:d + 1, s:e] - mu
            lp_y = (aux[:, 5:6] - 0.5 * torch.log(c) - aux[:, 6:7]
                    * torch.log1p(aux[:, 4:5] * yc * yc * (1.0 / c)))
            out[2, s:e] = -(torch.logsumexp(lp_y + lw, 0) - lse_w)
    return out


def ilr_predict(xt, th, aux, n, has_y, hard):
    """B5 over points 0..n-1 of xt (d + has_y, >=n): x rows, then y.
    Launches the kernel for CUDA tensors (float32 only; it raises on
    anything it does not take) and runs `ilr_predict_plain` for CPU
    tensors. Returns out (4, n)."""
    if not xt.is_cuda:
        return ilr_predict_plain(xt, th, aux, n, has_y, hard)
    lib = _build.load()
    k, m8 = aux.shape[0], th.shape[1]
    d = xt.shape[0] - int(has_y)
    _check_rows('cuda_ilr_predict', th, 3 * k, aux, xt)
    _build.check_serving('cuda_ilr_predict', xt, n, th, gauss_width(d),
                         f'gauss map, d={d}', aux)
    out = torch.empty((4, n), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_ilr_predict(xt.data_ptr(), xt.stride(0), d,
                                  int(has_y), n, th.data_ptr(), k, m8,
                                  aux.data_ptr(), int(hard), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_ilr_predict')
    launches['ilr_predict'] += 1
    return out


# -- B6 -------------------------------------------------------------------------

def ilr_p_predict_plain(xt, th, aux, vc, n, p, has_y, hard):
    """Plain PyTorch version of B6: xt (d + has_y p, >=n), th (see
    `ilr_p_predict_coefficients`; its basis, c and mean rows read their
    first 1 + d + d^2 columns, the Gauss map, and its quad rows the joint
    map), aux (K, 8), vc (K, p), or (K, 2p) for MNG experts -> out
    (2p + 2, n) rows [mean (p), var (p), nlpd, lse_w] (nlpd = 0 without
    y)."""
    k, m8 = aux.shape[0], th.shape[1]
    d = xt.shape[0] - (p if has_y else 0)
    mg, rx = gauss_width(d), (2 + p) * k
    out = torch.zeros((2 * p + 2, n), dtype=th.dtype, device=th.device)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        xb = xt[:d, s:e]
        z = th[:rx, :mg] @ gauss_features_t((xb,))
        if has_y:
            zq = th[rx:] @ pad_rows(joint_features_t(xb, xt[d:, s:e]), m8)
        qb = torch.clamp(z[:k], min=0.0)
        c = 1.0 + torch.clamp(z[k:2 * k], min=0.0)
        lw = aux[:, 0:1] - aux[:, 1:2] * torch.log1p(qb * aux[:, 2:3])
        w, lse_w = _weights(lw, hard)
        for j in range(p):
            out[j, s:e], out[p + j, s:e] = _moments(
                w, z[(2 + j) * k:(3 + j) * k], c * vc[:, j:j + 1])
        out[2 * p + 1, s:e] = lse_w
        if has_y:
            inv_c = 1.0 / c
            if vc.shape[1] == 2 * p:    # MNG: product of per-output tails
                tail = sum(vc[:, p + j:p + j + 1] * torch.log1p(
                    torch.clamp(zq[j * k:(j + 1) * k], min=0.0) * inv_c)
                    for j in range(p))
            else:
                tail = aux[:, 4:5] * torch.log1p(torch.clamp(zq, min=0.0)
                                                 * inv_c)
            lp_y = aux[:, 3:4] - 0.5 * p * torch.log(c) - tail
            out[2 * p, s:e] = -(torch.logsumexp(lp_y + lw, 0) - lse_w)
    return out


def p_predict_rows(k, p, has_y, diag):
    """Coefficient rows of B6: basis quad, c quad and p mean rows per
    component, then with y one MVT quad (MNW) or p scaled quads (MNG)."""
    return (2 + p + ((p if diag else 1) if has_y else 0)) * k


def ilr_p_predict(xt, th, aux, vc, n, p, has_y, hard):
    """B6 over points 0..n-1 of xt (d + has_y p, >=n): x rows, then the
    p y rows. vc (K, 2p) selects the MNG tail. Launches the kernel for
    CUDA tensors (float32 only; it raises on anything it does not take)
    and runs `ilr_p_predict_plain` for CPU tensors. Returns out
    (2p + 2, n)."""
    if not xt.is_cuda:
        return ilr_p_predict_plain(xt, th, aux, vc, n, p, has_y, hard)
    lib = _build.load()
    k, m8 = aux.shape[0], th.shape[1]
    d = xt.shape[0] - (p if has_y else 0)
    diag = vc.shape[-1] == 2 * p
    width, desc = ((joint_width(d, p), f'joint map, d={d}, p={p}') if has_y
                   else (gauss_width(d), f'gauss map, d={d}'))
    _check_rows('cuda_ilr_p_predict', th, p_predict_rows(k, p, has_y, diag),
                aux, xt)
    _build.check_serving('cuda_ilr_p_predict', xt, n, th, width, desc, aux)
    if (vc.dtype != torch.float32 or vc.shape not in ((k, p), (k, 2 * p))
            or not vc.is_contiguous() or vc.device != xt.device):
        raise ValueError('cuda_ilr_p_predict: vc must be a contiguous '
                         "(K, p) or (K, 2p) float32 tensor on the data's "
                         'device')
    out = torch.empty((2 * p + 2, n), dtype=torch.float32, device=xt.device)
    # the runtime-width kernel keeps each point's reference means here
    refs = torch.empty((p, n), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_ilr_p_predict(xt.data_ptr(), xt.stride(0), d, p,
                                    int(has_y), int(diag), n, th.data_ptr(),
                                    k, m8,
                                    aux.data_ptr(), vc.data_ptr(), int(hard),
                                    out.data_ptr(), refs.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_ilr_p_predict')
    launches['ilr_p_predict'] += 1
    return out


def _check_rows(what, th, rows, aux, xt):
    if th.shape[0] != rows:
        raise ValueError(f'{what}: {th.shape[0]} coefficient rows, the '
                         f'kernel reads {rows}')
    if (aux.dtype != torch.float32 or aux.shape[1] != 8
            or not aux.is_contiguous() or aux.device != xt.device):
        raise ValueError(f'{what}: aux must be a contiguous (K, 8) float32 '
                         "tensor on the data's device")


# -- spec-level entries -----------------------------------------------------------

def _serving_xt(x, y):
    """The kernels' layout: [x rows; y rows] as one float32 (d [+ p], N)."""
    return torch.cat([a.to(torch.float32).T for a in (x, y)
                      if a is not None]).contiguous()


def ilr_predict_cuda(basis_post, models_post, log_w, x, y=None, affine=True,
                     prediction='average'):
    """Fused ILR posterior-predictive regression for p = 1 experts through
    B5, the counterpart of mimo_tpu's ilr_predict_pallas, in standardized
    units. x (N, d), y (N, 1) or None. Returns (mean (N,), var (N,),
    nlpd (N,) or None), in float32."""
    return ilr_predict_cuda_sharded(basis_post, models_post, log_w, [x],
                                    None if y is None else [y], affine,
                                    prediction)[0]


def ilr_predict_cuda_sharded(basis_post, models_post, log_w, xs, ys=None,
                             affine=True, prediction='average'):
    """ilr_predict_cuda over the shards of a mesh (xs, ys: one (n_j, d),
    (n_j, 1) tensor a shard, each on its device; ys None without y): the
    coefficients built once, B5 once per non-empty shard on its device,
    no collective. Returns one (mean, var, nlpd or None) a shard."""
    th, aux = ilr_predict_coefficients(basis_post, models_post, log_w,
                                       affine)
    th, aux = th.to(torch.float32), aux.to(torch.float32)
    out = []
    for j, x in enumerate(xs):
        y = None if ys is None else ys[j]
        dev = x.device
        o = (ilr_predict(_serving_xt(x, y), th.to(dev), aux.to(dev),
                         x.shape[0], y is not None, prediction == 'mode')
             if x.shape[0] else
             torch.empty((4, 0), dtype=torch.float32, device=dev))
        out.append((o[0], o[1], o[2] if y is not None else None))
    return out


def ilr_p_predict_cuda(basis_post, models_post, log_w, x, y=None,
                       affine=True, prediction='average'):
    """p > 1 fused ILR serving through B6 (MNW, MNG or tied-affine
    experts), the
    counterpart of mimo_tpu's _ilr_p_predict_pallas. Returns
    (mean (N, p), var (N, p), nlpd (N,) or None), in float32."""
    return ilr_p_predict_cuda_sharded(basis_post, models_post, log_w, [x],
                                      None if y is None else [y], affine,
                                      prediction)[0]


def ilr_p_predict_cuda_sharded(basis_post, models_post, log_w, xs, ys=None,
                               affine=True, prediction='average'):
    """ilr_p_predict_cuda over the shards of a mesh (see
    ilr_predict_cuda_sharded): B6 once per non-empty shard, no
    collective. Returns one (mean (n_j, p), var (n_j, p), nlpd or None)
    a shard."""
    p = models_post.row_dim
    th, aux, vc = ilr_p_predict_coefficients(basis_post, models_post, log_w,
                                             affine, ys is not None)
    th, aux, vc = (t.to(torch.float32) for t in (th, aux, vc))
    out = []
    for j, x in enumerate(xs):
        y = None if ys is None else ys[j]
        dev = x.device
        o = (ilr_p_predict(_serving_xt(x, y), th.to(dev), aux.to(dev),
                           vc.to(dev), x.shape[0], p, y is not None,
                           prediction == 'mode')
             if x.shape[0] else
             torch.empty((2 * p + 2, 0), dtype=torch.float32, device=dev))
        out.append((o[:p].T, o[p:2 * p].T,
                    o[2 * p] if y is not None else None))
    return out
