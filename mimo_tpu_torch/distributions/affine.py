"""Tied-affine linear-Gaussian experts: K experts share one slope A and
one noise precision Lambda, each with its own offset c_k (port of
mimo_tpu/distributions/affine.py; `svi_blend` raises in the reference
too, and the inner-chain `gibbs_update`, which no family uses, is not
ported).

Model:  Lambda ~ W(psi0, nu0);  A | Lambda ~ MN(M0, Lambda^{-1}, K0^{-1});
        c_k | Lambda ~ N(mu0_k, (kappa0_k Lambda)^{-1});
        y | x, z=k ~ N(A x + c_k, Lambda^{-1}).

The posterior has no K axis on M (p, q), K_ (q, q), psi (p, p) or nu ().
Expectations, the ELBO terms and the predictives repack it into a stacked
MNW over the augmented input [x; 1] (`to_packed_mnw`): M_k = [A | c_k],
K_k = blockdiag(K_slope, kappa_k).
"""

from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions.mnw import (
    MNW, LinGaussParams, _t, matrix_normal_draw)
from mimo_tpu_torch.distributions.niw import scaled_normal_draw
from mimo_tpu_torch.distributions.wishart import wishart_sample
from mimo_tpu_torch.utils.linalg import (
    cholesky, inv_psd, solve_psd, symmetrize)


class TiedAffine(NamedTuple):
    """Prior or posterior of the tied-affine expert family."""
    M: torch.Tensor        # (p, q) shared slope mean
    K_: torch.Tensor       # (q, q) shared slope column precision
    mus: torch.Tensor      # (K, p) offset means
    kappas: torch.Tensor   # (K,) offset precision coefficients
    psi: torch.Tensor      # (p, p) shared Wishart scale
    nu: torch.Tensor       # () shared Wishart dof

    @property
    def size(self):
        return self.mus.shape[0]

    @property
    def row_dim(self):
        return self.M.shape[-2]

    @property
    def col_dim(self):
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, kappa=1e-2,
                 psi_scale=1.0, nu=None, dtype=torch.float32, device=None):
        kw = dict(dtype=dtype, device=device)
        nu = float(row_dim + 2) if nu is None else nu
        return TiedAffine(
            M=torch.zeros((row_dim, col_dim), **kw),
            K_=K_scale * torch.eye(col_dim, **kw),
            mus=torch.zeros((size, row_dim), **kw),
            kappas=torch.full((size,), kappa, **kw),
            psi=psi_scale * torch.eye(row_dim, **kw),
            nu=torch.tensor(nu, **kw))


class AffineStats(NamedTuple):
    """Weighted affine linear-Gaussian statistics."""
    ym: torch.Tensor    # (K, p)    sum w y
    xm: torch.Tensor    # (K, q)    sum w x
    yxT: torch.Tensor   # (K, p, q)
    xxT: torch.Tensor   # (K, q, q)
    yyT: torch.Tensor   # (K, p, p)
    n: torch.Tensor     # (K,)


def suff_stats(x, y, resp):
    """x (N, q) raw (the offset is explicit, no ones column), y (N, p),
    resp (N, K)."""
    lg = _mnw.suff_stats(x, y, resp)
    return AffineStats(ym=resp.T @ y, xm=resp.T @ x, yxT=lg.yxT, xxT=lg.xxT,
                       yyT=lg.yyT, n=lg.n)


def _slope_precision_mstep(prior: TiedAffine, stats: AffineStats, cs):
    """The reference's K-averaged slope and precision updates given the
    current offsets cs, over K."""
    k = cs.shape[0]
    num = ((prior.M @ prior.K_)[None] + stats.yxT
           - cs[:, :, None] * stats.xm[:, None, :])         # (K, p, q)
    kk = prior.K_[None] + stats.xxT                         # (K, q, q)
    num_kinv = _t(solve_psd(kk, _t(num)))
    m_new = torch.sum(num_kinv, 0) / k
    k_new = torch.sum(kk, 0) / k
    # sum_n w (y - c_k)(y - c_k)^T = yyT - y c^T - c y^T + n c c^T
    yc = stats.ym[:, :, None] * cs[:, None, :]
    resid = (stats.yyT - yc - _t(yc)
             + stats.n[:, None, None] * (cs[:, :, None] * cs[:, None, :]))
    dm = cs - prior.mus
    spread = torch.einsum('k,kp,kr->pr', prior.kappas, dm, dm)
    quad = torch.sum(num_kinv @ _t(num), 0)
    psi_inv = (inv_psd(prior.psi[None])[0] + prior.M @ k_new @ prior.M.T
               + (torch.sum(resid, 0) + spread - quad) / k)
    psi_new = inv_psd(symmetrize(psi_inv)[None])[0]
    nu_new = torch.sum(prior.nu + stats.n + 1.0) / k
    return m_new, k_new, psi_new, nu_new


def posterior_update(prior: TiedAffine, stats: AffineStats,
                     nb_iter: int = 25) -> TiedAffine:
    """Inner mean-field coordinate ascent: `nb_iter` rounds of the slope
    and precision m-step given the offsets, then the offset e-step with
    the slope posterior mean. The first round starts from the prior's
    offsets."""
    kappas_n = prior.kappas + stats.n
    post = prior
    for _ in range(nb_iter):
        m_n, k_n, psi_n, nu_n = _slope_precision_mstep(prior, stats,
                                                       post.mus)
        rhos = (prior.kappas[:, None] * prior.mus + stats.ym
                - stats.xm @ m_n.T) / kappas_n[:, None]
        post = TiedAffine(M=m_n, K_=k_n, mus=rhos, kappas=kappas_n,
                          psi=psi_n, nu=nu_n)
    return post


def gibbs_update_exact(gen, prior: TiedAffine, stats: AffineStats):
    """The exact one-shot blocked draw from p(Lambda, A, c_{1:K} | labels,
    data): completing the square in each offset, then in the shared
    slope, leaves a pure Wishart,

      s_k = 1/(kappa_k + n_k);  b_k = kappa_k mu0_k + Sy_k;  v_k = Sx_k
      K'  = K0 + sum_k (Sxx_k - s_k v_k v_k^T)
      M'  = [M0 K0 + sum_k (Syx_k - s_k b_k v_k^T)] K'^{-1}
      psi'^{-1} = Psi0^{-1} + M0 K0 M0^T - M' K' M'^T
                  + sum_k (Syy_k + kappa_k mu0_k mu0_k^T - s_k b_k b_k^T)
      nu' = nu0 + N,

    then Lambda ~ W(psi', nu'), A | Lambda ~ MN(M', Lambda^{-1}, K'^{-1})
    and c_k | A, Lambda ~ N(s_k (b_k - A v_k), ((kappa_k + n_k)
    Lambda)^{-1}). Returns (posterior, LinGaussParams packed [A | c_k])."""
    k = prior.size
    p, q = prior.M.shape
    kappas_n = prior.kappas + stats.n
    s = 1.0 / kappas_n
    b = prior.kappas[:, None] * prior.mus + stats.ym        # (K, p)
    v = stats.xm                                            # (K, q)

    k_n = prior.K_ + torch.sum(
        stats.xxT - s[:, None, None] * (v[:, :, None] * v[:, None, :]), 0)
    mk = prior.M @ prior.K_ + torch.sum(
        stats.yxT - s[:, None, None] * (b[:, :, None] * v[:, None, :]), 0)
    m_n = _t(solve_psd(k_n[None], _t(mk[None])))[0]         # (p, q)
    psi_inv = (inv_psd(prior.psi[None])[0]
               + prior.M @ prior.K_ @ prior.M.T - m_n @ k_n @ m_n.T
               + torch.sum(stats.yyT
                           + prior.kappas[:, None, None]
                           * (prior.mus[:, :, None] * prior.mus[:, None, :])
                           - s[:, None, None] * (b[:, :, None]
                                                 * b[:, None, :]), 0))
    psi_n = inv_psd(symmetrize(psi_inv)[None])              # (1, p, p)
    nu_n = (prior.nu + torch.sum(stats.n))[None]            # (1,)

    lmbda1 = wishart_sample(gen, psi_n, nu_n)               # (1, p, p)
    chol1 = cholesky(lmbda1)
    a_draw = matrix_normal_draw(gen, m_n[None], chol1,
                                cholesky(k_n[None]))[0]     # (p, q)
    cs = scaled_normal_draw(gen, s[:, None] * (b - v @ a_draw.T), kappas_n,
                            chol1)
    post = TiedAffine(M=m_n, K_=k_n, mus=s[:, None] * (b - v @ m_n.T),
                      kappas=kappas_n, psi=psi_n[0], nu=nu_n[0])
    packed_a = torch.cat([a_draw.expand(k, p, q), cs[:, :, None]], -1)
    return post, LinGaussParams(A=packed_a, lmbda=lmbda1.expand(k, p, p))


def to_packed_mnw(p: TiedAffine) -> MNW:
    """Per component k: M_k = [M | mu_k], K_k = blockdiag(K_slope,
    kappa_k), the shared psi and nu broadcast over K."""
    k = p.size
    pd, q = p.M.shape
    m = torch.cat([p.M.expand(k, pd, q), p.mus[:, :, None]], -1)
    k_full = p.K_.new_zeros((k, q + 1, q + 1))
    k_full[:, :q, :q] = p.K_
    k_full[:, q, q] = p.kappas
    return MNW(M=m, K_=k_full, psi=p.psi.expand(k, pd, pd),
               nu=p.nu.expand(k))


def expected_log_likelihood(p: TiedAffine, x_aug, y):
    return _mnw.expected_log_likelihood(to_packed_mnw(p), x_aug, y)


def kl_divergence(q: TiedAffine, p: TiedAffine):
    return _mnw.kl_divergence(to_packed_mnw(q), to_packed_mnw(p))


def sample_params(gen, p: TiedAffine) -> LinGaussParams:
    return _mnw.sample_params(gen, to_packed_mnw(p))


def mode_params(p: TiedAffine) -> LinGaussParams:
    return _mnw.mode_params(to_packed_mnw(p))


def mean_params(p: TiedAffine) -> LinGaussParams:
    return _mnw.mean_params(to_packed_mnw(p))


def log_likelihood(params: LinGaussParams, x_aug, y):
    return _mnw.log_likelihood(params, x_aug, y)


def log_predictive_studentt(p: TiedAffine, x_aug, y):
    return _mnw.log_predictive_studentt(to_packed_mnw(p), x_aug, y)


def log_predictive_gaussian(p: TiedAffine, x_aug, y):
    return _mnw.log_predictive_gaussian(to_packed_mnw(p), x_aug, y)
