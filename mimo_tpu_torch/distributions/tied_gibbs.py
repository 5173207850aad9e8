"""Exact blocked-Gibbs draws for scale-tied conjugate families (port of
mimo_tpu/distributions/tied_gibbs.py).

The tied models are fully conjugate, so p(params | labels, data) has a
closed form drawn in one ancestral pass: complete the square in each
component's location (mean, or regression matrix), which leaves a pure
Wishart (or, per dimension, Gamma) in the shared scale; draw the scale
once, then each location given it.

  tied Gaussian   psi'^{-1} = psi0^{-1} + sum_k [S_k - s_k s_k^T / n_k
                    + (kappa_k n_k / kappa'_k)(xbar_k - m_k)(.)^T],
                  nu' = nu0 + N
  tied linear     psi'^{-1} = psi0^{-1} + sum_k [Syy_k + M_k K_k M_k^T
                    - M'_k K'_k M'_k^T],  nu' = nu0 + N
  diagonal        Gamma(alpha0 + N/2, beta0 + residual/2) per dimension

Empty components: the Gaussian draws form xbar_k = s_k / max(n_k, 1) and
the scatter with s_k s_k^T / max(n_k, 1). Gibbs counts are whole numbers,
so this is the reference's formula wherever n_k >= 1 and 0 for an empty
component; the reference divides by max(n_k, 1e-12), which turns an empty
component with s_k != 0 into 0 * inf = NaN in float32 (ROADMAP §C).

Every draw takes an explicit `torch.Generator` on the tensors' device and
returns (posterior, params): the posterior carries the exact conditional
(per-component locations, the shared scale broadcast over K).
"""

import torch

from mimo_tpu_torch.distributions.mng import MNG, DiagLinGaussParams
from mimo_tpu_torch.distributions.mnw import (
    MNW, LinGaussParams, _t, column_solve, matrix_normal_draw)
from mimo_tpu_torch.distributions.ng import NG, DiagGaussParams
from mimo_tpu_torch.distributions.niw import (
    NIW, GaussParams, scaled_normal_draw)
from mimo_tpu_torch.distributions.wishart import gamma_sample, wishart_sample
from mimo_tpu_torch.utils.linalg import (
    cholesky, inv_psd, solve_psd, symmetrize)


def _randn(gen, like):
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def tied_niw_gibbs(gen, prior: NIW, stats):
    """Exact tied-Gaussian blocked draw. The prior's psi and nu are the
    same for every component (the tied priors are built so)."""
    kk, d = prior.mu.shape
    n = stats.n1
    kappa_n = prior.kappa + n
    mu_n = (prior.kappa[:, None] * prior.mu + stats.x) / kappa_n[:, None]
    n_div = torch.clamp(n, min=1.0)
    xbar = stats.x / n_div[:, None]
    scatter = stats.xxT - (stats.x[:, :, None] * stats.x[:, None, :]
                           / n_div[:, None, None])
    dm = xbar - prior.mu
    coef = prior.kappa * n / kappa_n
    psi_inv = (inv_psd(prior.psi[:1])[0] + torch.sum(scatter, 0)
               + torch.einsum('k,kd,ke->de', coef, dm, dm))
    psi_n = inv_psd(symmetrize(psi_inv)[None])              # (1, d, d)
    nu_n = prior.nu[:1] + torch.sum(stats.n2)               # (1,)
    lmbda = wishart_sample(gen, psi_n, nu_n).expand(kk, d, d)
    mus = scaled_normal_draw(gen, mu_n, kappa_n, cholesky(lmbda))
    post = NIW(mu=mu_n, kappa=kappa_n, psi=psi_n.expand(kk, d, d),
               nu=nu_n.expand(kk))
    return post, GaussParams(mu=mus, lmbda=lmbda)


def tied_ng_gibbs(gen, prior: NG, stats):
    """Exact tied-diagonal-Gaussian blocked draw (one shared lambda)."""
    kk, d = prior.mu.shape
    n = stats.n1[:, None]
    kappa_n = prior.kappa + n
    mu_n = (prior.kappa * prior.mu + stats.x) / kappa_n
    n_div = torch.clamp(n, min=1.0)
    xbar = stats.x / n_div
    scatter = stats.xsq - torch.square(stats.x) / n_div
    coef = prior.kappa * n / kappa_n
    beta_n = prior.beta[:1] + 0.5 * torch.sum(
        scatter + coef * torch.square(xbar - prior.mu), 0, keepdim=True)
    alpha_n = prior.alpha[:1] + 0.5 * torch.sum(stats.n1)   # (1, d)
    lam = (gamma_sample(gen, alpha_n) / beta_n).expand(kk, d)
    mus = mu_n + _randn(gen, mu_n) / torch.sqrt(kappa_n * lam)
    post = NG(mu=mu_n, kappa=kappa_n, alpha=alpha_n.expand(kk, d),
              beta=beta_n.expand(kk, d))
    return post, DiagGaussParams(mu=mus, lmbda_diag=lam)


def _linear_posterior(prior, stats):
    """K' = K + Sxx, M' = (M K + Syx) K'^{-1} and the residual
    Syy + M K M^T - M' K' M'^T of the linear families."""
    k_n = prior.K_ + stats.xxT
    m_n = _t(solve_psd(k_n, _t(prior.M @ prior.K_ + stats.yxT)))
    resid = (stats.yyT + prior.M @ prior.K_ @ _t(prior.M)
             - m_n @ k_n @ _t(m_n))
    return k_n, m_n, resid


def tied_mnw_gibbs(gen, prior: MNW, stats):
    """Exact tied-linear-Gaussian blocked draw (one shared noise Lambda)."""
    kk, p, _ = prior.M.shape
    k_n, m_n, resid = _linear_posterior(prior, stats)
    psi_inv = inv_psd(prior.psi[:1])[0] + torch.sum(resid, 0)
    psi_n = inv_psd(symmetrize(psi_inv)[None])              # (1, p, p)
    nu_n = prior.nu[:1] + torch.sum(stats.n)
    lmbda = wishart_sample(gen, psi_n, nu_n).expand(kk, p, p)
    a_s = matrix_normal_draw(gen, m_n, cholesky(lmbda), cholesky(k_n))
    post = MNW(M=m_n, K_=k_n, psi=psi_n.expand(kk, p, p),
               nu=nu_n.expand(kk))
    return post, LinGaussParams(A=a_s, lmbda=lmbda)


def tied_mng_gibbs(gen, prior: MNG, stats):
    """Exact tied-diagonal-noise linear-Gaussian blocked draw."""
    kk, p, _ = prior.M.shape
    k_n, m_n, resid = _linear_posterior(prior, stats)
    beta_n = prior.beta[:1] + 0.5 * torch.sum(
        torch.diagonal(resid, dim1=-2, dim2=-1), 0, keepdim=True)
    alpha_n = prior.alpha[:1] + 0.5 * torch.sum(stats.n)    # (1, p)
    lam = (gamma_sample(gen, alpha_n) / beta_n).expand(kk, p)
    # row i of A has covariance lam_i^{-1} K'^{-1}
    u = _randn(gen, m_n) / torch.sqrt(lam)[..., None]
    post = MNG(M=m_n, K_=k_n, alpha=alpha_n.expand(kk, p),
               beta=beta_n.expand(kk, p))
    return post, DiagLinGaussParams(A=m_n + column_solve(cholesky(k_n), u),
                                    lmbda_diag=lam)


_TIED_GIBBS = {NIW: tied_niw_gibbs, NG: tied_ng_gibbs,
               MNW: tied_mnw_gibbs, MNG: tied_mng_gibbs}


def tied_gibbs_update(gen, prior, stats):
    """Dispatch the exact tied blocked draw on the prior's type."""
    fn = _TIED_GIBBS.get(type(prior))
    if fn is None:
        raise TypeError(f'no exact tied Gibbs for {type(prior).__name__}')
    return fn(gen, prior, stats)
