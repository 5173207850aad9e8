"""Standalone exponential-family densities (port of
mimo_tpu/distributions/extra.py): Wishart / Inverse-Wishart, Gamma /
Inverse-Gamma and Matrix-Normal log-densities and samplers, and the
covariance-parameterized Gaussian.

The inference paths use the conjugate composites (niw/ng/mnw/mng); these
functions are for direct density evaluation and priors over covariances.
All batched over leading axes. The samplers take a `torch.Generator` on
the parameters' device where the JAX package takes a key.
"""

import math

import torch

from mimo_tpu_torch.distributions.wishart import (
    gamma_sample as _standard_gamma, wishart_log_partition, wishart_sample)
from mimo_tpu_torch.utils.linalg import (
    cholesky, chol_logdet, inv_psd, mvgammaln, solve_psd)
from mimo_tpu_torch.utils.stats import LOG2PI, mvn_logpdf


# -- Wishart / Inverse-Wishart ------------------------------------------------

def wishart_logpdf(x, psi, nu):
    """log W(X | psi, nu), E[X] = nu psi."""
    d = psi.shape[-1]
    logdet_x = chol_logdet(cholesky(x))
    tr = torch.diagonal(solve_psd(psi, x), dim1=-2, dim2=-1).sum(-1)
    return (0.5 * (nu - d - 1.0) * logdet_x - 0.5 * tr
            - wishart_log_partition(cholesky(psi), nu))


def inverse_wishart_sample(gen, psi, nu):
    """Sigma ~ IW(psi, nu): the inverse of a Wishart draw with inverted
    scale (E[Sigma] = psi / (nu - d - 1))."""
    return inv_psd(wishart_sample(gen, inv_psd(psi), nu))


def inverse_wishart_logpdf(x, psi, nu):
    """log IW(X | psi, nu)."""
    d = psi.shape[-1]
    logdet_x = chol_logdet(cholesky(x))
    logdet_psi = chol_logdet(cholesky(psi))
    tr = torch.diagonal(solve_psd(x, psi), dim1=-2, dim2=-1).sum(-1)
    log_z = (0.5 * nu * d * math.log(2.0) + mvgammaln(0.5 * nu, d)
             - 0.5 * nu * logdet_psi)
    return -0.5 * (nu + d + 1.0) * logdet_x - 0.5 * tr - log_z


def inverse_wishart_mean(psi, nu):
    d = psi.shape[-1]
    return psi / (nu - d - 1.0)[..., None, None]


# -- Gamma / Inverse-Gamma (rate parameterization) ---------------------------

def gamma_logpdf(x, alpha, beta):
    """log Gamma(x | alpha, beta) with rate beta, elementwise."""
    return (alpha * torch.log(beta) - torch.lgamma(alpha)
            + (alpha - 1.0) * torch.log(x) - beta * x)


def gamma_sample(gen, alpha, beta):
    return _standard_gamma(gen, alpha) / beta


def inverse_gamma_logpdf(x, alpha, beta):
    """log IG(x | alpha, beta), elementwise."""
    return (alpha * torch.log(beta) - torch.lgamma(alpha)
            - (alpha + 1.0) * torch.log(x) - beta / x)


def inverse_gamma_sample(gen, alpha, beta):
    return beta / _standard_gamma(gen, alpha)


# -- Matrix-Normal ------------------------------------------------------------

def matrix_normal_logpdf(a, m, v, k):
    """log MN(A | M, V^{-1} (rows), K^{-1} (columns)) in the precision
    parameterization: vec(A) ~ N(vec(M), (K (x) V)^{-1});
    logpdf = -p q/2 log 2pi + q/2 logdet V + p/2 logdet K
             - 1/2 tr[K (A-M)' V (A-M)]."""
    p, q = a.shape[-2], a.shape[-1]
    da = a - m
    quad = torch.einsum('...pq,...pr,...rs,...sq->...', k,
                        da.transpose(-1, -2), v, da)
    logdet_v = chol_logdet(cholesky(v))
    logdet_k = chol_logdet(cholesky(k))
    return (-0.5 * p * q * LOG2PI + 0.5 * q * logdet_v
            + 0.5 * p * logdet_k - 0.5 * quad)


def matrix_normal_sample(gen, m, v, k):
    """A ~ MN(M, V^{-1}, K^{-1}): A = M + chol(V)^{-T} Z chol(K)^{-1}."""
    lv = cholesky(v)
    lk = cholesky(k)
    z = torch.randn(m.shape, generator=gen, dtype=m.dtype, device=m.device)
    u = torch.linalg.solve_triangular(lv.transpose(-1, -2), z, upper=True)
    # column covariance K^{-1} = Lk^{-T} Lk^{-1}: solve against Lk^T
    return m + torch.linalg.solve_triangular(
        lk.transpose(-1, -2), u.transpose(-1, -2),
        upper=True).transpose(-1, -2)


# -- covariance-parameterized Gaussian ----------------------------------------

def gaussian_cov_logpdf(x, mu, sigma):
    """log N(x | mu, Sigma) with covariance parameterization; x (N, d),
    mu (K, d), sigma (K, d, d) -> (N, K)."""
    return mvn_logpdf(x, mu, inv_psd(sigma))
