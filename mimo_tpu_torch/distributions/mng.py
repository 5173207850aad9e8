"""Matrix-Normal-Gamma conjugate family: linear experts with diagonal
noise (port of mimo_tpu/distributions/mng.py).

Model (per expert k, output row i): lambda_ki ~ Gamma(alpha_ki, beta_ki),
row a_ki | lambda_ki ~ N(M_ki, lambda_ki^{-1} K_k^{-1});
likelihood y_i ~ N(a_ki . xt, lambda_ki^{-1}). The column precision K is
shared across output rows; alphas and betas are per row. The statistics
are MNW's `LinGaussStats`.
"""

import math
from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions.mnw import LinGaussStats
from mimo_tpu_torch.distributions.mnw import _outer_rows, _t, column_solve
from mimo_tpu_torch.distributions.wishart import gamma_sample
from mimo_tpu_torch.utils.linalg import (
    cholesky, chol_logdet, inv_psd, quad_form, solve_psd,
)
from mimo_tpu_torch.utils.stats import LOG2PI, gammaln_diff


class MNG(NamedTuple):
    M: torch.Tensor      # (K, p, q)
    K_: torch.Tensor     # (K, q, q) shared column precision
    alpha: torch.Tensor  # (K, p)
    beta: torch.Tensor   # (K, p)

    @property
    def row_dim(self):
        return self.M.shape[-2]

    @property
    def col_dim(self):
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, alpha=2.0, beta=1.0,
                 dtype=torch.float32, device=None):
        kw = dict(dtype=dtype, device=device)
        return MNG(
            M=torch.zeros((size, row_dim, col_dim), **kw),
            K_=(K_scale * torch.eye(col_dim, **kw)).expand(
                size, col_dim, col_dim).clone(),
            alpha=torch.full((size, row_dim), alpha, **kw),
            beta=torch.full((size, row_dim), beta, **kw),
        )


class DiagLinGaussParams(NamedTuple):
    A: torch.Tensor           # (K, p, q)
    lmbda_diag: torch.Tensor  # (K, p)


def _diag(a):
    return torch.diagonal(a, dim1=-2, dim2=-1)


def posterior_update(prior: MNG, stats: LinGaussStats) -> MNG:
    """K' = K + Sxx;  M' = (M K + Syx) K'^{-1};  alpha' = alpha + n/2;
    beta'_i = beta_i + 1/2 [Syy + M K M^T - M' K' M'^T]_ii."""
    k_n = prior.K_ + stats.xxT
    mk = prior.M @ prior.K_ + stats.yxT
    m_n = _t(solve_psd(k_n, _t(mk)))
    resid = (stats.yyT + prior.M @ prior.K_ @ _t(prior.M)
             - m_n @ k_n @ _t(m_n))
    return MNG(M=m_n, K_=k_n, alpha=prior.alpha + 0.5 * stats.n[..., None],
               beta=prior.beta + 0.5 * _diag(resid))


def _nats(t: MNG):
    mk = t.M @ t.K_
    return (mk, t.K_, 2.0 * t.alpha - 1.0,
            2.0 * t.beta + _diag(mk @ _t(t.M)))


def svi_blend(post: MNG, prior: MNG, stats: LinGaussStats, scale, step) -> MNG:
    """Natural-space blend; nat = [M K (p, q), K (q, q), 2 alpha - 1 (p,),
    2 beta + diag(M K M^T) (p,)], the statistics [Syx, Sxx, n, diag Syy]."""
    s_nat = (stats.yxT / scale, stats.xxT / scale,
             stats.n[..., None] / scale * torch.ones_like(post.alpha),
             _diag(stats.yyT) / scale)
    mixed = tuple((1.0 - step) * a + step * (b + s)
                  for a, b, s in zip(_nats(post), _nats(prior), s_nat))
    k_n = mixed[1]
    m_n = _t(solve_psd(k_n, _t(mixed[0])))
    return MNG(M=m_n, K_=k_n, alpha=0.5 * (mixed[2] + 1.0),
               beta=0.5 * (mixed[3] - _diag(m_n @ k_n @ _t(m_n))))


def _e_ala(p: MNG, e_l):
    """E[sum_i lambda_i a_i a_i^T] = p K^{-1} + sum_i E[lambda_i] M_i M_i^T."""
    return (p.row_dim * inv_psd(p.K_)
            + torch.einsum('kp,kpq,kpr->kqr', e_l, p.M, p.M))


def expected_log_likelihood(p: MNG, x, y):
    """E_q[log N(y | A xt, diag(lambda)^{-1})] -> (N, K)."""
    pd = p.row_dim
    k = p.M.shape[0]
    e_l = p.alpha / p.beta                                   # (K, p)
    e_logl = torch.digamma(p.alpha) - torch.log(p.beta)
    e_la = e_l[..., None] * p.M                              # (K, p, q)
    t1 = _outer_rows(y, x) @ e_la.reshape(k, -1).T
    t2 = -0.5 * quad_form(x, _e_ala(p, e_l), None)
    t3 = -0.5 * (torch.square(y) @ e_l.T)
    return t1 + t2 + t3 + 0.5 * torch.sum(e_logl, -1) - 0.5 * pd * LOG2PI


def log_partition(p: MNG):
    """logZ = -p/2 logdet K + sum_i [lgamma(alpha_i) - alpha_i log beta_i]."""
    return (-0.5 * p.row_dim * chol_logdet(cholesky(p.K_))
            + torch.sum(torch.lgamma(p.alpha) - p.alpha * torch.log(p.beta),
                        -1))


def kl_divergence(q: MNG, p: MNG):
    """KL(q || p) per expert (K,)."""
    e_l = q.alpha / q.beta
    e_logl = 0.5 * (torch.digamma(q.alpha) - torch.log(q.beta))
    e_la = e_l[..., None] * q.M
    e_ala = -0.5 * _e_ala(q, e_l)
    nq, np_ = _nats(q), _nats(p)
    inner = (torch.einsum('kpq,kpq->k', nq[0] - np_[0], e_la)
             + torch.einsum('kqr,kqr->k', nq[1] - np_[1], e_ala)
             + torch.sum((nq[2] - np_[2]) * e_logl, -1)
             + torch.sum((nq[3] - np_[3]) * (-0.5 * e_l), -1))
    return log_partition(p) - log_partition(q) + inner


def sample_params(gen, p: MNG) -> DiagLinGaussParams:
    """Draw (A, lambda) ~ MNG(p): lambda_i ~ Gamma(alpha_i) / beta_i per
    output row, then a_i = M_i + lambda_i^{-1/2} z_i Lk^{-1}, whose row
    covariance is K^{-1} = Lk^{-T} Lk^{-1} (solved against the transposed
    Cholesky factor, as in mnw.sample_params)."""
    lmbda = gamma_sample(gen, p.alpha) / p.beta              # (K, p)
    z = torch.randn(p.M.shape, generator=gen, dtype=p.M.dtype,
                    device=p.M.device)
    w = column_solve(cholesky(p.K_), z)
    return DiagLinGaussParams(A=p.M + w / torch.sqrt(lmbda)[..., None],
                              lmbda_diag=lmbda)


def mode_params(p: MNG) -> DiagLinGaussParams:
    return DiagLinGaussParams(A=p.M, lmbda_diag=(p.alpha - 0.5) / p.beta)


def mean_params(p: MNG) -> DiagLinGaussParams:
    return DiagLinGaussParams(A=p.M, lmbda_diag=p.alpha / p.beta)


def ml_params(stats: LinGaussStats, jitter=1e-8) -> DiagLinGaussParams:
    """Weighted diagonal-noise maximum likelihood: the A solve of MNW's,
    then per-output residual variances (at least `jitter`). A component
    with a count below q + 1 gets A = 0 and unit noise."""
    q = stats.xxT.shape[-1]
    n = torch.clamp(stats.n, min=1e-8)[..., None]
    dead = (stats.n < q + 1.0)[..., None]
    eye_q = torch.eye(q, dtype=stats.xxT.dtype, device=stats.xxT.device)
    xxr = torch.where(dead[..., None], eye_q, stats.xxT + jitter * eye_q)
    a = torch.where(dead[..., None], 0.0, _t(solve_psd(xxr, _t(stats.yxT))))
    resid = torch.clamp(_diag(stats.yyT - a @ _t(stats.yxT)) / n, min=jitter)
    resid = torch.where(dead, 1.0, resid)
    return DiagLinGaussParams(A=a, lmbda_diag=1.0 / resid)


def log_likelihood(params: DiagLinGaussParams, x, y):
    """log N(y | A_k x, diag(lambda_k)^{-1}) -> (N, K)."""
    pd = y.shape[-1]
    k = params.A.shape[0]
    la = params.lmbda_diag[..., None] * params.A             # (K, p, q)
    ala = torch.einsum('kpq,kpr->kqr', la, params.A)
    cross = _outer_rows(y, x) @ la.reshape(k, -1).T
    quad_y = torch.square(y) @ params.lmbda_diag.T
    quad_x = quad_form(x, ala, None)
    logdet = torch.sum(torch.log(params.lmbda_diag), -1)
    return (-0.5 * (quad_y - 2.0 * cross + quad_x)
            + 0.5 * (logdet - pd * LOG2PI))


def predictive_studentt_params(p: MNG, x):
    """Per-row t predictive: df_i = 2 alpha_i, mean = M xt, precision
    (alpha_i / beta_i) / c with c = 1 + xt^T K^{-1} xt.
    Returns mus (N, K, p), lmbda (N, K, p), df (K, p)."""
    mus = torch.einsum('kpq,nq->nkp', p.M, x)
    c = 1.0 + quad_form(x, inv_psd(p.K_), None)              # (N, K)
    return mus, (p.alpha / p.beta)[None] / c[..., None], 2.0 * p.alpha


def log_predictive_studentt(p: MNG, x, y):
    mus, lmbda, df = predictive_studentt_params(p, x)
    delta = lmbda * torch.square(y[:, None, :] - mus)
    aux = (gammaln_diff(0.5 * df, 0.5)
           - 0.5 * (torch.log(df) + math.log(math.pi)))
    out = (aux[None] + 0.5 * torch.log(lmbda)
           - 0.5 * (df[None] + 1.0) * torch.log1p(delta / df[None]))
    return torch.sum(out, -1)


def log_predictive_gaussian(p: MNG, x, y):
    mus, lmbda, _ = predictive_studentt_params(p, x)
    out = (0.5 * (torch.log(lmbda) - LOG2PI)
           - 0.5 * lmbda * torch.square(y[:, None, :] - mus))
    return torch.sum(out, -1)


def predictive_moments_studentt(p: MNG, x):
    """Mean (N, K, p) and diagonal covariance (N, K, p)."""
    mus, lmbda, df = predictive_studentt_params(p, x)
    return mus, (1.0 / lmbda) * (df / (df - 2.0))[None]


def predictive_moments_gaussian(p: MNG, x):
    mus, lmbda, _ = predictive_studentt_params(p, x)
    return mus, 1.0 / lmbda
