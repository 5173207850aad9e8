"""Matrix-Normal-Wishart conjugate family for linear-Gaussian experts
(port of mimo_tpu/distributions/mnw.py).

Model (per expert k): Lambda_k ~ W(psi_k, nu_k)  (p x p noise precision),
A_k | Lambda_k ~ MN(M_k, Lambda_k^{-1} (rows), K_k^{-1} (cols))  (p x q);
likelihood  y ~ N(A_k xt, Lambda_k^{-1})  with xt = [x; 1] if affine.
Natural parameters: nat = [M K, K, psi^{-1} + M K M^T, nu - p - 1 + q],
paired with the statistics t(x, y) = [y xt^T, xt xt^T, y y^T, 1].
"""

import math
from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions.wishart import (
    wishart_sample, wishart_expected_logdet, wishart_log_partition,
)
from mimo_tpu_torch.utils.linalg import (
    cholesky, chol_logdet, inv_psd, symmetrize, quad_form, solve_psd,
)
from mimo_tpu_torch.utils.stats import LOG2PI, gammaln_diff


def _t(a):
    return a.transpose(-1, -2)


class MNW(NamedTuple):
    M: torch.Tensor    # (K, p, q) regression-matrix mean
    K_: torch.Tensor   # (K, q, q) column (input) precision
    psi: torch.Tensor  # (K, p, p) Wishart scale, E[Lambda] = nu * psi
    nu: torch.Tensor   # (K,)

    @property
    def row_dim(self):  # p = output dim
        return self.M.shape[-2]

    @property
    def col_dim(self):  # q = (augmented) input dim
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, psi_scale=1.0,
                 nu=None, dtype=torch.float32, device=None):
        kw = dict(dtype=dtype, device=device)
        nu = float(row_dim + 2) if nu is None else nu
        return MNW(
            M=torch.zeros((size, row_dim, col_dim), **kw),
            K_=(K_scale * torch.eye(col_dim, **kw)).expand(
                size, col_dim, col_dim).clone(),
            psi=(psi_scale * torch.eye(row_dim, **kw)).expand(
                size, row_dim, row_dim).clone(),
            nu=torch.full((size,), nu, **kw),
        )


class LinGaussStats(NamedTuple):
    """Weighted linear-Gaussian statistics aligned with MNW nat params."""
    yxT: torch.Tensor  # (K, p, q)
    xxT: torch.Tensor  # (K, q, q)
    yyT: torch.Tensor  # (K, p, p)
    n: torch.Tensor    # (K,)


class LinGaussParams(NamedTuple):
    A: torch.Tensor      # (K, p, q)
    lmbda: torch.Tensor  # (K, p, p)


def augment(x, affine: bool):
    """Append the all-ones column (last) when affine."""
    if affine:
        ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        return torch.cat([x, ones], -1)
    return x


def _outer_rows(a, b):
    """(N, da), (N, db) -> (N, da * db) row-wise outer products."""
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def suff_stats(x, y, resp):
    """x: (N, q) (already augmented), y: (N, p), resp: (N, K)."""
    q, p = x.shape[-1], y.shape[-1]
    syx = (resp.T @ _outer_rows(y, x)).reshape(-1, p, q)
    sxx = (resp.T @ _outer_rows(x, x)).reshape(-1, q, q)
    syy = (resp.T @ _outer_rows(y, y)).reshape(-1, p, p)
    return LinGaussStats(yxT=syx, xxT=symmetrize(sxx), yyT=symmetrize(syy),
                         n=torch.sum(resp, 0))


def nat_from_std(p: MNW) -> LinGaussStats:
    mk = p.M @ p.K_
    return LinGaussStats(yxT=mk, xxT=p.K_,
                         yyT=inv_psd(p.psi) + mk @ _t(p.M),
                         n=p.nu - p.row_dim - 1.0 + p.col_dim)


def std_from_nat(nat: LinGaussStats) -> MNW:
    p_dim, q_dim = nat.yxT.shape[-2], nat.yxT.shape[-1]
    m = _t(solve_psd(nat.xxT, _t(nat.yxT)))          # M = yxT K^{-1}
    psi = inv_psd(nat.yyT - m @ nat.xxT @ _t(m))
    return MNW(M=m, K_=nat.xxT, psi=psi, nu=nat.n + p_dim + 1.0 - q_dim)


def posterior_update(prior: MNW, stats: LinGaussStats) -> MNW:
    """Conjugate update:
      K' = K + Sxx;  M' = (M K + Syx) K'^{-1};  nu' = nu + n;
      psi'^{-1} = psi^{-1} + Syy + M K M^T - M' K' M'^T."""
    k_n = prior.K_ + stats.xxT
    mk = prior.M @ prior.K_ + stats.yxT
    m_n = _t(solve_psd(k_n, _t(mk)))
    psi_inv_n = (inv_psd(prior.psi) + stats.yyT
                 + prior.M @ prior.K_ @ _t(prior.M) - m_n @ k_n @ _t(m_n))
    return MNW(M=m_n, K_=k_n, psi=inv_psd(symmetrize(psi_inv_n)),
               nu=prior.nu + stats.n)


def svi_blend(post: MNW, prior: MNW, stats: LinGaussStats, scale, step) -> MNW:
    """nat' = (1 - step) nat(post) + step (nat(prior) + stats / scale)."""
    mixed = LinGaussStats(*((1.0 - step) * a + step * (b + s / scale)
                            for a, b, s in zip(nat_from_std(post),
                                               nat_from_std(prior), stats)))
    return std_from_nat(mixed)


def expected_stats(p: MNW):
    """E_q of [Lambda A, -1/2 A^T Lambda A, -1/2 Lambda, 1/2 logdet Lambda]."""
    e_la = p.nu[..., None, None] * (p.psi @ p.M)              # (K, p, q)
    e_ala = -0.5 * (p.row_dim * inv_psd(p.K_) + _t(p.M) @ e_la)
    e_l = -0.5 * p.nu[..., None, None] * p.psi
    e_logdet = 0.5 * wishart_expected_logdet(cholesky(p.psi), p.nu)
    return e_la, e_ala, e_l, e_logdet


def expected_log_likelihood(p: MNW, x, y):
    """E_q[log N(y | A_k xt, Lambda_k^{-1})] -> (N, K)."""
    pd = p.row_dim
    e_la, e_ala, e_l, e_logdet = expected_stats(p)
    k = p.M.shape[0]
    t1 = _outer_rows(y, x) @ e_la.reshape(k, -1).T            # <E[LA], y x^T>
    t2 = quad_form(x, e_ala, None)
    t3 = quad_form(y, e_l, None)
    return t1 + t2 + t3 + e_logdet - 0.5 * pd * LOG2PI


def log_partition(p: MNW):
    """logZ = -p/2 logdet K + logZ_Wishart(psi, nu)."""
    return (-0.5 * p.row_dim * chol_logdet(cholesky(p.K_))
            + wishart_log_partition(cholesky(p.psi), p.nu))


def kl_divergence(q: MNW, p: MNW):
    """KL(q || p) per expert (K,)."""
    e_la, e_ala, e_l, e_logdet = expected_stats(q)
    nq, np_ = nat_from_std(q), nat_from_std(p)
    inner = (torch.einsum('kpq,kpq->k', nq.yxT - np_.yxT, e_la)
             + torch.einsum('kqr,kqr->k', nq.xxT - np_.xxT, e_ala)
             + torch.einsum('kpr,kpr->k', nq.yyT - np_.yyT, e_l)
             + (nq.n - np_.n) * e_logdet)
    return log_partition(p) - log_partition(q) + inner


def column_solve(chol_k, u):
    """u Lk^{-1}: columns of covariance K^{-1} = Lk^{-T} Lk^{-1} from
    Lk = chol(K), as w^T = Lk^{-T} u^T, a solve against the TRANSPOSED
    factor (solving against Lk itself gives (Lk^T Lk)^{-1}, wrong for any
    non-diagonal K)."""
    return _t(torch.linalg.solve_triangular(_t(chol_k), _t(u), upper=True))


def matrix_normal_draw(gen, mean, chol_lmbda, chol_k):
    """A ~ MN(mean, Lambda^{-1} (rows), K^{-1} (columns)) given the
    Cholesky factors of Lambda and K, batched: L^{-T} Z Lk^{-1}."""
    z = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                    device=mean.device)
    u = torch.linalg.solve_triangular(_t(chol_lmbda), z, upper=True)
    return mean + column_solve(chol_k, u)


def sample_params(gen, p: MNW) -> LinGaussParams:
    """Draw (A, Lambda) ~ MNW(p)."""
    lmbda = wishart_sample(gen, p.psi, p.nu)
    return LinGaussParams(A=matrix_normal_draw(gen, p.M, cholesky(lmbda),
                                               cholesky(p.K_)),
                          lmbda=lmbda)


def mode_params(p: MNW) -> LinGaussParams:
    """Reference convention: Lambda = (nu - p) psi."""
    return LinGaussParams(A=p.M,
                          lmbda=(p.nu - p.row_dim)[..., None, None] * p.psi)


def mean_params(p: MNW) -> LinGaussParams:
    return LinGaussParams(A=p.M, lmbda=p.nu[..., None, None] * p.psi)


def ml_params(stats: LinGaussStats, jitter=1e-6) -> LinGaussParams:
    """Weighted maximum likelihood: A solves A Sxx = Syx; Sigma = (Syy -
    A Syx^T) / n (+ jitter I). A component with a count below q + 1 gets
    A = 0, Sigma = I instead of NaNs."""
    n = torch.clamp(stats.n, min=1e-8)
    q, p_dim = stats.xxT.shape[-1], stats.yyT.shape[-1]
    kw = dict(dtype=stats.xxT.dtype, device=stats.xxT.device)
    eye_q, eye_p = torch.eye(q, **kw), torch.eye(p_dim, **kw)
    dead = (stats.n < q + 1.0)[..., None, None]
    xxr = torch.where(dead, eye_q, stats.xxT + jitter * eye_q)
    a = torch.where(dead, 0.0, _t(solve_psd(xxr, _t(stats.yxT))))
    sigma = (symmetrize(stats.yyT - a @ _t(stats.yxT)) / n[..., None, None]
             + jitter * eye_p)
    sigma = torch.where(dead, eye_p, sigma)
    return LinGaussParams(A=a, lmbda=inv_psd(sigma))


def log_likelihood(params: LinGaussParams, x, y):
    """log N(y | A_k x, Lambda_k^{-1}) -> (N, K), expanded so the (N, K)
    matrix comes from matmuls:
      -1/2 [ y'Ly - 2 y'LAx + x'A'LAx ] + 1/2 logdet L - p/2 log2pi."""
    pd = y.shape[-1]
    la = params.lmbda @ params.A                              # (K, p, q)
    ala = _t(params.A) @ la                                   # (K, q, q)
    k = params.A.shape[0]
    cross = _outer_rows(y, x) @ la.reshape(k, -1).T
    quad_y = quad_form(y, params.lmbda, None)
    quad_x = quad_form(x, ala, None)
    logdet = chol_logdet(cholesky(params.lmbda))
    return (-0.5 * (quad_y - 2.0 * cross + quad_x)
            + 0.5 * (logdet - pd * LOG2PI))


def predictive_studentt_params(p: MNW, x):
    """Posterior-predictive t of y | x:
      df = nu - p + 1;  mean = M xt;
      precision = (df / c_n) psi  with  c_n = 1 + xt^T K^{-1} xt.
    Returns mus (N, K, p), c (N, K), df (K,)."""
    df = p.nu - p.row_dim + 1.0
    mus = torch.einsum('kpq,nq->nkp', p.M, x)
    c = 1.0 + quad_form(x, inv_psd(p.K_), None)               # (N, K)
    return mus, c, df


def _base_quad(p: MNW, x, y):
    mus, c, df = predictive_studentt_params(p, x)
    yc = y[:, None, :] - mus                                  # (N, K, p)
    return torch.einsum('nkp,kpr,nkr->nk', yc, p.psi, yc), c, df


def log_predictive_studentt(p: MNW, x, y):
    """(N, K) Student-t predictive log-densities."""
    pd = p.row_dim
    base_quad, c, df = _base_quad(p, x, y)
    delta = (df / c) * base_quad
    logdet_lmbda = pd * torch.log(df / c) + chol_logdet(cholesky(p.psi))
    aux = (gammaln_diff(0.5 * df, 0.5 * pd) + 0.5 * logdet_lmbda
           - 0.5 * pd * (torch.log(df) + math.log(math.pi)))
    return aux - 0.5 * (df + pd) * torch.log1p(delta / df)


def log_predictive_gaussian(p: MNW, x, y):
    """Gaussian approximation: N(y | M xt, ((df/c) psi)^{-1})."""
    pd = p.row_dim
    base_quad, c, df = _base_quad(p, x, y)
    logdet = pd * torch.log(df / c) + chol_logdet(cholesky(p.psi))
    return 0.5 * (logdet - pd * LOG2PI) - 0.5 * (df / c) * base_quad


def predictive_moments_studentt(p: MNW, x):
    """Per-expert predictive mean (N, K, p) and covariance (N, K, p, p):
    cov = inv(lmbda) * df/(df-2)."""
    mus, c, df = predictive_studentt_params(p, x)
    cov = (c / df * (df / (df - 2.0)))[..., None, None] * inv_psd(p.psi)[None]
    return mus, cov


def predictive_moments_gaussian(p: MNW, x):
    mus, c, df = predictive_studentt_params(p, x)
    return mus, (c / df)[..., None, None] * inv_psd(p.psi)[None]
