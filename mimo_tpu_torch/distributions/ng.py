"""Normal-Gamma conjugate family for diagonal-covariance Gaussian
components (port of mimo_tpu/distributions/ng.py).

Model (per component k, per dimension i): lambda_ki ~ Gamma(alpha_ki,
beta_ki), mu_ki | lambda_ki ~ N(m_ki, (kappa_ki lambda_ki)^{-1});
likelihood x_i ~ N(mu_ki, lambda_ki^{-1}).
Natural parameters: nat = [kappa m, kappa, 2 alpha - 1, 2 beta + kappa m^2],
paired with the statistics t(x) = [x, 1, 1, x^2].
"""

import math
from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions.wishart import gamma_sample
from mimo_tpu_torch.utils.stats import LOG2PI, diag_mvn_logpdf, gammaln_diff


class NG(NamedTuple):
    mu: torch.Tensor     # (K, d)
    kappa: torch.Tensor  # (K, d)
    alpha: torch.Tensor  # (K, d)
    beta: torch.Tensor   # (K, d)

    @property
    def dim(self):
        return self.mu.shape[-1]

    @staticmethod
    def standard(size, dim, mean=None, kappa=1e-2, alpha=None, beta=None,
                 dtype=torch.float32, device=None):
        """Weakly-informative prior replicated over K components."""
        kw = dict(dtype=dtype, device=device)
        mean = (torch.zeros(dim, **kw) if mean is None
                else torch.as_tensor(mean, **kw))

        def full(v):
            return torch.as_tensor(v, **kw).expand(size, dim).clone()
        return NG(mu=full(mean), kappa=full(kappa),
                  alpha=full(2.0 if alpha is None else alpha),
                  beta=full(1.0 if beta is None else beta))


class DiagGaussStats(NamedTuple):
    """Weighted diagonal-Gaussian statistics aligned with NG nat params."""
    x: torch.Tensor    # (K, d)  sum_n r_nk x_n
    n1: torch.Tensor   # (K,)    sum_n r_nk
    n2: torch.Tensor   # (K,)    sum_n r_nk
    xsq: torch.Tensor  # (K, d)  sum_n r_nk x_n^2


class DiagGaussParams(NamedTuple):
    mu: torch.Tensor          # (K, d)
    lmbda_diag: torch.Tensor  # (K, d)


def suff_stats(x, resp):
    """x: (N, d), resp: (N, K) -> DiagGaussStats."""
    counts = torch.sum(resp, 0)
    return DiagGaussStats(x=resp.T @ x, n1=counts, n2=counts,
                          xsq=resp.T @ torch.square(x))


def posterior_update(prior: NG, stats: DiagGaussStats) -> NG:
    """Conjugate update (std space, equivalent to the nat add):
      kappa' = kappa + n;  m' = (kappa m + s1) / kappa';
      alpha' = alpha + n/2;
      beta'  = beta + 1/2 (s2 + kappa m^2 - kappa' m'^2).
    The beta difference is uncentered, as in the JAX package (the parity
    tests hold the two to the same formula)."""
    n = stats.n1[..., None]
    kappa_n = prior.kappa + n
    mu_n = (prior.kappa * prior.mu + stats.x) / kappa_n
    beta_n = prior.beta + 0.5 * (stats.xsq + prior.kappa * torch.square(
        prior.mu) - kappa_n * torch.square(mu_n))
    return NG(mu=mu_n, kappa=kappa_n, alpha=prior.alpha + 0.5 * n,
              beta=beta_n)


def _nats(t: NG):
    return (t.kappa * t.mu, t.kappa, 2.0 * t.alpha - 1.0,
            2.0 * t.beta + t.kappa * torch.square(t.mu))


def svi_blend(post: NG, prior: NG, stats: DiagGaussStats, scale, step) -> NG:
    """Natural-gradient SVI step, blended in the natural coordinates
    (kappa m, kappa, 2 alpha - 1, 2 beta + kappa m^2):
    nat' = (1 - step) nat(post) + step nat(update(prior, stats / scale))."""
    scaled = DiagGaussStats(*(s / scale for s in stats))
    full = posterior_update(prior, scaled)
    mixed = tuple((1.0 - step) * a + step * b
                  for a, b in zip(_nats(post), _nats(full)))
    kappa = mixed[1]
    mu = mixed[0] / kappa
    return NG(mu=mu, kappa=kappa, alpha=0.5 * (mixed[2] + 1.0),
              beta=0.5 * (mixed[3] - kappa * torch.square(mu)))


def expected_log_likelihood(p: NG, x):
    """E_q[log N(x | mu, diag(lambda)^{-1})] -> (N, K)
    = 1/2 sum_i [E log l_i - log 2pi - E[l_i] (x_i - m_i)^2 - 1/kappa_i]."""
    d = x.shape[-1]
    e_l = p.alpha / p.beta                                   # (K, d)
    e_logl = torch.digamma(p.alpha) - torch.log(p.beta)
    quad = (torch.square(x) @ e_l.T - 2.0 * (x @ (e_l * p.mu).T)
            + torch.sum(e_l * torch.square(p.mu) + 1.0 / p.kappa, -1))
    return 0.5 * (torch.sum(e_logl, -1) - d * LOG2PI) - 0.5 * quad


def log_partition(p: NG):
    """logZ = sum_i [-1/2 log kappa_i + lgamma(alpha_i)
                     - alpha_i log beta_i]."""
    return torch.sum(-0.5 * torch.log(p.kappa) + torch.lgamma(p.alpha)
                     - p.alpha * torch.log(p.beta), -1)


def kl_divergence(q: NG, p: NG):
    """KL(q || p) per component, via logZ + <nat_q - nat_p, E_q[t]>."""
    e_lm = q.alpha / q.beta * q.mu
    e_mlm = -0.5 * (1.0 / q.kappa + q.mu * e_lm)
    e_logl = 0.5 * (torch.digamma(q.alpha) - torch.log(q.beta))
    e_l = -0.5 * q.alpha / q.beta
    nq, np_ = _nats(q), _nats(p)
    inner = torch.sum((nq[0] - np_[0]) * e_lm + (nq[1] - np_[1]) * e_mlm
                      + (nq[2] - np_[2]) * e_logl + (nq[3] - np_[3]) * e_l,
                      -1)
    return log_partition(p) - log_partition(q) + inner


def sample_params(gen, p: NG) -> DiagGaussParams:
    """Draw (mu, lambda) ~ NG(p): lambda ~ Gamma(alpha) / beta, then
    mu ~ N(m, (kappa lambda)^{-1}), both from the explicit generator."""
    lmbda = gamma_sample(gen, p.alpha) / p.beta
    z = torch.randn(p.mu.shape, generator=gen, dtype=p.mu.dtype,
                    device=p.mu.device)
    return DiagGaussParams(mu=p.mu + z / torch.sqrt(p.kappa * lmbda),
                           lmbda_diag=lmbda)


def mode_params(p: NG) -> DiagGaussParams:
    """Reference convention: lambda = (alpha - 1/2) / beta."""
    return DiagGaussParams(mu=p.mu, lmbda_diag=(p.alpha - 0.5) / p.beta)


def mean_params(p: NG) -> DiagGaussParams:
    return DiagGaussParams(mu=p.mu, lmbda_diag=p.alpha / p.beta)


def ml_params(stats: DiagGaussStats, jitter=1e-8) -> DiagGaussParams:
    """Weighted diagonal maximum likelihood: mu = s1/n, var = s2/n - mu^2
    (at least `jitter`). A component with a count below 2 gets N(0, I)."""
    dead = (stats.n1 < 2.0)[..., None]
    n = torch.clamp(stats.n1, min=1e-8)[..., None]
    mu = torch.where(dead, 0.0, stats.x / n)
    var = torch.clamp(stats.xsq / n - torch.square(mu), min=jitter)
    var = torch.where(dead, 1.0, var)
    return DiagGaussParams(mu=mu, lmbda_diag=1.0 / var)


def log_likelihood(params: DiagGaussParams, x):
    return diag_mvn_logpdf(x, params.mu, params.lmbda_diag)


def predictive_studentt_params(p: NG):
    """Per-dim posterior-predictive t: df = 2 alpha, precision
    (alpha / beta) kappa / (kappa + 1)."""
    return p.mu, p.alpha / p.beta * p.kappa / (p.kappa + 1.0), 2.0 * p.alpha


def log_predictive_studentt(p: NG, x):
    """Sum of the per-dimension univariate t log-pdfs -> (N, K)."""
    mu, lmbda, df = predictive_studentt_params(p)
    xc2 = (torch.square(x)[:, None, :] - 2.0 * x[:, None, :] * mu[None]
           + torch.square(mu)[None])                          # (N, K, d)
    delta = lmbda[None] * xc2
    aux = (gammaln_diff(0.5 * df, 0.5)
           + 0.5 * (torch.log(lmbda) - torch.log(df) - math.log(math.pi)))
    out = aux[None] - 0.5 * (df[None] + 1.0) * torch.log1p(delta / df[None])
    return torch.sum(out, -1)


def log_predictive_gaussian(p: NG, x):
    mu, lmbda, _ = predictive_studentt_params(p)
    return diag_mvn_logpdf(x, mu, lmbda)
