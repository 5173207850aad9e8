"""Normal-Wishart conjugate family for full-covariance Gaussian components
(port of mimo_tpu/distributions/niw.py).

Model (per component k): Lambda_k ~ W(psi_k, nu_k),
mu_k | Lambda_k ~ N(m_k, (kappa_k Lambda_k)^{-1});
likelihood x ~ N(mu_k, Lambda_k^{-1}).

Parameters carry a leading K axis; per-point quantities are (N, K).
Natural parameters: nat = [kappa*m, kappa, psi^{-1} + kappa*m m^T, nu - d],
paired with the statistics t(x) = [x, 1, x x^T, 1].
"""

from typing import NamedTuple

import torch

from mimo_tpu_torch.utils.linalg import (
    chol_logdet, cholesky, inv_psd, inv_psd_chol, symmetrize, quad_form,
)
from mimo_tpu_torch.utils.stats import LOG2PI, mvn_logpdf, mvt_logpdf
from mimo_tpu_torch.distributions.wishart import (
    expected_logdet_at, log_partition_at, wishart_expected_logdet,
    wishart_sample,
)

# How often a fit built a fixed prior's constants (`prior_constants`) and
# how often an update or a KL read them back in place of forming them.
prior_consts = {'built': 0, 'reused': 0}


class NIW(NamedTuple):
    """Normal-Wishart parameters, batched over leading axes."""
    mu: torch.Tensor     # (K, d)
    kappa: torch.Tensor  # (K,)
    psi: torch.Tensor    # (K, d, d)  Wishart scale, E[Lambda] = nu * psi
    nu: torch.Tensor     # (K,)

    @property
    def dim(self):
        return self.mu.shape[-1]

    @staticmethod
    def standard(size, dim, mean=None, kappa=1e-2, psi_scale=1.0, nu=None,
                 dtype=torch.float32, device=None):
        """Weakly-informative prior replicated over K components."""
        kw = dict(dtype=dtype, device=device)
        mean = (torch.zeros(dim, **kw) if mean is None
                else torch.as_tensor(mean, **kw))
        nu = float(dim + 2) if nu is None else nu
        return NIW(
            mu=mean.expand(size, dim).clone(),
            kappa=torch.full((size,), kappa, **kw),
            psi=(psi_scale * torch.eye(dim, **kw)).expand(size, dim,
                                                          dim).clone(),
            nu=torch.full((size,), nu, **kw),
        )


class GaussStats(NamedTuple):
    """Weighted Gaussian sufficient statistics, aligned with NIW nat params."""
    x: torch.Tensor    # (K, d)     sum_n r_nk x_n
    n1: torch.Tensor   # (K,)       sum_n r_nk
    xxT: torch.Tensor  # (K, d, d)  sum_n r_nk x_n x_n^T
    n2: torch.Tensor   # (K,)       sum_n r_nk


class GaussParams(NamedTuple):
    """Plug-in Gaussian likelihood parameters (for Gibbs / EM / MAP)."""
    mu: torch.Tensor     # (K, d)
    lmbda: torch.Tensor  # (K, d, d) precision


class PriorConsts(NamedTuple):
    """The terms of a fixed NIW prior that every sweep of a fit reads,
    built once a fit (`prior_constants`)."""
    psi_inv: torch.Tensor   # (K, d, d)  psi^{-1}
    nat: GaussStats         # nat_from_std(prior)
    log_z: torch.Tensor     # (K,)       log_partition(prior)


class PsiAux(NamedTuple):
    """A posterior's psi^{-1} and log|psi|, formed by the update that made
    it (`posterior_update(..., with_aux=True)`) or from psi (`psi_aux`):
    what the next KL reads instead of factoring psi."""
    psi_inv: torch.Tensor   # (K, d, d)
    logdet: torch.Tensor    # (K,)  log|psi|


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


# -- sufficient statistics ---------------------------------------------------

def suff_stats(x, resp):
    """Weighted statistics from data x (N, d) and resp (N, K)."""
    n, d = x.shape
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    sxx = (resp.T @ xx).reshape(-1, d, d)
    counts = torch.sum(resp, dim=0)
    return GaussStats(x=resp.T @ x, n1=counts, xxT=symmetrize(sxx), n2=counts)


# -- natural <-> standard parameters -------------------------------------------

def nat_from_std(p: NIW) -> GaussStats:
    return _nat(p, inv_psd(p.psi))


def _nat(p: NIW, psi_inv) -> GaussStats:
    """nat_from_std given p's psi^{-1}."""
    kmm = p.kappa[..., None, None] * _outer(p.mu, p.mu)
    return GaussStats(x=p.kappa[..., None] * p.mu, n1=p.kappa,
                      xxT=psi_inv + kmm, n2=p.nu - p.dim)


def std_from_nat(nat: GaussStats) -> NIW:
    d = nat.x.shape[-1]
    mu = nat.x / nat.n1[..., None]
    kmm = nat.n1[..., None, None] * _outer(mu, mu)
    return NIW(mu=mu, kappa=nat.n1, psi=inv_psd(nat.xxT - kmm), nu=nat.n2 + d)


# -- a fixed prior's constants and a posterior's inverse scale ----------------

def prior_constants(p: NIW) -> PriorConsts:
    """The fixed prior's psi^{-1}, natural parameters and log-partition,
    which `posterior_update` and `kl_divergence` otherwise form again at
    every call: a fit builds them once and hands them to every sweep."""
    prior_consts['built'] += 1
    psi_inv = inv_psd(p.psi)
    return PriorConsts(psi_inv, _nat(p, psi_inv), log_partition(p))


def _reused(consts: PriorConsts) -> PriorConsts:
    prior_consts['reused'] += 1
    return consts


def psi_aux(p: NIW) -> PsiAux:
    """p's psi^{-1} and log|psi| from psi (one Cholesky and one solve), for
    a posterior that no update of this fit made."""
    psi_inv, chol = inv_psd_chol(p.psi)
    return PsiAux(psi_inv, chol_logdet(chol))


# -- conjugate update --------------------------------------------------------

def posterior_update(prior: NIW, stats: GaussStats, consts=None,
                     with_aux=False):
    """Closed-form conjugate update nat(post) = nat(prior) + stats, in the
    centered form
      psi'^{-1} = psi^{-1} + (S2 - n xbar xbar^T)
                + (kappa n / kappa') (xbar - m)(xbar - m)^T,
    which avoids the kappa m m^T - kappa' m' m'^T cancellation in f32.

    With the prior's `consts` (`prior_constants`) the prior's psi^{-1} is
    read, not formed: the same numbers. With `with_aux` returns
    (posterior, PsiAux): the new psi'^{-1} and log|psi'| = -log|psi'^{-1}|
    from the factor that inverted it, for the next sweep's KL."""
    kappa_n = prior.kappa + stats.n1
    mu_n = (prior.kappa[..., None] * prior.mu + stats.x) / kappa_n[..., None]
    nu_n = prior.nu + stats.n2
    xbar = stats.x / torch.clamp(stats.n1, min=1e-12)[..., None]
    scatter = stats.xxT - stats.n1[..., None, None] * _outer(xbar, xbar)
    dm = xbar - prior.mu
    coef = prior.kappa * stats.n1 / kappa_n
    psi_inv_p = (inv_psd(prior.psi) if consts is None
                 else _reused(consts).psi_inv)
    psi_inv_n = (psi_inv_p + scatter
                 + coef[..., None, None] * _outer(dm, dm))
    psi_n, chol = inv_psd_chol(psi_inv_n)
    post = NIW(mu=mu_n, kappa=kappa_n, psi=psi_n, nu=nu_n)
    if not with_aux:
        return post
    return post, PsiAux(psi_inv_n, -chol_logdet(chol))


def svi_blend(post: NIW, prior: NIW, stats: GaussStats, scale, step) -> NIW:
    """Natural-gradient SVI step:
    nat' = (1 - step) nat(post) + step (nat(prior) + stats / scale)."""
    mixed = GaussStats(*((1.0 - step) * a + step * (b + s / scale)
                         for a, b, s in zip(nat_from_std(post),
                                            nat_from_std(prior), stats)))
    return std_from_nat(mixed)


# -- expectations (the VI E-step) and ELBO terms ------------------------------

def _logdet(p: NIW, logdet):
    """log|psi| of p: `logdet` where known, else from its Cholesky."""
    return chol_logdet(cholesky(p.psi)) if logdet is None else logdet


def expected_stats(p: NIW, logdet=None):
    """E_q of the NW statistics
    [Lambda mu, -1/2 mu^T Lambda mu, -1/2 Lambda, 1/2 logdet Lambda];
    `logdet`: log|psi| where known (no factorization then)."""
    d = p.dim
    e_lm = torch.einsum('k,kde,ke->kd', p.nu, p.psi, p.mu)
    e_mlm = -0.5 * (d / p.kappa + torch.einsum('kd,kd->k', p.mu, e_lm))
    e_l = -0.5 * p.nu[..., None, None] * p.psi
    e_logdet = 0.5 * expected_logdet_at(_logdet(p, logdet), p.nu, d)
    return e_lm, e_mlm, e_l, e_logdet


def expected_log_likelihood(p: NIW, x):
    """E_q[log N(x | mu_k, Lambda_k^{-1})] -> (N, K)."""
    d = x.shape[-1]
    quad = quad_form(x, p.psi, p.mu)
    e_logdet = wishart_expected_logdet(cholesky(p.psi), p.nu)
    return 0.5 * (e_logdet - d * LOG2PI) - 0.5 * (p.nu * quad + d / p.kappa)


def log_partition(p: NIW, logdet=None):
    """log Z of the NW: -d/2 log kappa + logZ_Wishart(psi, nu); `logdet`:
    log|psi| where known."""
    return (-0.5 * p.dim * torch.log(p.kappa)
            + log_partition_at(_logdet(p, logdet), p.nu, p.dim))


def kl_divergence(q: NIW, p: NIW, consts=None, aux=None):
    """KL(q || p) per component (K,). With p's `consts` (`prior_constants`)
    it reads p's natural parameters and log-partition, and with q's `aux`
    (`PsiAux`) q's psi^{-1} and log|psi|: given both, it factors nothing
    and solves nothing."""
    logdet = None if aux is None else aux.logdet
    e_lm, e_mlm, e_l, e_logdet = expected_stats(q, logdet)
    nq = nat_from_std(q) if aux is None else _nat(q, aux.psi_inv)
    if consts is None:
        np_, log_zp = nat_from_std(p), log_partition(p)
    else:
        np_, log_zp = _reused(consts).nat, consts.log_z
    inner = (torch.einsum('kd,kd->k', nq.x - np_.x, e_lm)
             + (nq.n1 - np_.n1) * e_mlm
             + torch.einsum('kde,kde->k', nq.xxT - np_.xxT, e_l)
             + (nq.n2 - np_.n2) * e_logdet)
    return log_zp - log_partition(q, logdet) + inner


def log_marginal_likelihood(prior: NIW, posterior: NIW, n):
    """log p(data) = logZ(post) - logZ(prior) - n*d/2 log 2pi."""
    return (log_partition(posterior) - log_partition(prior)
            - 0.5 * n * prior.dim * LOG2PI)


# -- sampling / point estimates of likelihood parameters ----------------------

def scaled_normal_draw(gen, mean, kappa, chol_lmbda):
    """mean + L^{-T} z / sqrt(kappa) ~ N(mean, (kappa Lambda)^{-1}) given
    L = chol(Lambda), batched: mean (..., d), kappa (...), chol_lmbda
    (..., d, d) (broadcast against mean's batch)."""
    z = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                    device=mean.device)
    delta = torch.linalg.solve_triangular(
        chol_lmbda.transpose(-1, -2), z[..., None], upper=True)[..., 0]
    return mean + delta / torch.sqrt(kappa)[..., None]


def sample_params(gen, p: NIW) -> GaussParams:
    """Draw (mu, Lambda) ~ NW(p), batched over K."""
    lmbda = wishart_sample(gen, p.psi, p.nu)
    return GaussParams(mu=scaled_normal_draw(gen, p.mu, p.kappa,
                                             cholesky(lmbda)),
                       lmbda=lmbda)


def mode_params(p: NIW) -> GaussParams:
    """Joint MAP point (reference convention: Lambda = (nu - d) psi)."""
    return GaussParams(mu=p.mu, lmbda=(p.nu - p.dim)[..., None, None] * p.psi)


def mean_params(p: NIW) -> GaussParams:
    return GaussParams(mu=p.mu, lmbda=p.nu[..., None, None] * p.psi)


def ml_params(stats: GaussStats, jitter=1e-6) -> GaussParams:
    """Weighted maximum likelihood from the statistics, over K: mu = s1/n,
    Sigma = Sxx/n - mu mu^T (+ jitter I). A component whose count drops
    below d + 1 (too few points for a d x d scatter: EM's singleton
    collapse) gets standard-normal params; it carries ~zero weight."""
    d = stats.x.shape[-1]
    n = torch.clamp(stats.n1, min=1e-8)
    dead = (stats.n1 < d + 1.0)[..., None]
    mu = torch.where(dead, 0.0, stats.x / n[..., None])
    eye = torch.eye(d, dtype=mu.dtype, device=mu.device)
    sigma = (symmetrize(stats.xxT / n[..., None, None] - _outer(mu, mu))
             + jitter * eye)
    sigma = torch.where(dead[..., None], eye, sigma)
    return GaussParams(mu=mu, lmbda=inv_psd(sigma))


# -- plug-in likelihood and posterior predictive -------------------------------

def log_likelihood(params: GaussParams, x):
    """log N(x | mu_k, Lambda_k^{-1}) -> (N, K)."""
    return mvn_logpdf(x, params.mu, params.lmbda)


def predictive_studentt_params(p: NIW):
    """Posterior-predictive Student-t: df = nu-d+1, precision
    (df / (1 + 1/kappa)) * psi."""
    df = p.nu - p.dim + 1.0
    c = 1.0 + 1.0 / p.kappa
    return p.mu, (df / c)[..., None, None] * p.psi, df


def log_predictive_studentt(p: NIW, x):
    mu, lmbda, df = predictive_studentt_params(p)
    return mvt_logpdf(x, mu, lmbda, df)


def log_predictive_gaussian(p: NIW, x):
    """Moment-matched Gaussian approximation of the predictive."""
    mu, lmbda, _ = predictive_studentt_params(p)
    return mvn_logpdf(x, mu, lmbda)
