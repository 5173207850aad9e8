"""Hierarchically-tied Gaussian components (port of
mimo_tpu/distributions/hierarchical.py; the inner-chain `gibbs_update`,
which no family uses, is not ported).

Model:  (tau, Lambda) ~ NW(m0, kappa0, Psi0, nu0)        [hyper prior]
        mu_k | tau, Lambda ~ N(tau, (kappa_k Lambda)^{-1})
        x | z=k ~ N(mu_k, Lambda^{-1})

The K means share one Normal-Wishart hyper-prior and one precision. The
hyper-posterior update reproduces the reference's K-averaged forms; each
update restarts the inner coordinate ascent from the hyper-prior, as the
JAX package does.

The inner rounds of an update (`posterior_update`, `svi_blend`) are the
span `mimo.algebra.hyper`, their number its argument, while the layer
spans are on (utils/logging.py); `counts` adds up the updates and their
rounds.
"""

from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.niw import (
    NIW, GaussParams, GaussStats, scaled_normal_draw)
from mimo_tpu_torch.distributions.wishart import (
    wishart_expected_logdet, wishart_sample)
from mimo_tpu_torch.utils.linalg import (
    chol_logdet, cholesky, inv_psd, quad_form)
from mimo_tpu_torch.utils.logging import span
from mimo_tpu_torch.utils.stats import LOG2PI, mvn_logpdf, mvt_logpdf

# Inner-round updates run since the last reset and their rounds, a count a
# Python call whatever the batch or vmap (the tests and chip_smoke.py read
# how many rounds a sweep runs).
counts = {'rounds': 0, 'updates': 0}


class HierTied(NamedTuple):
    """Prior or posterior of the hierarchically-tied Gaussian family.

    As a prior: `hyper` is the NW hyper-prior (leading axis 1), `mus` the
    hyper mean broadcast over K, `kappas == kappas0` the per-component
    scaled-precision coefficients. As a posterior: `hyper` is the NW
    hyper-posterior, `mus` the q(mu_k) means, `kappas = kappas0 + n_k`."""
    hyper: NIW              # leading axis 1: (1, d), (1,), (1, d, d), (1,)
    mus: torch.Tensor       # (K, d)
    kappas: torch.Tensor    # (K,)
    kappas0: torch.Tensor   # (K,) constant prior coefficients

    @property
    def dim(self):
        return self.mus.shape[-1]

    @property
    def size(self):
        return self.mus.shape[0]

    @staticmethod
    def standard(size, dim, kappa=1.0, hyper_kappa=1e-2, psi_scale=1.0,
                 nu=None, dtype=torch.float32, device=None):
        kw = dict(dtype=dtype, device=device)
        return HierTied(
            hyper=NIW.standard(1, dim, kappa=hyper_kappa, psi_scale=psi_scale,
                               nu=nu, dtype=dtype, device=device),
            mus=torch.zeros((size, dim), **kw),
            kappas=torch.full((size,), kappa, **kw),
            kappas0=torch.full((size,), kappa, **kw))


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _inner_rounds(nb_iter):
    """Count one update of `nb_iter` rounds; its span."""
    counts['updates'] += 1
    counts['rounds'] += nb_iter
    return span('algebra', 'hyper', nb_iter)


def _hyper_mstep(prior: HierTied, mus, stats: GaussStats) -> NIW:
    """The reference's K-averaged NW hyper-posterior update, over K."""
    k = mus.shape[0]
    h = prior.hyper
    m0, kappa0, nu0 = h.mu[0], h.kappa[0], h.nu[0]
    kap = prior.kappas0
    rho = (torch.sum(kap[:, None] * mus + kappa0 * m0[None, :], 0)
           / torch.sum(kap + kappa0))
    kappa = torch.sum(kap + kappa0) / k
    dm = m0[None, :] - mus
    coef = kappa0 * kap / (kappa0 + kap)
    spread = torch.einsum('k,kd,kl->dl', coef, dm, dm) / k
    data_term = (torch.sum(stats.xxT, 0)
                 - torch.einsum('kd,kl->dl', mus, stats.x)
                 - torch.einsum('kd,kl->dl', stats.x, mus)
                 + torch.einsum('k,kd,kl->dl', stats.n1, mus, mus)) / k
    psi = inv_psd((inv_psd(h.psi)[0] + spread + data_term)[None])
    nu = torch.sum(nu0 + stats.n2 + 1.0) / k
    return NIW(mu=rho[None], kappa=kappa[None], psi=psi, nu=nu[None])


def posterior_update(prior: HierTied, stats: GaussStats,
                     nb_iter: int = 25) -> HierTied:
    """Inner mean-field coordinate ascent: `nb_iter` rounds of the q(mu_k)
    e-step (kappa_k rho + x_k) / (kappa_k + n_k) with the current hyper
    mean rho, then the hyper m-step; the final mus are the last e-step's.

    A round reads only the previous round's rho, and the m-step's rho is
    affine in it: with S = sum_k (kappa_k + kappa0),

      rho' = a rho + b,  a = sum_k kappa_k^2 / (kappa_k + n_k) / S,
      b = (sum_k kappa_k x_k / (kappa_k + n_k) + K kappa0 m0) / S.

    So each round but the last is one fused op on rho, and the last runs
    the e-step and the whole m-step, whose kappa, psi and nu no earlier
    round reads: two Choleskys an update, whatever `nb_iter`."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1
    hyper, mus = prior.hyper, prior.mus
    with _inner_rounds(nb_iter):
        if nb_iter:
            m0, kappa0 = hyper.mu, hyper.kappa[0]
            w = kap / kappas_n
            s = torch.sum(kap + kappa0)
            a = torch.sum(kap * w) / s
            b = (torch.einsum('k,kd->d', w, stats.x)[None]
                 + kap.shape[0] * kappa0 * m0) / s
            rho = m0
            for _ in range(nb_iter - 1):
                rho = torch.addcmul(b, a, rho)
            mus = (kap[:, None] * rho + stats.x) / kappas_n[:, None]
            hyper = _hyper_mstep(prior, mus, stats)
    return HierTied(hyper=hyper, mus=mus, kappas=kappas_n, kappas0=kap)


def gibbs_update_exact(gen, prior: HierTied, stats: GaussStats):
    """The exact one-shot blocked draw from p(tau, Lambda, mu_{1:K} |
    labels, data): completing the square in each mu_k and then in tau
    leaves a pure Wishart in Lambda,

      c_k = kappa_k n_k / (kappa_k + n_k);  kap' = kappa0 + sum_k c_k
      m'  = (kappa0 m0 + sum_k c_k xbar_k) / kap'
      psi'^{-1} = Psi0^{-1} + sum_k [S_k - s_k s_k^T / n_k]
                  + kappa0 (m0 - m')(m0 - m')^T
                  + sum_k c_k (xbar_k - m')(xbar_k - m')^T
      nu' = nu0 + N,

    then Lambda ~ W(psi', nu'), tau | Lambda, mu_k | tau, Lambda.

    xbar_k = s_k / max(n_k, 1), and the scatter subtracts s_k s_k^T /
    max(n_k, 1). Gibbs counts are whole numbers, so this equals the
    reference's s_k / max(n_k, 1e-12) wherever n_k >= 1 and gives 0 for an
    empty component (s_k = 0); the reference's 1e-12 floor turns an empty
    component with s_k != 0 into 0 * inf = NaN in float32 (ROADMAP §C).
    Returns (posterior, GaussParams)."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1
    k, d = prior.size, prior.dim
    h = prior.hyper
    m0, kappa0, nu0 = h.mu[0], h.kappa[0], h.nu[0]

    n_div = torch.clamp(stats.n1, min=1.0)
    xbar = stats.x / n_div[:, None]
    c = kap * stats.n1 / kappas_n
    kap_h = kappa0 + torch.sum(c)
    m_h = (kappa0 * m0 + torch.einsum('k,kd->d', c, xbar)) / kap_h
    scatter = stats.xxT - _outer(stats.x, stats.x) / n_div[:, None, None]
    dm0 = m0 - m_h
    dmk = xbar - m_h[None, :]
    psi_inv = (inv_psd(h.psi)[0] + torch.sum(scatter, 0)
               + kappa0 * _outer(dm0, dm0)
               + torch.einsum('k,kd,ke->de', c, dmk, dmk))
    psi_h = inv_psd(psi_inv[None])                          # (1, d, d)
    nu_h = (nu0 + torch.sum(stats.n2))[None]                # (1,)

    lmbda = wishart_sample(gen, psi_h, nu_h)                # (1, d, d)
    chol1 = cholesky(lmbda)
    tau = scaled_normal_draw(gen, m_h[None], kap_h[None], chol1)[0]
    m_cond = (kap[:, None] * tau[None, :] + stats.x) / kappas_n[:, None]
    mus = scaled_normal_draw(gen, m_cond, kappas_n, chol1.expand(k, d, d))
    post = HierTied(hyper=NIW(mu=m_h[None], kappa=kap_h[None], psi=psi_h,
                              nu=nu_h),
                    mus=m_cond, kappas=kappas_n, kappas0=kap)
    return post, GaussParams(mu=mus, lmbda=lmbda.expand(k, d, d))


def _e_lmbda(p: HierTied):
    """The shared E[Lambda] = nu psi of the hyper-posterior, (1, d, d)."""
    return p.hyper.nu[:, None, None] * p.hyper.psi


def expected_log_likelihood(p: HierTied, x):
    """E_q[log N(x | mu_k, Lambda^{-1})] -> (N, K). The q(mu_k) covariance
    adds tr(E[Lambda] Omega_k^{-1}) = d / kappa'_k."""
    d = x.shape[-1]
    quad = quad_form(x, _e_lmbda(p).expand(p.size, d, d), p.mus)
    e_logdet = wishart_expected_logdet(cholesky(p.hyper.psi), p.hyper.nu)[0]
    return 0.5 * (e_logdet - d * LOG2PI) - 0.5 * (quad + d / p.kappas)


def kl_divergence(q: HierTied, p: HierTied):
    """Per-component negative ELBO contribution -(vlb_k), with the
    reference's convention of counting the hyper KL once per component."""
    d = q.dim
    h = q.hyper
    kl_hyper = _niw.kl_divergence(h, p.hyper)[0]
    e_lmbda = _e_lmbda(q)
    e_logdet = wishart_expected_logdet(cholesky(h.psi), h.nu)[0]
    dm = q.mus - h.mu[0][None, :]
    quad = torch.einsum('kd,dl,kl->k', dm, e_lmbda[0], dm)
    logdet_e_lmbda = chol_logdet(cholesky(e_lmbda))[0]
    # entropy of q(mu_k): Omega_k = kappa'_k E[Lambda]
    ent_k = (0.5 * d * (LOG2PI + 1.0)
             - 0.5 * (d * torch.log(q.kappas) + logdet_e_lmbda))
    vlb_k = (-kl_hyper + ent_k - 0.5 * d * LOG2PI
             + 0.5 * d * torch.log(q.kappas0) + 0.5 * e_logdet
             - 0.5 * q.kappas0 * d / h.kappa[0]
             - 0.5 * q.kappas0 * quad
             - 0.5 * q.kappas0 * d / q.kappas)
    return -vlb_k


def svi_blend(post: HierTied, prior: HierTied, stats: GaussStats,
              scale, step, nb_iter: int = 1) -> HierTied:
    """Stochastic inner updates: `nb_iter` rounds blending the q(mu_k)
    natural parameters (kappa mu, kappa) and then the hyper-posterior's
    toward the scaled statistics' targets."""
    kap = prior.kappas0
    sx, sn = stats.x / scale, stats.n1 / scale
    scaled = GaussStats(x=sx, n1=sn, xxT=stats.xxT / scale, n2=sn)
    hyper, mus, kappas = post.hyper, post.mus, post.kappas
    with _inner_rounds(nb_iter):
        for _ in range(nb_iter):
            tau = hyper.mu[0]
            nat1 = ((1.0 - step) * (kappas[:, None] * mus)
                    + step * (kap[:, None] * tau[None, :] + sx))
            kappas = (1.0 - step) * kappas + step * (kap + sn)
            mus = nat1 / kappas[:, None]
            target = _hyper_mstep(prior, mus, scaled)
            hyper = _niw.std_from_nat(GaussStats(*(
                (1.0 - step) * a + step * b
                for a, b in zip(_niw.nat_from_std(hyper),
                                _niw.nat_from_std(target)))))
    return HierTied(hyper=hyper, mus=mus, kappas=kappas, kappas0=kap)


def sample_params(gen, p: HierTied) -> GaussParams:
    """Per-component (mu_k, Lambda_k): K independent hyper draws for
    Lambda, mu_k ~ q(mu_k) given that Lambda."""
    k, d = p.size, p.dim
    lmbdas = wishart_sample(gen, p.hyper.psi.expand(k, d, d),
                            p.hyper.nu.expand(k))
    return GaussParams(mu=scaled_normal_draw(gen, p.mus, p.kappas,
                                       cholesky(lmbdas)),
                       lmbda=lmbdas)


def mode_params(p: HierTied) -> GaussParams:
    """Plug-in at the posterior mode: the q-means and the shared hyper
    mode (nu - d) psi."""
    lmbda = (p.hyper.nu - p.dim)[:, None, None] * p.hyper.psi
    return GaussParams(mu=p.mus, lmbda=lmbda.expand(p.size, p.dim, p.dim))


def mean_params(p: HierTied) -> GaussParams:
    return GaussParams(mu=p.mus,
                       lmbda=_e_lmbda(p).expand(p.size, p.dim, p.dim))


def predictive_studentt_params(p: HierTied):
    """(mus (K, d), lmbdas (K, d, d), dfs (K,)) of the per-component
    predictive: df = nu - d + 1 and precision df psi, shared over K (no
    kappa factor, as in the reference)."""
    df = p.hyper.nu - p.dim + 1.0                           # (1,)
    lmbdas = (df[:, None, None] * p.hyper.psi).expand(p.size, p.dim, p.dim)
    return p.mus, lmbdas, df.expand(p.size)


def log_predictive_gaussian(p: HierTied, x):
    mus, lmbdas, _ = predictive_studentt_params(p)
    return mvn_logpdf(x, mus, lmbdas)


def log_predictive_studentt(p: HierTied, x):
    mus, lmbdas, dfs = predictive_studentt_params(p)
    return mvt_logpdf(x, mus, lmbdas, dfs)
