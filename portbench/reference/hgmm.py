"""Plain PyTorch reference of the hierarchical DP-GMM: stick-breaking
weights over Gaussians whose K means share one Normal-Wishart hyper-prior
and one precision (the upstream's BayesianMixtureOfGaussiansWithHierarchical
Prior over TiedGaussiansWithHierarchicalNormalWisharts,
https://github.com/hanyas/mimo, mimo/mixtures/hgmm.py and
mimo/distributions/bayesian.py).

Written from the model's equations, for the benchmark to judge the
port's outputs with. It imports torch and the reference's own modules
(dpgmm.py for the stick-breaking gating, the features, the Normal-Wishart
KL and the statistics; precision.py for the control's products): no
kernel, no part of the measured package. Every function works on any
device and in any dtype, batched over a leading chain axis C.

Model:
    (tau, Lambda) ~ NW(m0, kappa0, psi0, nu0)           (the hyper-prior)
    mu_k | tau, Lambda ~ N(tau, (kappa0_k Lambda)^-1),  k = 1..K
    x | z = k ~ N(mu_k, Lambda^-1);
weights by stick-breaking, as reference/dpgmm.py has them.

Mean-field q(tau, Lambda) q(mu_1..K) q(v), q(tau, Lambda) = NW(m, kappa,
psi, nu) (the hyper-posterior), q(mu_k) = N(mus_k, (kappas_k E[Lambda])^-1),
kappas_k = kappa0_k + n_k. The update and the ELBO are the upstream's,
which departs from textbook mean-field in four places, kept here because
they are the behaviour the benchmark holds the port to:

  1. The hyper-posterior is the K-averaged update: each component gives
     the Normal-Wishart update of one replicate of (tau, Lambda) from its
     mu_k and its points, and the hyper-posterior is their average,
         m     = sum_k (kappa0_k mus_k + kappa0 m0) / sum_k (kappa0_k + kappa0)
         kappa = sum_k (kappa0_k + kappa0) / K
         psi^-1 = psi0^-1 + (1/K) sum_k [c_k (m0 - mus_k)(m0 - mus_k)^T
                  + S_k - mus_k s_k^T - s_k mus_k^T + n_k mus_k mus_k^T],
                  c_k = kappa0 kappa0_k / (kappa0 + kappa0_k)
         nu    = sum_k (nu0 + n_k + 1) / K,
     where the exact posterior would sum the K terms.
  2. q(mu_k) and q(tau, Lambda) are found by `nb_iter` rounds of
     coordinate ascent, mus_k = (kappa0_k m + s_k) / kappas_k then the
     hyper update, the final mus the last round's; each update restarts
     from the hyper-prior (the upstream goes on from the previous
     update's hyper-posterior; the fixed point given the statistics is
     the same).
  3. The expected log-likelihood of x under component k is
     E log|Lambda| / 2 - d log(2 pi) / 2
     - [(x - mus_k)^T E[Lambda] (x - mus_k) + d / kappas_k] / 2, the
     q(mu_k) covariance taken as (kappas_k E[Lambda])^-1.
  4. The ELBO counts the hyper KL once per component: its component term
     is sum_k vlb_k,
         vlb_k = -KL(q(tau, Lambda) || p(tau, Lambda)) + H[q(mu_k)]
                 + E log p(mu_k | tau, Lambda),
     with E log p(mu_k | .) = d log(kappa0_k) / 2 - d log(2 pi) / 2
     + E log|Lambda| / 2 - kappa0_k [d / kappa + (mus_k - m)^T E[Lambda]
     (mus_k - m) + d / kappas_k] / 2.

A posterior is a dict of tensors: hyper_mu (C, d), hyper_kappa (C,),
hyper_psi (C, d, d), hyper_nu (C,), mus (C, K, d), kappas (C, K),
kappas0 (C, K), gamma (C, K), delta (C, K). A prior is the hyper-prior's
mu (d,), kappa, psi (d, d), nu, the components' kappas0 (K,) and alpha.

`mode` selects the arithmetic as in dpgmm.py: 'f64' is the reference,
'tf32' the control (float32, the two per-point products on operands
rounded to TF32). The data term of the hyper update is formed centred,
sum_k [S_k - n_k xbar_k xbar_k^T + n_k (xbar_k - mus_k)(xbar_k - mus_k)^T],
which equals the upstream's sum and does not cancel sums of 1e7 points
against each other.
"""

import math

import torch

from reference import dpgmm
from reference.dpgmm import (block_rows, cast, dtype_of, e_log_pi, e_logdet,
                             features, logdet, sb_kl, sb_update,
                             stats_from_resp)
from reference.precision import matmul

LOG2PI = math.log(2.0 * math.pi)
NB_ITER = 25
HYPER = ('mu', 'kappa', 'psi', 'nu')
LEAVES = tuple(f'hyper_{k}' for k in HYPER) + ('mus', 'kappas', 'kappas0',
                                               'gamma', 'delta')


def make_prior(make, d, dtype, device):
    """The prior of BayesianGMM.make(hierarchical=True, gating='dp',
    alpha, kappa, psi_scale): the hyper-prior NW(0, kappa, psi_scale I,
    d + 2) and kappa0_k = 1 for each of the `size` components."""
    kw = dict(dtype=dtype, device=device)
    return dict(mu=torch.zeros(d, **kw),
                kappa=torch.tensor(float(make['kappa']), **kw),
                psi=float(make['psi_scale']) * torch.eye(d, **kw),
                nu=torch.tensor(float(make.get('nu') or d + 2), **kw),
                kappas0=torch.ones(int(make['size']), **kw),
                alpha=torch.tensor(float(make['alpha']), **kw))


def hyper_of(post):
    """The hyper-posterior of a posterior as an NW dict (C, ...)."""
    return {k: post[f'hyper_{k}'] for k in HYPER}


def data_term(counts, sx, sxx, mus):
    """sum_k [S_k - mus_k s_k^T - s_k mus_k^T + n_k mus_k mus_k^T], centred
    (C, d, d)."""
    xbar = sx / counts.clamp(min=1e-12)[..., None]
    dm = xbar - mus
    n = counts[..., None, None]
    return (sxx - n * xbar[..., :, None] * xbar[..., None, :]
            + n * dm[..., :, None] * dm[..., None, :]).sum(-3)


def hyper_update(prior, mus, counts, sx, sxx):
    """Departure 1: the K-averaged Normal-Wishart update from the q(mu_k)
    means mus (C, K, d) and the statistics."""
    k = mus.shape[-2]
    m0, kappa0, kap = prior['mu'], prior['kappa'], prior['kappas0']
    total = (kap + kappa0).sum()
    mu = (kap[:, None] * mus + kappa0 * m0).sum(-2) / total
    c = kappa0 * kap / (kappa0 + kap)
    dm = m0 - mus
    spread = (c[:, None, None] * dm[..., :, None] * dm[..., None, :]).sum(-3)
    psi_inv = (torch.linalg.inv(prior['psi'])
               + (spread + data_term(counts, sx, sxx, mus)) / k)
    psi_inv = 0.5 * (psi_inv + psi_inv.transpose(-1, -2))
    nu = (prior['nu'] + counts + 1.0).sum(-1) / k
    return dict(mu=mu, kappa=(total / k).expand(nu.shape),
                psi=torch.linalg.inv(psi_inv), nu=nu)


def hier_update(prior, counts, sx, sxx, nb_iter=NB_ITER):
    """Departure 2: `nb_iter` rounds of q(mu_k), then the hyper update,
    from the hyper-prior; counts (C, K), sx (C, K, d), sxx (C, K, d, d)."""
    kap = prior['kappas0']
    kappas = kap + counts
    hyper = {k: prior[k].expand(counts.shape[:-1] + prior[k].shape)
             for k in HYPER}
    for _ in range(nb_iter):
        mus = ((kap[:, None] * hyper['mu'][..., None, :] + sx)
               / kappas[..., None])
        hyper = hyper_update(prior, mus, counts, sx, sxx)
    out = {f'hyper_{k}': v for k, v in hyper.items()}
    return dict(out, mus=mus, kappas=kappas,
                kappas0=kap.expand(kappas.shape))


def posterior(prior, counts, sx, sxx, nb_iter=NB_ITER):
    return {**hier_update(prior, counts, sx, sxx, nb_iter),
            **sb_update(prior, counts)}


def e_lambda(hyper):
    return hyper['nu'][..., None, None] * hyper['psi']


def ell_theta(post, log_w):
    """Coefficients (C, K, m) with departure 3's expected log-likelihood
    + log_w = features(x) . theta."""
    hyper = hyper_of(post)
    d = hyper['mu'].shape[-1]
    a = e_lambda(hyper)                                    # (C, d, d)
    am = torch.einsum('cde,cke->ckd', a, post['mus'])
    const = (0.5 * e_logdet(hyper)[..., None] - 0.5 * d * LOG2PI
             - 0.5 * d / post['kappas'] - 0.5 * (post['mus'] * am).sum(-1))
    quad = (-0.5 * a).flatten(-2)[..., None, :].expand(am.shape[:-1]
                                                       + (d * d,))
    return torch.cat([(const + log_w)[..., None], am, quad], -1)


def component_kl(post, prior):
    """Departure 4: -vlb_k (C, K), the hyper KL counted in every
    component's term."""
    hyper = hyper_of(post)
    d = hyper['mu'].shape[-1]
    kl_hyper = dpgmm.niw_kl(hyper, prior)                  # (C,)
    a = e_lambda(hyper)
    eld = e_logdet(hyper)
    dm = post['mus'] - hyper['mu'][..., None, :]
    quad = torch.einsum('ckd,cde,cke->ck', dm, a, dm)
    kap0, kappas = post['kappas0'], post['kappas']
    entropy = (0.5 * d * (LOG2PI + 1.0)
               - 0.5 * (d * torch.log(kappas) + logdet(a)[..., None]))
    e_log_p = (0.5 * d * torch.log(kap0) - 0.5 * d * LOG2PI
               + 0.5 * eld[..., None]
               - 0.5 * kap0 * (d / hyper['kappa'][..., None] + quad
                               + d / kappas))
    return kl_hyper[..., None] - entropy - e_log_p


def positive_definite(post):
    return bool((torch.linalg.cholesky_ex(post['hyper_psi'])[1] == 0).all())


def vi_fit(x, prior, start, maxiter, mode='f64', nb_iter=NB_ITER):
    """Mean-field VI from `start` for `maxiter` sweeps: (the posterior
    after the last sweep, the ELBO trace (C, sweeps), ELBO t of the state
    before sweep t). The ELBO is sum_n logsumexp_k [E log pi_k +
    ell_k(x_n)] - sum_k KL_k(components) - KL(sticks). In the control's
    precision an update can leave a hyper scale that is not positive
    definite; the fit then stops with that update, as many sweeps as its
    trace."""
    dt = dtype_of(mode)
    prior, post = cast(prior, dt), cast(start, dt)
    n, d = x.shape
    c, k = post['kappas'].shape
    m = 1 + d + d * d
    rows = block_rows(max(m, c * k))
    trace = []
    for _ in range(maxiter):
        theta = ell_theta(post, e_log_pi(post)).reshape(c * k, m)
        s = x.new_zeros((c, k, m), dtype=dt)
        lse_sum = x.new_zeros((c,), dtype=dt)
        for lo in range(0, n, rows):
            f = features(x[lo:lo + rows].to(dt))
            logits = matmul(f, theta.T, mode).reshape(-1, c, k)
            lse = torch.logsumexp(logits, -1)
            resp = torch.exp(logits - lse[..., None])
            lse_sum += lse.sum(0)
            s += matmul(resp.reshape(-1, c * k).T, f, mode).reshape(c, k, m)
        elbo = (lse_sum - component_kl(post, prior).sum(-1)
                - sb_kl(post, prior))
        stats = (s[..., 0], s[..., 1:1 + d],
                 s[..., 1 + d:].reshape(c, k, d, d))
        post = posterior(prior, *stats, nb_iter=nb_iter)
        trace.append(elbo)
        if mode != 'f64' and not positive_definite(post):
            break
    return post, torch.stack(trace, -1)


def anchor_start(x, make, chains, g, sub=65536):
    """Each chain's starting posterior in float64 (C, ...): `sub` points
    drawn with `g`, each assigned to the nearest of the first K of them,
    their statistics scaled to the N points and taken through the update
    (departures 1 and 2)."""
    k, (n, d) = int(make['size']), x.shape
    prior = make_prior(make, d, torch.float64, x.device)
    stats = []
    for _ in range(chains):
        pts = x[torch.randint(0, n, (sub,), generator=g,
                              device=x.device)].double()
        z = torch.argmin(torch.cdist(pts, pts[:k]), 1)
        resp = torch.nn.functional.one_hot(z, k).double()[:, None, :]
        stats.append([s[0] * (n / sub) for s in stats_from_resp(pts, resp)])
    counts, sx, sxx = (torch.stack(s) for s in zip(*stats))
    return posterior(prior, counts, sx, sxx,
                     nb_iter=int(make.get('maxsubiter', NB_ITER)))
