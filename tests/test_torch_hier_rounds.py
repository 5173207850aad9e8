"""The hierarchical VI update's inner rounds (`hierarchical.posterior_update`)
against the round-by-round coordinate ascent they collapse: every leaf
of the update, in float64 and in float32, over `nb_iter` in {0, 1, 2, 7,
25} and statistics with occupied, one-point, near-empty and empty
components; chains under torch.func.vmap against the chains one by one;
and the batched Choleskys an update, two whatever the rounds."""

import pytest
import torch

from mimo_tpu_torch.distributions import hierarchical
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.niw import NIW, GaussStats
from mimo_tpu_torch.utils import linalg
from mimo_tpu_torch.utils.linalg import inv_psd

K, D = 8, 2
ROUNDS = [0, 1, 2, 7, 25]


def oracle_mstep(prior, mus, stats):
    """The K-averaged NW hyper-posterior update, written out on its own."""
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


def oracle_update(prior, stats, nb_iter):
    """Round by round: the q(mu_k) e-step with the current hyper mean,
    then the whole hyper m-step, `nb_iter` times."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1
    hyper, mus = prior.hyper, prior.mus
    for _ in range(nb_iter):
        mus = (kap[:, None] * hyper.mu + stats.x) / kappas_n[:, None]
        hyper = oracle_mstep(prior, mus, stats)
    return HierTied(hyper=hyper, mus=mus, kappas=kappas_n, kappas0=kap)


def make_prior(dtype, seed=0):
    """A hyper-prior off the origin with its own psi, and kappas0 that
    differ by component."""
    g = torch.Generator().manual_seed(seed)
    m0 = torch.tensor([[0.5, -1.5]], dtype=torch.float64)
    a = torch.randn(D, D, generator=g, dtype=torch.float64)
    psi = (a @ a.T + D * torch.eye(D, dtype=torch.float64))[None] * 0.1
    hyper = NIW(mu=m0, kappa=torch.tensor([1e-2], dtype=torch.float64),
                psi=psi, nu=torch.tensor([D + 2.0], dtype=torch.float64))
    kappas0 = 0.02 + 0.1 * torch.rand(K, generator=g, dtype=torch.float64)
    prior = HierTied(hyper=hyper, mus=m0.expand(K, D), kappas=kappas0,
                     kappas0=kappas0)
    return HierTied(*(t.to(dtype) if isinstance(t, torch.Tensor)
                      else NIW(*(u.to(dtype) for u in t)) for t in prior))


def make_stats(dtype, seed=0):
    """Soft statistics of 3,000 points from three blobs: three occupied
    components, one that holds a single point, two near empty (VI's
    tails) and two empty."""
    g = torch.Generator().manual_seed(seed)
    c = torch.tensor([[-3., 0.], [3., 0.], [0., 4.]], dtype=torch.float64)
    n = 3000
    x = c[torch.arange(n) % 3] + 0.7 * torch.randn(n, D, generator=g,
                                                      dtype=torch.float64)
    r = torch.zeros(n, K, dtype=torch.float64)
    r[torch.arange(n), torch.arange(n) % 3] = 1.0
    r[:, 4:6] = 1e-4 * torch.rand(n, 2, generator=g, dtype=torch.float64)
    r[0] = 0.0
    r[0, 3] = 1.0
    r = r / r.sum(1, keepdim=True)
    n1 = r.sum(0)
    stats = GaussStats(x=r.T @ x, n1=n1,
                       xxT=torch.einsum('nk,nd,ne->kde', r, x, x), n2=n1)
    assert bool((n1[6:] == 0).all()) and float(n1[3]) == pytest.approx(1.0)
    return GaussStats(*(t.to(dtype) for t in stats))


def leaves(p):
    h = p.hyper
    return {'hyper.mu': h.mu, 'hyper.kappa': h.kappa, 'hyper.psi': h.psi,
            'hyper.nu': h.nu, 'mus': p.mus, 'kappas': p.kappas}


def assert_leaves_close(got, want, rtol):
    for name, b in leaves(want).items():
        a = leaves(got)[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=rtol * float(b.abs().max()),
                                   msg=name)


@pytest.mark.parametrize('dtype,rtol', [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('nb_iter', ROUNDS)
def test_update_matches_the_round_by_round_oracle(nb_iter, dtype, rtol):
    prior, stats = make_prior(dtype), make_stats(dtype)
    got = hierarchical.posterior_update(prior, stats, nb_iter)
    assert_leaves_close(got, oracle_update(prior, stats, nb_iter), rtol)
    if nb_iter == 0:
        assert got.hyper is prior.hyper and got.mus is prior.mus


@pytest.mark.parametrize('nb_iter', [1, 25])
def test_update_under_vmap_matches_chains_one_by_one(nb_iter):
    prior = make_prior(torch.float64)
    chains = [make_stats(torch.float64, seed) for seed in range(3)]
    stacked = GaussStats(*(torch.stack(t) for t in zip(*chains)))
    got = torch.func.vmap(
        lambda s: hierarchical.posterior_update(prior, s, nb_iter))(stacked)
    for c, stats in enumerate(chains):
        one = hierarchical.posterior_update(prior, stats, nb_iter)
        chain = HierTied(NIW(*(t[c] for t in got.hyper)),
                         *(t[c] for t in got[1:]))
        assert_leaves_close(chain, one, 1e-12)


@pytest.mark.parametrize('nb_iter', [1, 7, 25])
def test_update_factors_twice_whatever_the_rounds(nb_iter):
    """One update: the m-step's two Choleskys (the hyper-prior's psi and
    the posterior's), where a round-by-round update makes 2 nb_iter; its
    rounds are all counted."""
    prior, stats = make_prior(torch.float32), make_stats(torch.float32)
    linalg.counts.update(cholesky=0, solve=0)
    hierarchical.counts.update(rounds=0, updates=0)
    hierarchical.posterior_update(prior, stats, nb_iter)
    assert linalg.counts == {'cholesky': 2, 'solve': 2}
    assert hierarchical.counts == {'rounds': nb_iter, 'updates': 1}
