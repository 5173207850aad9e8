"""The port's diagonal conjugate algebra against mimo_tpu, in float64 at
rtol 1e-8 on the same numpy inputs: Normal-Gamma components
(distributions/ng.py), Matrix-Normal-Gamma experts (distributions/mng.py)
and the families built on them; plus moment tests of the Gamma, NG and
MNG samplers (the port's generator cannot match JAX's draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.conjugate.families as jfam
import mimo_tpu.distributions.mng as jmg
import mimo_tpu.distributions.mnw as jmw
import mimo_tpu.distributions.ng as jng
import mimo_tpu.distributions.niw as jniw

import mimo_tpu_torch.conjugate.families as tfam
import mimo_tpu_torch.distributions.mng as tmg
import mimo_tpu_torch.distributions.mnw as tmw
import mimo_tpu_torch.distributions.ng as tng
import mimo_tpu_torch.distributions.niw as tniw
from mimo_tpu_torch.bridge import state_to_numpy as _np_tree
from mimo_tpu_torch.distributions.wishart import gamma_sample

torch.set_num_threads(1)
RTOL = 1e-8


def _close(a, b, rtol=RTOL, atol=1e-10):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _close(u, v, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _psd(rng, k, d, scale=1.0):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _both(arrays, cls_j, cls_t):
    return (cls_j(**{f: jnp.asarray(v) for f, v in arrays.items()}),
            cls_t(**{f: torch.as_tensor(v) for f, v in arrays.items()}))


def _ng(rng, k, d):
    return dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(0.5, 20.0, (k, d)),
                alpha=rng.uniform(1.5, 30.0, (k, d)),
                beta=rng.uniform(0.3, 6.0, (k, d)))


def _mng(rng, k, p, q):
    return dict(M=rng.standard_normal((k, p, q)), K_=_psd(rng, k, q, 2.0),
                alpha=rng.uniform(2.5, 30.0, (k, p)),
                beta=rng.uniform(0.3, 6.0, (k, p)))


NG_FNS = ['suff_stats', 'posterior_update', 'expected_log_likelihood',
          'log_partition', 'kl_divergence', 'mode_params', 'mean_params',
          'log_likelihood', 'predictive_studentt_params',
          'log_predictive_studentt', 'log_predictive_gaussian']


@pytest.mark.parametrize('d', [1, 3])
@pytest.mark.parametrize('fn', NG_FNS)
def test_ng_matches_jax(fn, d):
    rng = np.random.default_rng(3 * d + NG_FNS.index(fn))
    k, n = 4, 50
    pj, pt = _both(_ng(rng, k, d), jng.NG, tng.NG)
    x = rng.standard_normal((n, d)) * 2
    xj, xt = jnp.asarray(x), torch.tensor(x)
    resp = rng.dirichlet(np.ones(k), n)
    if fn == 'suff_stats':
        want = jng.suff_stats(xj, jnp.asarray(resp))
        got = tng.suff_stats(xt, torch.tensor(resp))
    elif fn == 'posterior_update':
        want = jng.posterior_update(pj, jng.suff_stats(xj, jnp.asarray(resp)))
        got = tng.posterior_update(pt, tng.suff_stats(xt, torch.tensor(resp)))
    elif fn == 'kl_divergence':
        qj, qt = _both(_ng(rng, k, d), jng.NG, tng.NG)
        want, got = jng.kl_divergence(qj, pj), tng.kl_divergence(qt, pt)
    elif fn == 'log_likelihood':
        pars = dict(mu=rng.standard_normal((k, d)),
                    lmbda_diag=rng.uniform(0.2, 4.0, (k, d)))
        want = jng.log_likelihood(jng.DiagGaussParams(
            **{f: jnp.asarray(v) for f, v in pars.items()}), xj)
        got = tng.log_likelihood(tng.DiagGaussParams(
            **{f: torch.tensor(v) for f, v in pars.items()}), xt)
    elif fn in ('expected_log_likelihood', 'log_predictive_studentt',
                'log_predictive_gaussian'):
        want, got = getattr(jng, fn)(pj, xj), getattr(tng, fn)(pt, xt)
    else:
        want, got = getattr(jng, fn)(pj), getattr(tng, fn)(pt)
    _close(_np_tree(got), want)


MNG_FNS = ['posterior_update', 'expected_log_likelihood', 'log_partition',
           'kl_divergence', 'mode_params', 'mean_params', 'log_likelihood',
           'predictive_studentt_params', 'log_predictive_studentt',
           'log_predictive_gaussian', 'predictive_moments_studentt',
           'predictive_moments_gaussian']


@pytest.mark.parametrize('p,q', [(1, 2), (3, 3)])
@pytest.mark.parametrize('fn', MNG_FNS)
def test_mng_matches_jax(fn, p, q):
    rng = np.random.default_rng(7 * p + q + 11 * MNG_FNS.index(fn))
    k, n = 4, 60
    pj, pt = _both(_mng(rng, k, p, q), jmg.MNG, tmg.MNG)
    x = rng.standard_normal((n, q - 1))
    xa = np.concatenate([x, np.ones((n, 1))], -1)
    y = rng.standard_normal((n, p))
    xj, yj, xt, yt = (jnp.asarray(xa), jnp.asarray(y), torch.tensor(xa),
                      torch.tensor(y))
    if fn == 'posterior_update':
        resp = rng.dirichlet(np.ones(k), n)
        want = jmg.posterior_update(pj, jmw.suff_stats(xj, yj,
                                                       jnp.asarray(resp)))
        got = tmg.posterior_update(pt, tmw.suff_stats(xt, yt,
                                                      torch.tensor(resp)))
    elif fn == 'kl_divergence':
        qj, qt = _both(_mng(rng, k, p, q), jmg.MNG, tmg.MNG)
        want, got = jmg.kl_divergence(qj, pj), tmg.kl_divergence(qt, pt)
    elif fn == 'log_likelihood':
        pars = dict(A=rng.standard_normal((k, p, q)),
                    lmbda_diag=rng.uniform(0.2, 4.0, (k, p)))
        want = jmg.log_likelihood(jmg.DiagLinGaussParams(
            **{f: jnp.asarray(v) for f, v in pars.items()}), xj, yj)
        got = tmg.log_likelihood(tmg.DiagLinGaussParams(
            **{f: torch.tensor(v) for f, v in pars.items()}), xt, yt)
    elif fn in ('expected_log_likelihood', 'log_predictive_studentt',
                'log_predictive_gaussian'):
        want, got = getattr(jmg, fn)(pj, xj, yj), getattr(tmg, fn)(pt, xt, yt)
    elif fn.startswith('predictive_'):
        want, got = getattr(jmg, fn)(pj, xj), getattr(tmg, fn)(pt, xt)
    else:
        want, got = getattr(jmg, fn)(pj), getattr(tmg, fn)(pt)
    _close(_np_tree(got), want)


def test_standard_priors_match_jax():
    _close(_np_tree(tng.NG.standard(3, 2, mean=[1.0, -2.0], kappa=0.05,
                                    dtype=torch.float64)),
           jng.NG.standard(3, 2, mean=[1.0, -2.0], kappa=0.05,
                           dtype=jnp.float64))
    got = tmg.MNG.standard(3, 2, 4, K_scale=0.1, dtype=torch.float64)
    _close(_np_tree(got), jmg.MNG.standard(3, 2, 4, K_scale=0.1,
                                           dtype=jnp.float64))
    assert (got.row_dim, got.col_dim) == (2, 4)


FAMILY_FNS = ['suff_stats', 'update', 'ell', 'loglik', 'kl', 'mean_params',
              'log_predictive', 'log_predictive_gaussian']


@pytest.mark.parametrize('which', ['diag_gaussian', 'ilr_diag'])
@pytest.mark.parametrize('fn', FAMILY_FNS)
def test_diag_families_match_jax(fn, which):
    """The NG family, and the ILR product of an NIW basis with MNG
    experts."""
    rng = np.random.default_rng(5 + FAMILY_FNS.index(fn))
    k, n, d, p = 3, 40, 2, 2
    x, y = rng.standard_normal((n, d)), rng.standard_normal((n, p))
    if which == 'diag_gaussian':
        fj, ft = jfam.diag_gaussian_family(), tfam.diag_gaussian_family()
        pj, pt = _both(_ng(rng, k, d), jng.NG, tng.NG)
        dj, dt = (jnp.asarray(x),), (torch.tensor(x),)
    else:
        fj, ft = jfam.ilr_family(diag=True), tfam.ilr_family(diag=True)
        niw = dict(mu=rng.standard_normal((k, d)), kappa=rng.uniform(1, 3, k),
                   psi=_psd(rng, k, d, 0.3), nu=rng.uniform(d + 2, d + 9, k))
        bj, bt = _both(niw, jniw.NIW, tniw.NIW)
        ej, et = _both(_mng(rng, k, p, d + 1), jmg.MNG, tmg.MNG)
        pj, pt = (bj, ej), (bt, et)
        dj, dt = (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x),
                                                    torch.tensor(y))
    resp = rng.dirichlet(np.ones(k), n)
    if fn == 'suff_stats':
        want = fj.suff_stats(dj, jnp.asarray(resp))
        got = ft.suff_stats(dt, torch.tensor(resp))
    elif fn == 'update':
        want = fj.update(pj, fj.suff_stats(dj, jnp.asarray(resp)))
        got = ft.update(pt, ft.suff_stats(dt, torch.tensor(resp)))
    elif fn == 'kl':
        want, got = fj.kl(pj, pj), ft.kl(pt, pt)
    elif fn == 'loglik':
        want = fj.loglik(fj.mode_params(pj), dj)
        got = ft.loglik(ft.mode_params(pt), dt)
    elif fn == 'mean_params':
        want, got = fj.mean_params(pj), ft.mean_params(pt)
    else:
        want, got = getattr(fj, fn)(pj, dj), getattr(ft, fn)(pt, dt)
    _close(_np_tree(got), want, atol=1e-9)


def test_gamma_sampler_has_the_gamma_moments():
    """Gamma(conc, 1) from the explicit generator: mean conc, variance
    conc, over 200,000 draws at each concentration, within 5 standard
    errors; the same generator seed gives the same draws."""
    conc = torch.tensor([0.3, 1.0, 2.5, 40.0], dtype=torch.float64)
    draws = gamma_sample(torch.Generator().manual_seed(2),
                         conc.expand(200000, 4))
    again = gamma_sample(torch.Generator().manual_seed(2),
                         conc.expand(200000, 4))
    assert torch.equal(draws, again)
    n = draws.shape[0]
    mean, var = draws.mean(0), draws.var(0)
    assert bool(((mean - conc).abs() <= 5 * torch.sqrt(conc / n)).all())
    # var of the sample variance of a Gamma: (mu4 - sigma^4) / n with
    # mu4 = 3 c^2 + 6 c for Gamma(c, 1)
    se_var = torch.sqrt((3 * conc ** 2 + 6 * conc - conc ** 2) / n)
    assert bool(((var - conc).abs() <= 5 * se_var).all())


def test_ng_draws_have_the_posterior_moments():
    """(mu, lambda) ~ NG: E[lambda] = alpha / beta, Var[lambda] =
    alpha / beta^2, E[mu] = m, Var[mu] = beta / (kappa (alpha - 1)),
    over 100,000 draws, within 5 standard errors."""
    m = np.array([1.5, -2.0])
    kappa, alpha, beta = (np.array([2.0, 0.5]), np.array([3.0, 8.0]),
                          np.array([1.5, 4.0]))
    draws = 100000
    post = tng.NG(*(torch.tensor(v).expand(draws, 2)
                    for v in (m, kappa, alpha, beta)))
    s = tng.sample_params(torch.Generator().manual_seed(4), post)
    lm, mu = s.lmbda_diag.numpy(), s.mu.numpy()
    for samples, want in ((lm, alpha / beta), (mu, m),
                          ((lm - alpha / beta) ** 2, alpha / beta ** 2),
                          ((mu - m) ** 2, beta / (kappa * (alpha - 1)))):
        z = np.abs(samples.mean(0) - want) / (samples.std(0)
                                              / np.sqrt(draws))
        assert z.max() < 5.0, (z, samples.mean(0), want)


def test_mng_draws_have_the_posterior_moments():
    """A = M + lambda^{-1/2} Z chol(K)^{-1} per output row, lambda_i ~
    Gamma(alpha_i) / beta_i, over 60,000 draws with a strongly
    non-diagonal K: E[lambda_i] = alpha_i / beta_i, E[A] = M and
    E[(a_i - M_i)^T (a_i - M_i)] = beta_i / (alpha_i - 1) K^{-1}, each
    entry within 5 standard errors. Solving against chol(K) itself
    instead of its transpose fails the last identity."""
    rng = np.random.default_rng(9)
    p, q, draws = 2, 3, 60000
    kk = np.array([[4.0, 1.8, -1.2], [1.8, 2.0, 0.6], [-1.2, 0.6, 1.5]])
    alpha, beta = np.array([4.0, 9.0]), np.array([2.0, 3.0])
    m = rng.standard_normal((p, q))
    post = tmg.MNG(M=torch.tensor(m).expand(draws, p, q),
                   K_=torch.tensor(kk).expand(draws, q, q),
                   alpha=torch.tensor(alpha).expand(draws, p),
                   beta=torch.tensor(beta).expand(draws, p))
    s = tmg.sample_params(torch.Generator().manual_seed(12), post)
    a, lm = s.A.numpy(), s.lmbda_diag.numpy()
    dev = a - m
    cases = [(lm, alpha / beta), (a, m)]
    for i in range(p):
        cases.append((dev[:, i, :, None] * dev[:, i, None, :],
                      beta[i] / (alpha[i] - 1) * np.linalg.inv(kk)))
    for samples, want in cases:
        se = samples.std(0) / np.sqrt(draws)
        z = np.abs(samples.mean(0) - want) / se
        assert z.max() < 5.0, (z, samples.mean(0), want)
