"""The port's Matrix-Normal-Wishart algebra (distributions/mnw.py), the
Standardizer and the linear / product / ILR families against mimo_tpu, in
float64 at rtol 1e-8 on the same numpy inputs, plus a moment test of the
MNW sampler (the port's generator cannot match JAX's draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.conjugate.families as jfam
import mimo_tpu.distributions.mnw as jm
from mimo_tpu.utils.data import Standardizer as JStd

import mimo_tpu_torch.conjugate.families as tfam
import mimo_tpu_torch.distributions.mnw as tm
from mimo_tpu_torch.bridge import state_to_numpy as _np_tree
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.utils.data import Standardizer as TStd

torch.set_num_threads(1)
RTOL = 1e-8


def _close(a, b, rtol=RTOL, atol=1e-10):
    if isinstance(a, tuple):
        for u, v in zip(a, b):
            _close(u, v, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _psd(rng, k, d, scale=1.0):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _mnw(rng, k, p, q):
    return dict(M=rng.standard_normal((k, p, q)), K_=_psd(rng, k, q, 2.0),
                psi=_psd(rng, k, p, 0.4), nu=rng.uniform(p + 2.5, p + 30, k))


def _both(arrays, cls_j=jm.MNW, cls_t=tm.MNW):
    return (cls_j(**{f: jnp.asarray(v) for f, v in arrays.items()}),
            cls_t(**{f: torch.as_tensor(v) for f, v in arrays.items()}))


@pytest.mark.parametrize('p,q', [(1, 2), (2, 4)])
@pytest.mark.parametrize('fn', [
    'suff_stats', 'nat_from_std', 'std_from_nat', 'posterior_update',
    'expected_stats', 'expected_log_likelihood', 'log_partition',
    'kl_divergence', 'mode_params', 'mean_params', 'log_likelihood',
    'predictive_studentt_params', 'log_predictive_studentt',
    'log_predictive_gaussian', 'predictive_moments_studentt',
    'predictive_moments_gaussian'])
def test_mnw_matches_jax(fn, p, q):
    rng = np.random.default_rng(7 * p + q)
    k, n = 4, 60
    pj, pt = _both(_mnw(rng, k, p, q))
    x = rng.standard_normal((n, q - 1))
    xa = np.concatenate([x, np.ones((n, 1))], -1)
    y = rng.standard_normal((n, p))
    xj, yj, xt, yt = (jnp.asarray(xa), jnp.asarray(y), torch.tensor(xa),
                      torch.tensor(y))
    if fn == 'suff_stats':
        resp = rng.dirichlet(np.ones(k), n)
        want = jm.suff_stats(xj, yj, jnp.asarray(resp))
        got = tm.suff_stats(xt, yt, torch.tensor(resp))
    elif fn == 'std_from_nat':
        want = jm.std_from_nat(jm.nat_from_std(pj))
        got = tm.std_from_nat(tm.nat_from_std(pt))
    elif fn in ('posterior_update', 'kl_divergence'):
        qj, qt = _both(_mnw(rng, k, p, q))
        if fn == 'kl_divergence':
            want, got = jm.kl_divergence(qj, pj), tm.kl_divergence(qt, pt)
        else:
            stats = jm.suff_stats(xj, yj, jnp.asarray(
                rng.dirichlet(np.ones(k), n)))
            stats_t = tm.LinGaussStats(*(torch.tensor(np.asarray(a))
                                         for a in stats))
            want = jm.posterior_update(pj, stats)
            got = tm.posterior_update(pt, stats_t)
    elif fn == 'log_likelihood':
        pars = dict(A=rng.standard_normal((k, p, q)),
                    lmbda=_psd(rng, k, p, 2.0))
        want = jm.log_likelihood(
            jm.LinGaussParams(**{f: jnp.asarray(v) for f, v in pars.items()}),
            xj, yj)
        got = tm.log_likelihood(
            tm.LinGaussParams(**{f: torch.tensor(v)
                                 for f, v in pars.items()}), xt, yt)
    elif fn in ('expected_log_likelihood', 'log_predictive_studentt',
                'log_predictive_gaussian'):
        want = getattr(jm, fn)(pj, xj, yj)
        got = getattr(tm, fn)(pt, xt, yt)
    elif fn.startswith('predictive_'):
        want = getattr(jm, fn)(pj, xj)
        got = getattr(tm, fn)(pt, xt)
    else:
        want, got = getattr(jm, fn)(pj), getattr(tm, fn)(pt)
    _close(_np_tree(got), want)


@pytest.mark.parametrize('affine', [True, False])
def test_augment_puts_the_ones_column_last(affine):
    x = np.arange(6.0).reshape(3, 2)
    got = tm.augment(torch.tensor(x), affine).numpy()
    _close(got, jm.augment(jnp.asarray(x), affine))
    assert got.shape == ((3, 3) if affine else (3, 2))


def test_mnw_standard_prior_matches_jax():
    got = tm.MNW.standard(3, 2, 4, K_scale=0.1, psi_scale=0.5,
                          dtype=torch.float64)
    want = jm.MNW.standard(3, 2, 4, K_scale=0.1, psi_scale=0.5,
                           dtype=jnp.float64)
    _close(_np_tree(got), want)
    assert (got.row_dim, got.col_dim) == (2, 4)


def test_mnw_draws_have_the_posterior_moments():
    """A = M + chol(Lambda)^-T Z chol(K)^-1 over 40,000 draws of one
    posterior with a strongly non-diagonal column precision K:
      E[A] = M,
      E[(A - M)^T (A - M)] = tr(psi^-1) / (nu - p - 1) K^-1   (q x q),
      E[(A - M) (A - M)^T] = tr(K^-1) psi^-1 / (nu - p - 1)   (p x p),
    each entry within 5 standard errors of its sample mean. Solving the
    column factor against chol(K) instead of its transpose fails the
    second identity."""
    rng = np.random.default_rng(3)
    p, q, draws = 2, 3, 40000
    kk = np.array([[4.0, 1.8, -1.2], [1.8, 2.0, 0.6], [-1.2, 0.6, 1.5]])
    psi = np.array([[0.8, 0.3], [0.3, 0.5]])
    nu, m = 9.0, rng.standard_normal((p, q))
    post = tm.MNW(M=torch.tensor(m).expand(draws, p, q),
                  K_=torch.tensor(kk).expand(draws, q, q),
                  psi=torch.tensor(psi).expand(draws, p, p),
                  nu=torch.full((draws,), nu, dtype=torch.float64))
    a = tm.sample_params(torch.Generator().manual_seed(11), post).A.numpy()
    dev = a - m
    e_inv_lmbda = np.linalg.inv(psi) / (nu - p - 1)
    cases = [(a, m),
             (np.swapaxes(dev, 1, 2) @ dev,
              np.trace(e_inv_lmbda) * np.linalg.inv(kk)),
             (dev @ np.swapaxes(dev, 1, 2),
              np.trace(np.linalg.inv(kk)) * e_inv_lmbda)]
    for samples, want in cases:
        se = samples.std(0) / np.sqrt(draws)
        z = np.abs(samples.mean(0) - want) / se
        assert z.max() < 5.0, (z, samples.mean(0), want)


def test_standardizer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 3)) * [1.0, 5.0, 0.0] + [2.0, -1.0, 4.0]
    sj, st = JStd.fit(jnp.asarray(x)), TStd.fit(torch.tensor(x))
    _close(_np_tree(st), sj)
    assert float(st.scale[2]) == 1.0          # constant column -> scale 1
    _close(st.transform(torch.tensor(x)).numpy(), sj.transform(x))
    _close(st.inverse_transform(torch.tensor(x)).numpy(),
           sj.inverse_transform(x))
    cov = rng.standard_normal((4, 3, 3))
    _close(st.scale_cov(torch.tensor(cov)).numpy(), sj.scale_cov(cov))
    _close(_np_tree(TStd.identity(3, torch.float64)),
           JStd.identity(3, jnp.float64))


@pytest.mark.parametrize('fn', ['suff_stats', 'update', 'ell', 'loglik', 'kl',
                                'log_predictive', 'log_predictive_gaussian'])
def test_ilr_family_matches_jax(fn):
    """The product family (NIW basis on x, MNW expert on (x, y))."""
    rng = np.random.default_rng(5)
    k, n, d, p = 3, 40, 2, 2
    niw = dict(mu=rng.standard_normal((k, d)), kappa=rng.uniform(1, 3, k),
               psi=_psd(rng, k, d, 0.3), nu=rng.uniform(d + 2, d + 9, k))
    import mimo_tpu.distributions.niw as jn
    bj, bt = _both(niw, jn.NIW, NIW)
    ej, et = _both(_mnw(rng, k, p, d + 1))
    fj, ft = jfam.ilr_family(), tfam.ilr_family()
    x, y = rng.standard_normal((n, d)), rng.standard_normal((n, p))
    dj, dt = (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x),
                                                torch.tensor(y))
    resp = rng.dirichlet(np.ones(k), n)
    if fn == 'suff_stats':
        want = fj.suff_stats(dj, jnp.asarray(resp))
        got = ft.suff_stats(dt, torch.tensor(resp))
    elif fn == 'update':
        want = fj.update((bj, ej), fj.suff_stats(dj, jnp.asarray(resp)))
        got = ft.update((bt, et), ft.suff_stats(dt, torch.tensor(resp)))
    elif fn == 'kl':
        want, got = fj.kl((bj, ej), (bj, ej)), ft.kl((bt, et), (bt, et))
    elif fn == 'loglik':
        want = fj.loglik(fj.mode_params((bj, ej)), dj)
        got = ft.loglik(ft.mode_params((bt, et)), dt)
    else:
        want = getattr(fj, fn)((bj, ej), dj)
        got = getattr(ft, fn)((bt, et), dt)
    _close(_np_tree(got), want, atol=1e-9)
    assert ft.gibbs_update is None and fj.gibbs_update is None


def test_ilr_family_refuses_unported_members():
    """The members once refused (tied-affine experts, the hierarchical
    basis) are ported: their ILR families build and draw through the
    product's Gibbs hook (their exact one-shot draws)."""
    for kw in (dict(tied_affine=True), dict(hier_basis=True)):
        assert tfam.ilr_family(**kw).gibbs_update is not None
    # MNG experts: update + sample, no hook
    assert tfam.ilr_family(diag=True).gibbs_update is None


def test_product_family_threads_member_gibbs_hooks():
    """A member with a gibbs_update hook makes the product's hook draw
    that member through it and the others through update + sample."""
    base = tfam.gaussian_family()
    hooked = base._replace(
        gibbs_update=lambda gen, prior, stats: ('post', 'params'))
    prod = tfam.product_family((base, hooked), ((0,), (0,)))
    rng = np.random.default_rng(0)
    k, d = 2, 2
    prior = NIW(mu=torch.zeros(k, d, dtype=torch.float64),
                kappa=torch.ones(k, dtype=torch.float64),
                psi=torch.eye(d, dtype=torch.float64).expand(k, d, d),
                nu=torch.full((k,), 5.0, dtype=torch.float64))
    x = torch.tensor(rng.standard_normal((20, d)))
    stats = base.suff_stats((x,), torch.full((20, k), 0.5,
                                             dtype=torch.float64))
    posts, params = prod.gibbs_update(torch.Generator().manual_seed(0),
                                      (prior, prior), (stats, stats))
    assert posts[1] == 'post' and params[1] == 'params'
    assert isinstance(posts[0], NIW) and params[0].mu.shape == (k, d)
    assert tfam.product_family((base, base), ((0,), (0,))).gibbs_update \
        is None
