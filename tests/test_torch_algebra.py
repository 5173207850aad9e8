"""Posterior algebra of the PyTorch port against mimo_tpu, in float64:
linalg, stats, Wishart, NIW and gating functions on the same numpy inputs,
at rtol 1e-8 (both sides compute the same closed forms; the JAX package
uses closed-form d<=3 inverses where the port uses Cholesky solves, so
agreement is to rounding, not bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.distributions.gating as jg
import mimo_tpu.distributions.niw as jn
import mimo_tpu.distributions.wishart as jw
import mimo_tpu.utils.linalg as jl
import mimo_tpu.utils.stats as js

import mimo_tpu_torch.distributions.gating as tg
import mimo_tpu_torch.distributions.niw as tn
import mimo_tpu_torch.distributions.wishart as tw
import mimo_tpu_torch.utils.linalg as tl
import mimo_tpu_torch.utils.stats as ts

torch.set_num_threads(1)
RTOL = 1e-8


def _close(a, b, rtol=RTOL, atol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _psd(rng, k, d, scale=1.0):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _niw(rng, k, d):
    return dict(mu=rng.standard_normal((k, d)),
                kappa=rng.uniform(0.5, 5.0, k),
                psi=_psd(rng, k, d, 0.3),
                nu=rng.uniform(d + 1.5, d + 30.0, k))


def _both(cls_j, cls_t, arrays):
    return (cls_j(**{f: jnp.asarray(v) for f, v in arrays.items()}),
            cls_t(**{f: torch.as_tensor(v) for f, v in arrays.items()}))


@pytest.mark.parametrize('d', [2, 4])
@pytest.mark.parametrize('fn', ['symmetrize', 'cholesky', 'chol_logdet',
                                'logdet_psd', 'inv_psd', 'solve_psd',
                                'quad_form'])
def test_linalg_matches_jax(fn, d):
    rng = np.random.default_rng(d)
    a = _psd(rng, 5, d)
    if fn == 'symmetrize':
        a = rng.standard_normal((5, d, d))
        args = (a,)
    elif fn == 'chol_logdet':
        args = (np.linalg.cholesky(a),)
    elif fn == 'solve_psd':
        args = (a, rng.standard_normal((5, d, 3)))
    elif fn == 'quad_form':
        args = (rng.standard_normal((30, d)), a, rng.standard_normal((5, d)))
    else:
        args = (a,)
    got = getattr(tl, fn)(*(torch.as_tensor(v) for v in args))
    want = getattr(jl, fn)(*(jnp.asarray(v) for v in args))
    _close(got, want)
    if fn == 'cholesky':       # the jittered form too
        _close(tl.cholesky(torch.as_tensor(a), jitter=0.1),
               jl.cholesky(jnp.asarray(a), jitter=0.1))


@pytest.mark.parametrize('fn', ['mvdigamma', 'mvgammaln'])
def test_multivariate_gamma_functions(fn):
    a = np.random.default_rng(1).uniform(2.0, 40.0, 7)
    for d in (1, 2, 3):
        _close(getattr(tl, fn)(torch.as_tensor(a), d),
               getattr(jl, fn)(jnp.asarray(a), d))


def test_stats_logpdfs_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 3)) * 2
    mu = rng.standard_normal((6, 3))
    lm = _psd(rng, 6, 3)
    df = rng.uniform(1.0, 50.0, 6)
    T = torch.as_tensor
    _close(ts.mvn_logpdf(T(x), T(mu), T(lm)),
           js.mvn_logpdf(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(lm)))
    _close(ts.mvt_logpdf(T(x), T(mu), T(lm), T(df)),
           js.mvt_logpdf(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(lm),
                         jnp.asarray(df)))
    logits = rng.standard_normal((40, 6)) * 3
    r_t, z_t = ts.normalize_log(T(logits))
    r_j, z_j = js.normalize_log(jnp.asarray(logits))
    _close(r_t, r_j)
    _close(z_t, z_j)
    r = np.asarray(r_j).copy()
    r[0, :3] = 0.0                      # exact zeros stay NaN-free
    _close(ts.entropy_categorical(T(r)), js.entropy_categorical(jnp.asarray(r)))


def test_gammaln_diff_matches_jax_on_both_branches():
    a = np.array([0.5, 3.0, 99.0, 100.0, 1e3, 5e6])
    for h in (0.5, 1.0, 2.5):
        _close(ts.gammaln_diff(torch.as_tensor(a), h),
               js.gammaln_diff(jnp.asarray(a), h), rtol=1e-10)


def test_gammaln_diff_f32_stays_exact_at_huge_a():
    """At a = 5e6 lgamma's f32 ulp is 4 nats; the Stirling branch keeps
    the f32 difference at f64 accuracy."""
    a = torch.tensor([5e6])
    f64 = ts.gammaln_diff(a.double(), 1.0)
    f32 = ts.gammaln_diff(a, 1.0)
    naive = torch.lgamma(a + 1.0) - torch.lgamma(a)
    assert abs(float(f32) - float(f64)) < 1e-5
    _close(f64, np.log(5e6), rtol=1e-12)
    assert abs(float(naive) - float(f64)) > 0.1     # what the fix avoids


def test_wishart_terms_match_jax():
    rng = np.random.default_rng(3)
    psi = _psd(rng, 5, 3, 0.5)
    nu = rng.uniform(4.0, 60.0, 5)
    chol = np.linalg.cholesky(psi)
    _close(tw.wishart_expected_logdet(torch.as_tensor(chol),
                                      torch.as_tensor(nu)),
           jw.wishart_expected_logdet(jnp.asarray(chol), jnp.asarray(nu)))
    _close(tw.wishart_log_partition(torch.as_tensor(chol),
                                    torch.as_tensor(nu)),
           jw.wishart_log_partition(jnp.asarray(chol), jnp.asarray(nu)))


def _stats(rng, k, d):
    x = rng.standard_normal((200, d)) * 2
    r = rng.dirichlet(np.ones(k), 200)
    return x, r


@pytest.mark.parametrize('fn', [
    'posterior_update', 'expected_stats', 'kl_divergence',
    'predictive_studentt_params', 'expected_log_likelihood', 'log_partition',
    'log_marginal_likelihood', 'nat_std_round_trip', 'suff_stats',
    'log_predictive_studentt', 'log_predictive_gaussian', 'plugin_params'])
def test_niw_matches_jax(fn):
    rng = np.random.default_rng(4)
    k, d = 5, 3
    pj, pt = _both(jn.NIW, tn.NIW, _niw(rng, k, d))
    qj, qt = _both(jn.NIW, tn.NIW, _niw(rng, k, d))
    x, r = _stats(rng, k, d)
    xj, xt_ = jnp.asarray(x), torch.as_tensor(x)
    if fn == 'posterior_update':
        got = tn.posterior_update(pt, tn.suff_stats(xt_, torch.as_tensor(r)))
        want = jn.posterior_update(pj, jn.suff_stats(xj, jnp.asarray(r)))
    elif fn == 'suff_stats':
        got = tn.suff_stats(xt_, torch.as_tensor(r))
        want = jn.suff_stats(xj, jnp.asarray(r))
    elif fn == 'kl_divergence':
        got, want = tn.kl_divergence(qt, pt), jn.kl_divergence(qj, pj)
    elif fn == 'log_marginal_likelihood':
        got = tn.log_marginal_likelihood(pt, qt, 200)
        want = jn.log_marginal_likelihood(pj, qj, 200)
    elif fn == 'nat_std_round_trip':
        got = tn.std_from_nat(tn.nat_from_std(pt))
        want = jn.std_from_nat(jn.nat_from_std(pj))
        _close(tn.nat_from_std(pt).xxT, jn.nat_from_std(pj).xxT)
    elif fn == 'plugin_params':
        got = (tn.mode_params(pt), tn.mean_params(pt),
               tn.log_likelihood(tn.mode_params(pt), xt_))
        want = (jn.mode_params(pj), jn.mean_params(pj),
                jn.log_likelihood(jn.mode_params(pj), xj))
    elif fn in ('expected_log_likelihood', 'log_predictive_studentt',
                'log_predictive_gaussian'):
        got, want = getattr(tn, fn)(pt, xt_), getattr(jn, fn)(pj, xj)
    else:
        got, want = getattr(tn, fn)(pt), getattr(jn, fn)(pj)
    flat_g = got if isinstance(got, tuple) else (got,)
    flat_w = want if isinstance(want, tuple) else (want,)
    for g, w in zip(_leaves(flat_g), _leaves(flat_w)):
        _close(g, w)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [l for t in tree for l in _leaves(t)]
    return [tree]


def test_niw_standard_prior_matches_jax():
    pt = tn.NIW.standard(4, 3, kappa=0.05, psi_scale=0.5,
                         dtype=torch.float64)
    pj = jn.NIW.standard(4, 3, kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    for g, w in zip(pt, pj):
        _close(g, w)


def test_niw_sample_params_moments():
    """E[Lambda] = nu psi and E[mu] = m under the sampler, over 20000
    batched draws (Monte Carlo, 5-sigma-ish bounds)."""
    g = torch.Generator().manual_seed(0)
    k = 20000
    p = tn.NIW(mu=torch.tensor([1.0, -2.0]).expand(k, 2),
               kappa=torch.full((k,), 2.0),
               psi=torch.tensor([[0.5, 0.1], [0.1, 0.3]]).expand(k, 2, 2),
               nu=torch.full((k,), 6.0))
    draw = tn.sample_params(g, p._replace(
        mu=p.mu.double(), kappa=p.kappa.double(), psi=p.psi.double(),
        nu=p.nu.double()))
    np.testing.assert_allclose(draw.lmbda.mean(0).numpy(),
                               6.0 * np.array([[0.5, 0.1], [0.1, 0.3]]),
                               atol=0.06)
    np.testing.assert_allclose(draw.mu.mean(0).numpy(), [1.0, -2.0],
                               atol=0.03)


@pytest.mark.parametrize('gating', ['dirichlet', 'dp'])
def test_gating_matches_jax(gating):
    rng = np.random.default_rng(5)
    k = 7
    counts = rng.uniform(0.0, 50.0, k)
    resp = rng.dirichlet(np.ones(k), 30)
    if gating == 'dirichlet':
        prior_t = tg.Dirichlet.standard(k, 1.5, dtype=torch.float64)
        prior_j = jg.Dirichlet.standard(k, 1.5, dtype=jnp.float64)
    else:
        prior_t = tg.StickBreaking.standard(k, 1.5, dtype=torch.float64)
        prior_j = jg.StickBreaking.standard(k, 1.5, dtype=jnp.float64)
    post_t = prior_t.update(torch.as_tensor(counts))
    post_j = prior_j.update(jnp.asarray(counts))
    for g, w in zip(post_t, post_j):
        _close(g, w)
    for name in ('expected_log_pi', 'mean', 'mode', 'log_partition'):
        _close(getattr(post_t, name)(), getattr(post_j, name)())
    _close(post_t.kl_divergence(prior_t), post_j.kl_divergence(prior_j))
    _close(post_t.label_elbo_terms(torch.as_tensor(resp)),
           post_j.label_elbo_terms(jnp.asarray(resp)))


def test_reverse_cumsum_exclusive_matches_jax():
    c = np.random.default_rng(6).uniform(0.0, 10.0, 9)
    _close(tg._reverse_cumsum_exclusive(torch.as_tensor(c)),
           jg._reverse_cumsum_exclusive(jnp.asarray(c)))


def test_stick_breaking_finite_at_1e7_counts_f32():
    """Counts summing to 1e7 in f32: delta stays >= 0 (the last stick's
    accumulated count is exactly 0) and the stick KL is finite."""
    rng = np.random.default_rng(7)
    w = rng.dirichlet(np.ones(50) * 0.3)
    counts = torch.as_tensor(w * 1e7, dtype=torch.float32)
    prior = tg.StickBreaking.standard(50, 1.0)
    post = prior.update(counts)
    assert bool((post.delta >= 0).all())
    assert float(post.delta[-1]) == 1.0
    assert bool(torch.isfinite(post.kl_divergence(prior)))
    assert bool(torch.isfinite(post.expected_log_pi()).all())


@pytest.mark.parametrize('gating', ['dirichlet', 'dp'])
def test_gating_sample_is_a_distribution(gating):
    g = torch.Generator().manual_seed(1)
    cls = tg.Dirichlet if gating == 'dirichlet' else tg.StickBreaking
    post = cls.standard(6, 2.0, dtype=torch.float64).update(
        torch.tensor([5.0, 0.0, 30.0, 1.0, 0.0, 2.0], dtype=torch.float64))
    draws = torch.stack([post.sample(g) for _ in range(4000)])
    assert bool((draws >= 0).all())
    np.testing.assert_allclose(draws.sum(-1).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(draws.mean(0).numpy(), post.mean().numpy(),
                               atol=0.02)
