"""mimo_tpu_torch/distributions/extra.py against SciPy and against
mimo_tpu/distributions/extra.py at float64 (rtol 1e-10), on the inputs of
tests/test_extra.py, and the inverse-Wishart sampler's mean."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from mimo_tpu.distributions import extra as jextra

from mimo_tpu_torch.distributions import extra

RTOL = 1e-10


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + 2 * np.eye(d)


def both(name, *args):
    """(the port's value, JAX's value) of extra.<name> on float64 args."""
    got = getattr(extra, name)(*(t(a) for a in args)).numpy()
    want = np.asarray(getattr(jextra, name)(*(jnp.asarray(a) for a in args)))
    return got, want


def test_wishart_logpdf(rng):
    d = 3
    psi = spd(rng, d)
    nu = 7.5
    x = sps.wishart.rvs(df=nu, scale=psi, random_state=rng)
    got, want = both('wishart_logpdf', x[None], psi[None], [nu])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got[0], sps.wishart.logpdf(x, df=nu,
                                                          scale=psi),
                               rtol=RTOL)


def test_inverse_wishart_logpdf(rng):
    d = 2
    psi = spd(rng, d)
    nu = 6.0
    x = sps.invwishart.rvs(df=nu, scale=psi, random_state=rng)
    got, want = both('inverse_wishart_logpdf', x[None], psi[None], [nu])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got[0], sps.invwishart.logpdf(x, df=nu,
                                                             scale=psi),
                               rtol=RTOL)


def test_inverse_wishart_mean(rng):
    psi = np.stack([spd(rng, 3), spd(rng, 3)])
    got, want = both('inverse_wishart_mean', psi, [7.0, 9.5])
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize('name, ref', [
    ('gamma_logpdf', lambda x, a, b: sps.gamma.logpdf(x, a=a, scale=1 / b)),
    ('inverse_gamma_logpdf',
     lambda x, a, b: sps.invgamma.logpdf(x, a=a, scale=b)),
])
def test_gamma_logpdfs(rng, name, ref):
    alpha, beta = 3.0, 2.0
    x = rng.uniform(0.2, 3.0, 5)
    got, want = both(name, x, alpha, beta)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, ref(x, alpha, beta), rtol=RTOL)


def test_matrix_normal_logpdf(rng):
    p, q = 2, 3
    m = rng.standard_normal((p, q))
    v = spd(rng, p)                      # row precision
    k = spd(rng, q)                      # column precision
    x = rng.standard_normal((p, q))
    got, want = both('matrix_normal_logpdf', x, m, v, k)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, sps.matrix_normal.logpdf(
        x, mean=m, rowcov=np.linalg.inv(v), colcov=np.linalg.inv(k)),
        rtol=RTOL)


def test_gaussian_cov_logpdf(rng):
    x = rng.standard_normal((6, 2))
    mu = rng.standard_normal((3, 2))
    sigma = np.stack([spd(rng, 2) for _ in range(3)])
    got, want = both('gaussian_cov_logpdf', x, mu, sigma)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    ref = np.stack([sps.multivariate_normal.logpdf(x, mu[j], sigma[j])
                    for j in range(3)], -1)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_inverse_wishart_sampler_mean():
    d = 2
    gen = torch.Generator().manual_seed(0)
    psi = (torch.eye(d, dtype=torch.float64) * 3.0).expand(4000, d, d)
    nu = torch.full((4000,), 9.0, dtype=torch.float64)
    draws = extra.inverse_wishart_sample(gen, psi, nu)
    np.testing.assert_allclose(draws.mean(0).numpy(),
                               np.eye(d) * 3.0 / (9.0 - d - 1.0),
                               rtol=0.1, atol=0.05)


@pytest.mark.parametrize('name', ['gamma', 'inverse_gamma'])
def test_gamma_samplers_means(name):
    """Gamma(3, 2) has mean 1.5; IG(3, 2) has mean 1."""
    gen = torch.Generator().manual_seed(1)
    alpha = torch.full((20000,), 3.0, dtype=torch.float64)
    beta = torch.full((20000,), 2.0, dtype=torch.float64)
    draws = getattr(extra, f'{name}_sample')(gen, alpha, beta)
    want = 1.5 if name == 'gamma' else 1.0
    assert abs(float(draws.mean()) - want) < 0.05 * want


def test_matrix_normal_sampler_covariances(rng):
    """Row covariance V^{-1} and column covariance K^{-1} of the draws."""
    p, q, s = 2, 3, 40000
    v, k = spd(rng, p), spd(rng, q)
    m = rng.standard_normal((p, q))
    gen = torch.Generator().manual_seed(2)
    a = extra.matrix_normal_sample(gen, t(m).expand(s, p, q),
                                   t(v).expand(s, p, p), t(k).expand(s, q, q))
    da = (a - t(m)).numpy()
    cov = np.einsum('spq,srt->prqt', da, da) / s      # Cov(A_pq, A_rt)
    want = np.einsum('pr,qt->prqt', np.linalg.inv(v), np.linalg.inv(k))
    np.testing.assert_allclose(cov, want, atol=0.03)
