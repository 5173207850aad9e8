"""Kernel B3's plain PyTorch version (ops/cuda_predict.py) against
mimo_tpu: the Pallas serving kernel in interpret mode (float32) and the
dense predictive of BayesianGMM.log_predictive(backend='xla') (float64),
for the Student-t predictive and its moment-matched Gaussian."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.gating import StickBreaking as JSB
from mimo_tpu.distributions.niw import NIW as JNIW
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.mixture import MFState as JMF
from mimo_tpu.ops.pallas_predict import gauss_predictive_pallas

from mimo_tpu_torch.bridge import state_from_numpy
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.ops import cuda_predict

torch.set_num_threads(1)


def _post(rng, k, d):
    return dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(1, 50, k),
                psi=np.broadcast_to(0.5 * np.eye(d), (k, d, d)).copy(),
                nu=rng.uniform(d + 2, d + 40, k))


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_plain_matches_pallas_interpret(dist):
    rng = np.random.default_rng(11)
    n, k, d = 1000, 6, 2
    x = rng.standard_normal((n, d)) * 3
    post = _post(rng, k, d)
    log_w = np.log(rng.dirichlet(np.ones(k)))
    want = gauss_predictive_pallas(
        JNIW(**{f: jnp.asarray(v, jnp.float32) for f, v in post.items()}),
        jnp.asarray(log_w, jnp.float32), jnp.asarray(x, jnp.float32),
        block_size=256, dist=dist)
    got = cuda_predict.gauss_predictive_cuda(
        NIW(**{f: torch.as_tensor(v, dtype=torch.float32)
               for f, v in post.items()}),
        torch.as_tensor(log_w, dtype=torch.float32),
        torch.as_tensor(x, dtype=torch.float32), dist=dist)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
@pytest.mark.parametrize('k,d', [(500, 2), (8, 24)])
def test_plain_matches_pallas_interpret_past_the_old_ceiling(k, d, dist):
    """Shapes the serving kernel once refused (its coefficients and F
    tile staged whole passed a block's shared memory; now streamed in
    K-chunks, x read where it lies): K=500 at d=2, and d=24, where the F
    tile alone was too large. 256 points, against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(k + d)
    n = 256
    x = rng.standard_normal((n, d)) * 3
    post = _post(rng, k, d)
    log_w = np.log(rng.dirichlet(np.ones(k)))
    want = gauss_predictive_pallas(
        JNIW(**{f: jnp.asarray(v, jnp.float32) for f, v in post.items()}),
        jnp.asarray(log_w, jnp.float32), jnp.asarray(x, jnp.float32),
        block_size=256, dist=dist)
    got = cuda_predict.gauss_predictive_cuda(
        NIW(**{f: torch.as_tensor(v, dtype=torch.float32)
               for f, v in post.items()}),
        torch.as_tensor(log_w, dtype=torch.float32),
        torch.as_tensor(x, dtype=torch.float32), dist=dist)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.fixture(scope='module')
def fitted():
    """A fitted DP-GMM posterior from the JAX package, float64."""
    rng = np.random.default_rng(3)
    k, d = 5, 2
    post = _post(rng, k, d)
    gating = dict(gamma=rng.uniform(1, 300, k), delta=rng.uniform(1, 600, k))
    st = JMF(JNIW(**{f: jnp.asarray(v) for f, v in post.items()}),
             JSB(**{f: jnp.asarray(v) for f, v in gating.items()}))
    x = rng.standard_normal((600, d)) * 3
    return st, x


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
@pytest.mark.parametrize('route', ['plain_kernel_twin', 'torch_backend'])
def test_matches_jax_dense_f64(fitted, dist, route):
    st, x = fitted
    jm = JaxGMM.make(size=5, dim=2, gating='dp', dtype=jnp.float64)
    want = jm.log_predictive(st, jnp.asarray(x), dist=dist, backend='xla')
    tst = state_from_numpy(st)
    tm = BayesianGMM.make(size=5, dim=2, gating='dp', dtype=torch.float64,
                          device='cpu')
    xt_ = torch.as_tensor(x)
    if route == 'torch_backend':
        got = tm.log_predictive(tst, xt_, dist=dist, backend='torch')
    else:
        got = cuda_predict.gauss_predictive_cuda(
            tst.components, tm.predictive_log_weights(tst), xt_, dist=dist)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-10)


def test_auto_backend_on_cpu_is_the_dense_path(fitted):
    st, x = fitted
    tst = state_from_numpy(st)
    tm = BayesianGMM.make(size=5, dim=2, gating='dp', dtype=torch.float64,
                          device='cpu')
    xt_ = torch.as_tensor(x)
    np.testing.assert_array_equal(tm.log_predictive(tst, xt_).numpy(),
                                  tm.log_predictive(tst, xt_,
                                                    backend='torch').numpy())
    with pytest.raises(ValueError, match='dist'):
        tm.log_predictive(tst, xt_, dist='laplace')


def test_coefficients_reproduce_the_quadratic_form():
    """thq . [1, x, x (x) x] = (x - mu)' Lmbda (x - mu) per component."""
    rng = np.random.default_rng(4)
    post = NIW(**{f: torch.as_tensor(v) for f, v in _post(rng, 4, 3).items()})
    thq, aux = cuda_predict.predictive_coefficients(post,
                                                    torch.zeros(4).double())
    assert thq.shape == (4, 16) and aux.shape == (4, 8)
    from mimo_tpu_torch.distributions.niw import predictive_studentt_params
    mu, lm, _ = predictive_studentt_params(post)
    x = torch.as_tensor(rng.standard_normal((7, 3)))
    feats = torch.cat([torch.ones(7, 1, dtype=torch.float64), x,
                       (x[:, :, None] * x[:, None, :]).reshape(7, 9)], 1)
    dx = x[:, None, :] - mu[None]
    quad = torch.einsum('nkd,kde,nke->nk', dx, lm, dx)
    np.testing.assert_allclose((feats @ thq[:, :13].T).numpy(), quad.numpy(),
                               rtol=1e-10, atol=1e-10)
