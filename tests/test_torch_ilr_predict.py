"""ILR serving of the port against mimo_tpu, on the CPU: the plain
versions of kernels B5 (p = 1) and B6 (p > 1) against the Pallas serving
kernels in interpret mode (float32, the tolerances of tests/test_pallas.py
:411-416 and :462-469), the dense `predict(backend='torch')` against
`predict(backend='xla')` in float64 at rtol 1e-8 (original-units NLPD
included), and the model's kernel-path glue (standardization round trip,
NLPD Jacobian) through the plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.ops.pallas_predict import (
    _ilr_p_predict_pallas, ilr_predict_pallas)

import mimo_tpu_torch.models.ilr as tilr
from mimo_tpu_torch.bridge import state_from_numpy
from mimo_tpu_torch.models import BayesianILR
from mimo_tpu_torch.ops import cuda_ilr_predict as cip

torch.set_num_threads(1)
N = 1000                      # ragged against the Pallas block of 256
K = 8


@functools.lru_cache(maxsize=None)
def _setup(d, p, dtype):
    """(x, y, JAX model, port model, JAX state, port state) for the
    standard problem of each shape: N = 1000 points in float32 (the
    kernels' type), 400 in float64 (the dense parity), K = 8 experts.
    Shared by the tests so JAX compiles each shape once."""
    n = N if dtype == 'f32' else 400
    rng = np.random.default_rng(d + 10 * p)
    x = rng.uniform(-3, 3, (n, d))
    w = rng.standard_normal((d, p))
    y = np.tanh(x @ w) * 2.0 + 0.5 + 0.1 * rng.standard_normal((n, p))
    return (x, y) + _models(d, p, K, x, y, dtype)


def _models(d, p, k, x, y, dtype):
    """The JAX and the port's model with the same transforms, and one
    shared state: posteriors from responsibilities that localise each
    expert around a random anchor in x (so the weights vary by point)."""
    jd = jnp.float64 if dtype == 'f64' else jnp.float32
    td = torch.float64 if dtype == 'f64' else torch.float32
    jm = JaxILR.make(size=k, input_dim=d, output_dim=p, alpha=2.0,
                     kappa=0.05, dtype=jd)
    jm.init_transform(jnp.asarray(x, jd), jnp.asarray(y, jd))
    rng = np.random.default_rng(0)
    anchors = x[rng.choice(x.shape[0], k, replace=False)]
    logits = -np.sum((x[:, None, :] - anchors[None]) ** 2, -1) / 0.5
    resp = np.exp(logits - logits.max(-1, keepdims=True))
    resp /= resp.sum(-1, keepdims=True)
    st = jm._mf_update((jm._tx(jnp.asarray(x, jd)),
                        jm._ty(jnp.asarray(y, jd))), jnp.asarray(resp, jd))
    tm = BayesianILR.make(size=k, input_dim=d, output_dim=p, alpha=2.0,
                          kappa=0.05, dtype=td, device='cpu')
    tm.init_transform(torch.as_tensor(x, dtype=td),
                      torch.as_tensor(y, dtype=td))
    return jm, tm, st, state_from_numpy(jax.tree.map(np.asarray, st))


def _assert_serving(got, want, p):
    mu, var, nlpd = got
    mu_w, var_w, nlpd_w = want
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_w), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_w), rtol=2e-3,
                               atol=1e-5 if p == 1 else 1e-4)
    if nlpd_w is None:
        assert nlpd is None
    else:
        np.testing.assert_allclose(nlpd.numpy(), np.asarray(nlpd_w),
                                   rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('has_y', [True, False])
@pytest.mark.parametrize('prediction', ['average', 'mode'])
@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
def test_plain_kernels_match_pallas_interpret(d, p, prediction, has_y):
    """B5 (p = 1) and B6 (p = 3) plain versions on the standardized data
    against ilr_predict_pallas / _ilr_p_predict_pallas (interpret mode),
    same state and coefficients' inputs, N = 1000 over blocks of 256."""
    x, y, jm, tm, st_j, st_t = _setup(d, p, 'f32')
    xx_j, yy_j = jm._tx(jnp.asarray(x, jnp.float32)), jm._ty(
        jnp.asarray(y, jnp.float32))
    xx_t = tm._tx(torch.as_tensor(x, dtype=torch.float32))
    yy_t = tm._ty(torch.as_tensor(y, dtype=torch.float32))
    lw_j, lw_t = jm.predictive_log_weights(st_j), tm.predictive_log_weights(
        st_t)
    if p == 1:
        want = ilr_predict_pallas(*st_j.components, lw_j, xx_j,
                                  yy_j if has_y else None, True,
                                  block_size=256, prediction=prediction)
        got = cip.ilr_predict_cuda(*st_t.components, lw_t, xx_t,
                                   yy_t if has_y else None, True, prediction)
    else:
        want = _ilr_p_predict_pallas(*st_j.components, lw_j, xx_j,
                                     yy_j if has_y else None, True, 256,
                                     prediction)
        got = cip.ilr_p_predict_cuda(*st_t.components, lw_t, xx_t,
                                     yy_t if has_y else None, True,
                                     prediction)
    assert got[0].shape == ((N,) if p == 1 else (N, p))
    _assert_serving(got, want, p)


@pytest.mark.parametrize('d,p,k', [(8, 1, 200), (2, 3, 300)])
def test_plain_kernels_match_pallas_interpret_past_the_old_ceiling(d, p, k):
    """B5 at K=200, d=8 and B6 (MNW) at K=300, d=2, p=3: shapes whose
    coefficients, staged whole, once passed a block's shared memory (the
    kernels now stream them in K-chunks). Plain versions against the
    Pallas kernels in interpret mode, 512 points, with y."""
    n = 512
    rng = np.random.default_rng(k)
    x = rng.uniform(-3, 3, (n, d))
    y = (np.tanh(x @ rng.standard_normal((d, p))) * 2.0 + 0.5
         + 0.1 * rng.standard_normal((n, p)))
    jm, tm, st_j, st_t = _models(d, p, k, x, y, 'f32')
    xx_j = jm._tx(jnp.asarray(x, jnp.float32))
    yy_j = jm._ty(jnp.asarray(y, jnp.float32))
    xx_t = tm._tx(torch.as_tensor(x, dtype=torch.float32))
    yy_t = tm._ty(torch.as_tensor(y, dtype=torch.float32))
    lw_j, lw_t = jm.predictive_log_weights(st_j), tm.predictive_log_weights(
        st_t)
    if p == 1:
        want = ilr_predict_pallas(*st_j.components, lw_j, xx_j, yy_j, True,
                                  block_size=256)
        got = cip.ilr_predict_cuda(*st_t.components, lw_t, xx_t, yy_t, True)
    else:
        want = _ilr_p_predict_pallas(*st_j.components, lw_j, xx_j, yy_j,
                                     True, 256, 'average')
        got = cip.ilr_p_predict_cuda(*st_t.components, lw_t, xx_t, yy_t,
                                     True)
    _assert_serving(got, want, p)


def _far_mean_coefficients(p, dtype):
    """B5 (p = 1) or B6 coefficients over d = 1 for three experts whose
    means sit near +-30 with a spread of ~0.1 and own variance c vc =
    0.007 (zero basis and c rows, so lw = aux's log w column and c = 1;
    each mean row a constant)."""
    k = 3
    means = torch.tensor([[30.0, -28.5], [30.1, -28.6], [29.95, -28.45]],
                         dtype=dtype)[:, :p]
    th = torch.zeros(((2 + p) * k, 8), dtype=dtype)
    th[2 * k:, 0] = means.T.reshape(-1)
    aux = torch.zeros((k, 8), dtype=dtype)
    aux[:, 0] = torch.tensor([-0.3, -1.2, -0.9], dtype=dtype)
    vc = torch.full((k, p), 0.007, dtype=dtype)
    if p == 1:
        aux[:, 3] = vc[:, 0]
    return th, aux, vc


@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('p', [1, 2])
def test_plain_variance_does_not_cancel_far_from_zero(p, hard):
    """The plain versions' variance in float32 against float64 where the
    means sit near +-30 against a variance of ~0.01: the centred form
    sum_k w_k (c vc_k + (mu_k - mean)^2) holds it to 1e-5 relative (the
    expanded E[c vc + mu^2] - mean^2 loses ~1e-3 here); under 'mode' it
    is the chosen expert's c vc."""
    xt = torch.linspace(-2.0, 2.0, 5, dtype=torch.float64)[None]
    out = {}
    for dtype in (torch.float32, torch.float64):
        th, aux, vc = _far_mean_coefficients(p, dtype)
        if p == 1:
            out[dtype] = cip.ilr_predict_plain(xt.to(dtype), th, aux, 5,
                                               False, hard)
        else:
            out[dtype] = cip.ilr_p_predict_plain(xt.to(dtype), th, aux, vc,
                                                 5, p, False, hard)
    got, want = out[torch.float32].double(), out[torch.float64]
    torch.testing.assert_close(got[:p], want[:p], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[p:2 * p], want[p:2 * p], rtol=1e-5,
                               atol=0.0)
    if hard:
        assert bool((out[torch.float32][p:2 * p]
                     == torch.tensor(0.007, dtype=torch.float32)).all())


@pytest.mark.parametrize('case', ['p1-average', 'p1-mode-incremental',
                                  'p3-average', 'p3-mode', 'p1-noy'])
def test_dense_predict_matches_jax_f64(case):
    """Dense predict in original units (standardization inverted, NLPD
    with the Jacobian sum(log scale)) at rtol 1e-8."""
    p = 3 if case.startswith('p3') else 1
    d = 2 if p == 3 else 1
    x, y, jm, tm, st_j, st_t = _setup(d, p, 'f64')
    prediction = 'mode' if 'mode' in case else 'average'
    inc = 'incremental' in case
    with_y = case != 'p1-noy'
    want = jm.predict(st_j, jnp.asarray(x), jnp.asarray(y) if with_y
                      else None, prediction=prediction, incremental=inc,
                      backend='xla')
    got = tm.predict(st_t, torch.tensor(x), torch.tensor(y) if with_y
                     else None, prediction=prediction, incremental=inc,
                     backend='torch')
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                       atol=1e-10)
    if with_y:
        assert float(jnp.sum(jnp.log(jm.output_transform.scale))) != 0.0


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_dense_predictive_pieces_match_jax_f64(dist):
    x, y, jm, tm, st_j, st_t = _setup(2, 3, 'f64')
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for got, want in [
            (tm.predictive_weights(st_t, xt, dist),
             jm.predictive_weights(st_j, xj, dist)),
            (tm.predictive_moments(st_t, xt, dist)[1],
             jm.predictive_moments(st_j, xj, dist)[1]),
            (tm.log_predictive_likelihood(st_t, xt, torch.tensor(y), dist),
             jm.log_predictive_likelihood(st_j, xj, jnp.asarray(y), dist))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12)


@pytest.mark.parametrize('d,p,prediction', [(1, 1, 'average'),
                                            (1, 1, 'mode'),
                                            (2, 3, 'average')])
def test_kernel_branch_glue_matches_dense(monkeypatch, d, p, prediction):
    """The model's kernel branch (coefficients, float32 round trip,
    inverse standardization, NLPD Jacobian), run through the kernels'
    plain versions by routing CPU data to it, against the dense path at
    the tolerances of tests/test_pallas.py."""
    x, y, _, tm, _, st = _setup(d, p, 'f32')
    xt, yt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(
        y, dtype=torch.float32)
    dense = tm.predict(st, xt, yt, prediction=prediction, backend='torch')
    monkeypatch.setattr(tilr, 'resolve_backend', lambda backend, x: True)
    fused = tm.predict(st, xt, yt, prediction=prediction)
    assert fused[0].shape == (N, p) and fused[0].dtype == torch.float32
    scale = tm.output_transform.scale.numpy()
    np.testing.assert_allclose(fused[0].numpy(), dense[0].numpy(),
                               rtol=1e-4, atol=1e-4 * scale.max())
    np.testing.assert_allclose(fused[1].numpy(), dense[1].numpy(),
                               rtol=2e-3, atol=1e-4 * scale.max() ** 2)
    np.testing.assert_allclose(fused[3].numpy(), dense[3].numpy(),
                               rtol=1e-3, atol=2e-3)


def test_predict_backend_validation():
    """'kernel' raises for CPU data and for Gaussian predictives (which
    stay dense); unknown backends and dists raise."""
    x, y, _, tm, _, st = _setup(1, 1, 'f32')
    xt = torch.as_tensor(x, dtype=torch.float32)
    with pytest.raises(ValueError, match='CUDA'):
        tm.predict(st, xt, backend='kernel')
    with pytest.raises(NotImplementedError, match='dense'):
        tm.predict(st, xt, dist='gaussian', backend='kernel')
    with pytest.raises(ValueError, match='unknown backend'):
        tm.predict(st, xt, backend='xla')
    with pytest.raises(ValueError, match='unknown dist'):
        tm.predict(st, xt, dist='laplace')
    with pytest.raises(ValueError, match='CUDA'):
        tm.fit_vi_fused((xt, torch.as_tensor(y, dtype=torch.float32)),
                        maxiter=1, backend='kernel')


def test_joint_features_match_jax():
    from mimo_tpu.ops.pallas_predict import _ilr_joint_features_t
    rng = np.random.default_rng(0)
    xt, yt = rng.standard_normal((2, 30)), rng.standard_normal((3, 30))
    got = cip.joint_features_t(torch.tensor(xt), torch.tensor(yt))
    want = _ilr_joint_features_t((jnp.asarray(xt), jnp.asarray(yt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    assert got.shape[0] == cip.joint_width(2, 3)
