"""The diagonal families of the port against mimo_tpu, on the CPU: the
diagonal-Gaussian and MNG-expert E-step specs (float64), kernel B1's and
B2's plain versions over the diagonal map against the Pallas kernels in
interpret mode (float32, masked tail), kernel B4's and B3-diag's plain
versions against diag_predictive_pallas, B5's MNG rows and B6's MNG tail
against the Pallas ILR serving kernels, the diagonal GMM's fused VI trace
from a shared JAX state (float64, rtol 1e-8), the dense MNG predict, and
a fused Gibbs -> VI sine fit with MNG experts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions import mng as jmg
from mimo_tpu.distributions import ng as jng
from mimo_tpu.distributions.mnw import augment as jaugment
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas
from mimo_tpu.ops.pallas_gibbs import fused_gibbs_pallas
from mimo_tpu.ops.pallas_predict import (
    _ilr_p_predict_pallas, diag_predictive_pallas, ilr_predict_pallas)

import mimo_tpu_torch.models.ilr as tilr
import mimo_tpu_torch.models.mixture as tmix
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import ILRConfig, MixtureConfig
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.models import BayesianGMM, BayesianILR, GibbsState
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.ops import (
    cuda_diag_predict, cuda_estep, cuda_gibbs, cuda_ilr_predict)
from mimo_tpu_torch.ops import family_estep as tfe

torch.set_num_threads(1)
TRUE_MU = np.array([[-3., 0.], [3., 0.], [0., 4.]])


def _tree(got, want, rtol, atol):
    """Leaf by leaf, in field order."""
    got, want = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _ng_arrays(rng, k, d):
    return dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(1, 20, (k, d)),
                alpha=rng.uniform(2, 40, (k, d)),
                beta=rng.uniform(0.5, 5, (k, d)))


def _post(arrays, cls, dtype):
    if cls in (NG, MNG):
        return cls(**{f: torch.as_tensor(v, dtype=dtype)
                      for f, v in arrays.items()})
    return cls(**{f: jnp.asarray(v, dtype) for f, v in arrays.items()})


# -- the E-step specs ---------------------------------------------------------

@pytest.mark.parametrize('part', ['features', 'features_t', 'theta',
                                  'theta_plugin', 'unpack'])
def test_diag_gaussian_spec_pieces_match_jax(part):
    rng = np.random.default_rng(1)
    k, d, n = 5, 3, 40
    arrays = _ng_arrays(rng, k, d)
    pj, pt = _post(arrays, jng.NG, jnp.float64), _post(arrays, NG,
                                                       torch.float64)
    x = rng.standard_normal((n, d))
    js, ts = jfe.diag_gaussian_spec(), tfe.diag_gaussian_spec()
    if part == 'features':
        got, want = ts.features((torch.tensor(x),)), js.features(
            (jnp.asarray(x),))
    elif part == 'features_t':
        got = ts.features_t((torch.tensor(x.T),))
        want = jfe.diag_gauss_features_t((jnp.asarray(x.T),))
    elif part == 'theta':
        got, want = ts.theta(pt), js.theta(pj)
    elif part == 'theta_plugin':
        got = ts.theta_plugin(tfe._ng.mode_params(pt))
        want = js.theta_plugin(jng.mode_params(pj))
    else:
        acc = rng.standard_normal((k, tfe.diag_gauss_width(d)))
        got, want = ts.unpack(torch.tensor(acc)), js.unpack(jnp.asarray(acc))
    _tree(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('part', ['theta', 'theta_plugin', 'unpack'])
def test_mng_expert_spec_pieces_match_jax(part):
    """ilr_spec(diag_expert=True): NIW basis x MNG experts."""
    rng = np.random.default_rng(2)
    k, d, p = 4, 2, 2
    q = d + 1
    a = rng.standard_normal((k, d, d))
    niw = dict(mu=rng.standard_normal((k, d)), kappa=rng.uniform(5, 50, k),
               psi=0.1 * (a @ np.swapaxes(a, 1, 2) / d + np.eye(d)),
               nu=rng.uniform(10, 50, k))
    b = rng.standard_normal((k, q, q))
    mng = dict(M=rng.standard_normal((k, p, q)),
               K_=b @ np.swapaxes(b, 1, 2) / q + 2 * np.eye(q),
               alpha=rng.uniform(3, 30, (k, p)),
               beta=rng.uniform(0.5, 4, (k, p)))
    from mimo_tpu.distributions.niw import NIW as JNIW
    from mimo_tpu_torch.distributions.niw import NIW
    pj = (JNIW(**{f: jnp.asarray(v) for f, v in niw.items()}),
          jmg.MNG(**{f: jnp.asarray(v) for f, v in mng.items()}))
    pt = (NIW(**{f: torch.tensor(v) for f, v in niw.items()}),
          MNG(**{f: torch.tensor(v) for f, v in mng.items()}))
    js = jfe.ilr_spec(d, p, diag_expert=True)
    ts = tfe.ilr_spec(d, p, diag_expert=True)
    if part == 'theta':
        got, want = ts.theta(pt), js.theta(pj)
    elif part == 'theta_plugin':
        import mimo_tpu.conjugate.families as jfam
        import mimo_tpu_torch.conjugate.families as tfam
        got = ts.theta_plugin(tfam.ilr_family(diag=True).mode_params(pt))
        want = js.theta_plugin(jfam.ilr_family(diag=True).mode_params(pj))
    else:
        acc = rng.standard_normal((k, tfe.ilr_width(d, p)))
        got, want = ts.unpack(torch.tensor(acc)), js.unpack(jnp.asarray(acc))
    _tree(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('which', ['diag_gaussian', 'diag_linear'])
def test_diag_specs_reproduce_the_jax_ell(which):
    """features . theta of the port's spec equals mimo_tpu's expected
    log-likelihood (tests/test_family_estep.py:39, 64)."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((200, 2)) * 1.5
    y = rng.standard_normal((200, 1)) + 0.3 * x[:, :1]
    if which == 'diag_gaussian':
        post = NG.standard(6, 2, kappa=1.3, dtype=torch.float64)._replace(
            mu=torch.tensor(rng.standard_normal((6, 2))),
            beta=torch.tensor(rng.uniform(0.5, 2.0, (6, 2))))
        spec = tfe.diag_gaussian_spec()
        logp = spec.features((torch.tensor(x),)) @ spec.theta(post).T
        want = jng.expected_log_likelihood(
            jng.NG(*(jnp.asarray(t.numpy()) for t in post)), jnp.asarray(x))
    else:
        post = MNG.standard(6, 1, 3, K_scale=0.5,
                            dtype=torch.float64)._replace(
            M=torch.tensor(rng.standard_normal((6, 1, 3))),
            beta=torch.tensor(rng.uniform(0.5, 2.0, (6, 1))))
        spec = tfe.diag_linear_spec(True, 1, 3)
        logp = (spec.features((torch.tensor(x), torch.tensor(y)))
                @ spec.theta(post).T)
        want = jmg.expected_log_likelihood(
            jmg.MNG(*(jnp.asarray(t.numpy()) for t in post)),
            jaugment(jnp.asarray(x), True), jnp.asarray(y))
    np.testing.assert_allclose(logp.numpy(), np.asarray(want), rtol=1e-10)


def test_kernels_recognise_the_diagonal_maps():
    """The diagonal GMM runs B1/B2 over the DIAG map; MNG experts need no
    new map: their spec shares the linear map, so the ILR product map is
    the one the kernels already assemble. The diagonal (NG) basis builds
    the ILR map over [1; x; x^2] (ILR_DIAG / ILR_DIAG_LINEAR), as wide as
    mimo_tpu's product map, and its E-step equals mimo_tpu's (float64)."""
    assert (cuda_estep.feature_kind(tfe.diag_gaussian_spec().features_t)
            == cuda_estep.DIAG)
    for affine, kind in ((True, cuda_estep.ILR),
                         (False, cuda_estep.ILR_LINEAR)):
        spec = tfe.ilr_spec(2, 3, affine=affine, diag_expert=True)
        assert cuda_estep.feature_kind(spec.features_t) == kind
    assert cuda_estep.feature_width(cuda_estep.DIAG, 3) == 7
    rng = np.random.default_rng(8)
    x, y = rng.standard_normal((50, 2)), rng.standard_normal((50, 3))
    post = (_ng_arrays(rng, 4, 2), dict(
        M=rng.standard_normal((4, 3, 3)), K_=np.broadcast_to(
            2 * np.eye(3), (4, 3, 3)).copy(),
        alpha=rng.uniform(3, 30, (4, 3)), beta=rng.uniform(0.5, 4, (4, 3))))
    for affine, kind in ((True, cuda_estep.ILR_DIAG),
                         (False, cuda_estep.ILR_DIAG_LINEAR)):
        kw = dict(affine=affine, diag_basis=True, diag_expert=True)
        spec, jspec = tfe.ilr_spec(2, 3, **kw), jfe.ilr_spec(2, 3, **kw)
        assert cuda_estep.feature_kind(spec.features_t) == kind
        assert cuda_estep.feature_width(kind, 2, 3) == jspec.features(
            (jnp.asarray(x), jnp.asarray(y))).shape[-1]
        q = 2 + int(affine)
        pj = (_post(post[0], jng.NG, jnp.float64), jmg.MNG(**{
            f: jnp.asarray(v[..., :q, :q] if f == 'K_' else
                           v[..., :q] if f == 'M' else v)
            for f, v in post[1].items()}))
        pt = (_post(post[0], NG, torch.float64), MNG(**{
            f: torch.tensor(v[..., :q, :q] if f == 'K_' else
                            v[..., :q] if f == 'M' else v)
            for f, v in post[1].items()}))
        log_pi = np.log(rng.dirichlet(np.ones(4)))
        want = jfe.fused_estep_dense(jspec, pj, jnp.asarray(log_pi),
                                     (jnp.asarray(x), jnp.asarray(y)))
        got = tfe.fused_estep_dense(spec, pt, torch.tensor(log_pi),
                                    (torch.tensor(x), torch.tensor(y)))
        _tree(got.stats, want.stats, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(got.lse), float(want.lse),
                                   rtol=1e-8)


# -- kernels B1 and B2 over the diagonal map ----------------------------------

@functools.lru_cache(maxsize=None)
def _gmm_problem():
    """test_pallas.py::_spec_problem(diag=True): N=4096, K=8, d=2, DP
    gating, in float32, and the JAX VI state after 3 sweeps."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2)).astype(jnp.float32)
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU, jnp.float32), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float32)
    jm = JaxGMM.make(size=8, dim=2, gating='dp', alpha=1.0, diag=True,
                     kappa=0.05, dtype=jnp.float32)
    st, _ = jm.fit_vi_fused(x, key=1, maxiter=3, backend='xla')
    return jm, x, jax.tree.map(np.asarray, st)


def test_diag_b1_plain_matches_pallas_interpret_masked_tail():
    """N=1000 over blocks of 384: the Pallas launcher pads and masks the
    tail; B1's plain version stops at n (columns past it hold junk)."""
    jm, x, st = _gmm_problem()
    x = x[:1000]
    post_j = jax.tree.map(jnp.asarray, st.components)
    log_pi = jnp.asarray(state_from_numpy(st).gating.expected_log_pi()
                         .numpy())
    n = 1000
    xt_pad = jnp.pad(x.T, ((0, 0), (0, (-n) % 384)))
    want = fused_estep_pallas(jfe.diag_gaussian_spec(), post_j, log_pi,
                              (xt_pad,), 384, n)
    padded = torch.cat([torch.tensor(np.asarray(x)).T,
                        torch.full((2, 24), 1e3)], 1)
    got = cuda_estep.fused_estep_cuda(
        tfe.diag_gaussian_spec(), state_from_numpy(st.components),
        torch.tensor(np.asarray(log_pi)), (padded,), n)
    _tree(got.stats, want.stats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


def test_diag_b1_plain_matches_blockwise_f64():
    rng = np.random.default_rng(4)
    k, d, n = 5, 3, 777
    arrays = _ng_arrays(rng, k, d)
    x = rng.standard_normal((n, d)) * 2
    log_pi = np.log(rng.dirichlet(np.ones(k)))
    want = jfe.fused_estep_blockwise(
        jfe.diag_gaussian_spec(), _post(arrays, jng.NG, jnp.float64),
        jnp.asarray(log_pi), (jnp.asarray(x),), 259)
    got = cuda_estep.fused_estep_cuda(
        tfe.diag_gaussian_spec(), _post(arrays, NG, torch.float64),
        torch.tensor(log_pi), (torch.tensor(x.T).contiguous(),), n)
    _tree(got.stats, want.stats, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-8)


def test_diag_b2_plain_labels_and_stats_against_pallas():
    """B2 over the diagonal map: the plain version's labels are in range,
    equal the blockwise engine's (the same Philox draws), follow the
    softmax over K, and its statistics are the one-hot sums of its own
    labels; the Pallas sweep (interpret mode, masked tail, its own PRNG)
    gives statistics that the port's map and unpack rebuild from its
    labels."""
    jm, x, st = _gmm_problem()
    n = 1000
    x = x[:n]
    params_j = jng.mode_params(jax.tree.map(jnp.asarray, st.components))
    log_pi = np.log(np.asarray(st.gating.gamma) / np.sum(st.gating.gamma))
    spec_t = tfe.diag_gaussian_spec()
    xt_pad = jnp.pad(x.T, ((0, 0), (0, (-n) % 384)))
    lab_j, res_j = fused_gibbs_pallas(jfe.diag_gaussian_spec(), 7, params_j,
                                      jnp.asarray(log_pi, jnp.float32),
                                      (xt_pad,), 384, n)
    xt = torch.tensor(np.asarray(x))
    feats = spec_t.features((xt,))
    oh = torch.nn.functional.one_hot(torch.tensor(np.asarray(lab_j)).long(),
                                     8).float()
    _tree(spec_t.unpack(oh.T @ feats), res_j.stats, rtol=1e-5, atol=1e-4)

    params_t = state_from_numpy(params_j)
    seed = torch.tensor(123456789, dtype=torch.int64)
    lp = torch.tensor(log_pi, dtype=torch.float32)
    labels, res = cuda_gibbs.fused_gibbs_cuda(spec_t, seed, params_t, lp,
                                              (xt.T.contiguous(),), n)
    ref_labels, _ = tfe.fused_gibbs_blockwise(spec_t, seed, params_t, lp,
                                              (xt,), 256)
    assert labels.dtype == torch.int32
    assert 0 <= int(labels.min()) and int(labels.max()) < 8
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    oh = torch.nn.functional.one_hot(labels.long(), 8).float()
    _tree(res.stats, state_to_numpy(spec_t.unpack(oh.T @ feats)), rtol=1e-6,
          atol=1e-4)
    probs = torch.softmax(feats.double() @ spec_t.theta_plugin(
        params_t).double().T + lp.double(), -1)
    expected = probs.sum(0).numpy()
    counts = np.bincount(labels.numpy(), minlength=8)
    assert np.all(np.abs(counts - expected)
                  <= 5 * np.sqrt(expected * (1 - expected / n)) + 5)


# -- kernel B4 and B3 over the diagonal map -----------------------------------

@functools.lru_cache(maxsize=None)
def _serving_problem():
    """test_pallas.py::test_fused_diag_predictive_matches_dense's inputs."""
    rng = np.random.default_rng(3)
    n, k, d = 1024, 6, 3
    x = rng.standard_normal((n, d)) * 2
    arrays = dict(mu=rng.standard_normal((k, d)) * 2,
                  kappa=rng.uniform(1, 20, (k, d)),
                  alpha=rng.uniform(2, 40, (k, d)),
                  beta=rng.uniform(0.5, 5, (k, d)))
    return x, arrays, np.log(np.full((k,), 1.0 / k))


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_diag_predictive_plain_matches_pallas_interpret(dist):
    """B4 (Student-t) and B3-diag (Gaussian) plain versions against
    diag_predictive_pallas with block_size=256, whole and over a
    1000-point tail, at rtol 1e-4, atol 1e-4 (test_pallas.py:348-382)."""
    x, arrays, log_w = _serving_problem()
    post_j = _post(arrays, jng.NG, jnp.float32)
    post_t = _post(arrays, NG, torch.float32)
    for m in (1024, 1000):
        want = diag_predictive_pallas(post_j, jnp.asarray(log_w, jnp.float32),
                                      jnp.asarray(x[:m], jnp.float32),
                                      block_size=256, dist=dist)
        got = cuda_diag_predict.diag_predictive_cuda(
            post_t, torch.tensor(log_w, dtype=torch.float32),
            torch.tensor(x[:m], dtype=torch.float32), dist)
        assert got.shape == (m,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
@pytest.mark.parametrize('route', ['plain_kernel_twin', 'torch_backend'])
def test_diag_predictive_matches_jax_dense_f64(dist, route):
    x, arrays, _ = _serving_problem()
    rng = np.random.default_rng(8)
    gating = dict(alpha=rng.uniform(1, 300, 6))
    from mimo_tpu.distributions.gating import Dirichlet as JDir
    from mimo_tpu.models.mixture import MFState as JMF
    st = JMF(_post(arrays, jng.NG, jnp.float64),
             JDir(**{f: jnp.asarray(v) for f, v in gating.items()}))
    jm = JaxGMM.make(size=6, dim=3, diag=True, dtype=jnp.float64)
    want = jm.log_predictive(st, jnp.asarray(x), dist=dist, backend='xla')
    tst = state_from_numpy(jax.tree.map(np.asarray, st))
    tm = BayesianGMM.make(size=6, dim=3, diag=True, dtype=torch.float64,
                          device='cpu')
    if route == 'torch_backend':
        got = tm.log_predictive(tst, torch.tensor(x), dist=dist,
                                backend='torch')
    else:
        got = cuda_diag_predict.diag_predictive_cuda(
            tst.components, tm.predictive_log_weights(tst), torch.tensor(x),
            dist)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_diag_predictive_plain_matches_pallas_interpret_wide(dist):
    """B4 (and B3-diag) at K=64, d=32, a shape whose coefficients, staged
    whole, once passed a block's shared memory: plain versions against
    diag_predictive_pallas in interpret mode, 256 points."""
    rng = np.random.default_rng(9)
    k, d = 64, 32
    x = rng.standard_normal((256, d)) * 2
    arrays = dict(mu=rng.standard_normal((k, d)) * 2,
                  kappa=rng.uniform(1, 20, (k, d)),
                  alpha=rng.uniform(2, 40, (k, d)),
                  beta=rng.uniform(0.5, 5, (k, d)))
    log_w = np.log(rng.dirichlet(np.ones(k)))
    want = diag_predictive_pallas(_post(arrays, jng.NG, jnp.float32),
                                  jnp.asarray(log_w, jnp.float32),
                                  jnp.asarray(x, jnp.float32),
                                  block_size=256, dist=dist)
    got = cuda_diag_predict.diag_predictive_cuda(
        _post(arrays, NG, torch.float32),
        torch.tensor(log_w, dtype=torch.float32),
        torch.tensor(x, dtype=torch.float32), dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_b4_coefficients_reproduce_the_scaled_quads():
    """Row (k, j) = [th_0, th_1, th_2, h] with th_0 + th_1 x_j + th_2 x_j^2
    = (lam / df)(x_j - mu)^2 per (component, dim) and h = (df + 1) / 2;
    aux[:, 1], the shared h, is 0 where h differs across dims (here: alpha
    drawn per dim) and h where it does not."""
    rng = np.random.default_rng(6)
    arrays = _ng_arrays(rng, 4, 3)
    arrays['alpha'][2] = arrays['alpha'][2, 0]
    post = _post(arrays, NG, torch.float64)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(
        post, torch.zeros(4, dtype=torch.float64))
    assert rows.shape == (12, 4) and aux.shape == (4, 2)
    h = rows[:, 3].reshape(4, 3)
    assert aux[2, 1] == h[2, 0] and bool((h[2] == h[2, 0]).all())
    assert bool((aux[[0, 1, 3], 1] == 0).all())
    mu, lam, df = tfe._ng.predictive_studentt_params(post)
    x = torch.tensor(rng.standard_normal((9, 3)))
    th = rows.reshape(4, 3, 4)
    got = th[None, ..., 0] + th[None, ..., 1] * x[:, None] \
        + th[None, ..., 2] * x[:, None] ** 2                   # (N, K, d)
    want = (lam / df)[None] * (x[:, None, :] - mu[None]) ** 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(rows[:, 3].numpy(),
                               (0.5 * (df + 1)).reshape(-1))


# -- kernels B5 and B6 with MNG experts ---------------------------------------

@functools.lru_cache(maxsize=None)
def _ilr_setup(d, p, dtype):
    """(x, y, JAX model, port model, JAX state, port state) of an MNG ILR:
    N = 1000 points in float32, 400 in float64, K = 8, posteriors from
    responsibilities localised around random anchors in x."""
    n = 1000 if dtype == 'f32' else 400
    rng = np.random.default_rng(d + 10 * p + 100)
    x = rng.uniform(-3, 3, (n, d))
    w = rng.standard_normal((d, p))
    y = np.tanh(x @ w) * 2.0 + 0.5 + 0.1 * rng.standard_normal((n, p))
    jd = jnp.float64 if dtype == 'f64' else jnp.float32
    td = torch.float64 if dtype == 'f64' else torch.float32
    jm = JaxILR.make(size=8, input_dim=d, output_dim=p, alpha=2.0,
                     kappa=0.05, diag=True, dtype=jd)
    jm.init_transform(jnp.asarray(x, jd), jnp.asarray(y, jd))
    anchors = x[np.random.default_rng(0).choice(n, 8, replace=False)]
    logits = -np.sum((x[:, None, :] - anchors[None]) ** 2, -1) / 0.5
    resp = np.exp(logits - logits.max(-1, keepdims=True))
    resp /= resp.sum(-1, keepdims=True)
    st = jm._mf_update((jm._tx(jnp.asarray(x, jd)),
                        jm._ty(jnp.asarray(y, jd))), jnp.asarray(resp, jd))
    tm = BayesianILR.make(size=8, input_dim=d, output_dim=p, alpha=2.0,
                          kappa=0.05, diag=True, dtype=td, device='cpu')
    tm.init_transform(torch.as_tensor(x, dtype=td),
                      torch.as_tensor(y, dtype=td))
    return x, y, jm, tm, st, state_from_numpy(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize('has_y', [True, False])
@pytest.mark.parametrize('prediction', ['average', 'mode'])
@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
def test_mng_plain_kernels_match_pallas_interpret(d, p, prediction, has_y):
    """B5's MNG rows (p = 1) and B6's MNG tail (p = 3), plain versions,
    against ilr_predict_pallas / _ilr_p_predict_pallas (interpret mode,
    N = 1000 over blocks of 256) on a state the bridge carried over, at
    the tolerances of tests/test_pallas.py:411-416 and :462-470."""
    x, y, jm, tm, st_j, st_t = _ilr_setup(d, p, 'f32')
    assert isinstance(st_t.components[1], MNG)
    xx_j = jm._tx(jnp.asarray(x, jnp.float32))
    yy_j = jm._ty(jnp.asarray(y, jnp.float32))
    xx_t = tm._tx(torch.as_tensor(x, dtype=torch.float32))
    yy_t = tm._ty(torch.as_tensor(y, dtype=torch.float32))
    lw_j = jm.predictive_log_weights(st_j)
    lw_t = tm.predictive_log_weights(st_t)
    if p == 1:
        want = ilr_predict_pallas(*st_j.components, lw_j, xx_j,
                                  yy_j if has_y else None, True,
                                  block_size=256, prediction=prediction)
        got = cuda_ilr_predict.ilr_predict_cuda(
            *st_t.components, lw_t, xx_t, yy_t if has_y else None, True,
            prediction)
    else:
        want = _ilr_p_predict_pallas(*st_j.components, lw_j, xx_j,
                                     yy_j if has_y else None, True, 256,
                                     prediction)
        got = cuda_ilr_predict.ilr_p_predict_cuda(
            *st_t.components, lw_t, xx_t, yy_t if has_y else None, True,
            prediction)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-3, atol=1e-5 if p == 1 else 1e-4)
    if has_y:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-3, atol=2e-3)
    else:
        assert got[2] is None and want[2] is None


def test_mng_p_plain_kernel_matches_pallas_interpret_wide():
    """B6's MNG tail at K=300, d=2, p=3 (coefficients past what a block
    once staged whole): the plain version against _ilr_p_predict_pallas
    in interpret mode, 512 points, with y."""
    n, k, d, p = 512, 300, 2, 3
    rng = np.random.default_rng(31)
    x = rng.uniform(-3, 3, (n, d))
    y = (np.tanh(x @ rng.standard_normal((d, p))) * 2.0 + 0.5
         + 0.1 * rng.standard_normal((n, p)))
    jm = JaxILR.make(size=k, input_dim=d, output_dim=p, alpha=2.0,
                     kappa=0.05, diag=True, dtype=jnp.float32)
    jm.init_transform(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    anchors = x[rng.choice(n, k, replace=False)]
    logits = -np.sum((x[:, None, :] - anchors[None]) ** 2, -1) / 0.5
    resp = np.exp(logits - logits.max(-1, keepdims=True))
    resp /= resp.sum(-1, keepdims=True)
    xx_j = jm._tx(jnp.asarray(x, jnp.float32))
    yy_j = jm._ty(jnp.asarray(y, jnp.float32))
    st_j = jm._mf_update((xx_j, yy_j), jnp.asarray(resp, jnp.float32))
    st_t = state_from_numpy(jax.tree.map(np.asarray, st_j))
    tm = BayesianILR.make(size=k, input_dim=d, output_dim=p, alpha=2.0,
                          kappa=0.05, diag=True, dtype=torch.float32,
                          device='cpu')
    tm.init_transform(torch.as_tensor(x, dtype=torch.float32),
                      torch.as_tensor(y, dtype=torch.float32))
    want = _ilr_p_predict_pallas(*st_j.components,
                                 jm.predictive_log_weights(st_j), xx_j, yy_j,
                                 True, 256, 'average')
    got = cuda_ilr_predict.ilr_p_predict_cuda(
        *st_t.components, tm.predictive_log_weights(st_t),
        tm._tx(torch.as_tensor(x, dtype=torch.float32)),
        tm._ty(torch.as_tensor(y, dtype=torch.float32)), True, 'average')
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('case', ['p1-average', 'p1-mode-incremental',
                                  'p3-average', 'p3-mode', 'p3-noy'])
def test_mng_dense_predict_matches_jax_f64(case):
    """Dense predict of MNG experts in original units (diagonal (N, K, p)
    covariances scaled by scale^2, NLPD with the Jacobian) at rtol 1e-8."""
    p = 3 if case.startswith('p3') else 1
    d = 2 if p == 3 else 1
    x, y, jm, tm, st_j, st_t = _ilr_setup(d, p, 'f64')
    kw = dict(prediction='mode' if 'mode' in case else 'average',
              incremental='incremental' in case)
    with_y = case != 'p3-noy'
    want = jm.predict(st_j, jnp.asarray(x), jnp.asarray(y) if with_y
                      else None, backend='xla', **kw)
    got = tm.predict(st_t, torch.tensor(x), torch.tensor(y) if with_y
                     else None, backend='torch', **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                       atol=1e-10)
    assert got[1].shape == (x.shape[0], p)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_mng_dense_predictive_pieces_match_jax_f64(dist):
    x, y, jm, tm, st_j, st_t = _ilr_setup(2, 3, 'f64')
    xj, xt = jnp.asarray(x), torch.tensor(x)
    mus_t, cov_t = tm.predictive_moments(st_t, xt, dist)
    mus_j, cov_j = jm.predictive_moments(st_j, xj, dist)
    assert cov_t.shape == (x.shape[0], 8, 3)
    w_t = tm.predictive_weights(st_t, xt, dist)
    for got, want in [
            (cov_t, cov_j),
            (tm.mixture_moments(mus_t, cov_t, w_t, True)[1],
             jm.mixture_moments(mus_j, cov_j,
                                jm.predictive_weights(st_j, xj, dist),
                                True)[1]),
            (tm.log_predictive_likelihood(st_t, xt, torch.tensor(y), dist),
             jm.log_predictive_likelihood(st_j, xj, jnp.asarray(y), dist))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12)


@pytest.mark.parametrize('d,p,prediction', [(1, 1, 'average'),
                                            (2, 3, 'mode')])
def test_mng_kernel_branch_glue_matches_dense(monkeypatch, d, p, prediction):
    """The model's kernel branch for MNG experts (coefficients, float32
    round trip, inverse standardization, NLPD Jacobian), through the
    kernels' plain versions, against the dense path."""
    x, y, _, tm, _, st = _ilr_setup(d, p, 'f32')
    xt, yt = (torch.as_tensor(x, dtype=torch.float32),
              torch.as_tensor(y, dtype=torch.float32))
    dense = tm.predict(st, xt, yt, prediction=prediction, backend='torch')
    monkeypatch.setattr(tilr, 'resolve_backend', lambda backend, x: True)
    fused = tm.predict(st, xt, yt, prediction=prediction)
    scale = tm.output_transform.scale.numpy()
    np.testing.assert_allclose(fused[0].numpy(), dense[0].numpy(),
                               rtol=1e-4, atol=1e-4 * scale.max())
    np.testing.assert_allclose(fused[1].numpy(), dense[1].numpy(),
                               rtol=2e-3, atol=1e-4 * scale.max() ** 2)
    np.testing.assert_allclose(fused[3].numpy(), dense[3].numpy(),
                               rtol=1e-3, atol=2e-3)


# -- the diagonal GMM and the MNG ILR, whole ----------------------------------

@functools.lru_cache(maxsize=None)
def _vi_setup():
    """The data of _gmm_problem in float64 and a JAX state after 2 VI
    sweeps from random responsibilities."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float64)
    jm = JaxGMM.make(size=8, dim=2, gating='dp', alpha=1.0, diag=True,
                     kappa=0.05, dtype=jnp.float64)
    init, _ = jm.fit_vi_fused(x, key=1, maxiter=2, backend='xla')
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, diag=True,
                          kappa=0.05, dtype=torch.float64, device='cpu')
    return jm, tm, x, init


@pytest.mark.parametrize('route', ['torch', 'kernel_plain'])
def test_diag_gmm_vi_fused_matches_jax_f64(monkeypatch, route):
    """Fused VI of the diagonal GMM from a shared JAX state: through the
    blockwise engine, the ELBO trace and the posterior at rtol 1e-8;
    through B1's plain version over the diagonal map, which runs in
    float32 like the kernel, the trace at rtol 1e-6 (f32 rounding of sums
    over 4096 points) and the posterior at rtol 1e-4."""
    jm, tm, x, init = _vi_setup()
    st_j, v_j = jm.fit_vi_fused(x, maxiter=10, init_state=init,
                                randomize=False, backend='xla')
    tol = dict(trace=1e-8, state=1e-8, atol=1e-9)
    if route == 'kernel_plain':
        monkeypatch.setattr(tmix, 'resolve_backend', lambda backend, x: True)
        tol = dict(trace=1e-6, state=1e-4, atol=1e-6)
    st_t, v_t = tm.fit_vi_fused(
        torch.tensor(np.asarray(x)), maxiter=10,
        init_state=state_from_numpy(jax.tree.map(np.asarray, init)),
        randomize=False, block_size=1000)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                               rtol=tol['trace'])
    _tree(st_t, jax.tree.map(np.asarray, st_j), rtol=tol['state'],
          atol=tol['atol'])
    assert bool((torch.diff(v_t) > -1e-6).all())
    assert isinstance(st_t.components, NG)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_diag_gmm_log_predictive_of_fitted_state_matches_jax(
        monkeypatch, dist):
    jm, tm, x, init = _vi_setup()
    want = jm.log_predictive(init, x, dist=dist, backend='xla')
    st = state_from_numpy(jax.tree.map(np.asarray, init))
    xt = torch.tensor(np.asarray(x))
    np.testing.assert_allclose(tm.log_predictive(st, xt, dist=dist).numpy(),
                               np.asarray(want), rtol=1e-8)
    monkeypatch.setattr(tmix, 'resolve_backend', lambda backend, x: True)
    # the kernel branch (B4 / B3-diag plain versions) in float32
    np.testing.assert_allclose(tm.log_predictive(st, xt, dist=dist).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_diag_gmm_gibbs_fused_recovers_clusters():
    x = torch.tensor(np.asarray(_vi_setup()[2]), dtype=torch.float32)
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, diag=True,
                          kappa=0.05, device='cpu')
    gs = tm.fit_gibbs_fused(x, key=2, maxiter=20, block_size=1024)
    assert isinstance(gs, GibbsState) and gs.labels.shape == (4096,)
    for leaf in (gs.components.mu, gs.components.beta, gs.log_pi,
                 gs.params.lmbda_diag):
        assert bool(torch.isfinite(leaf).all())
    assert bool((gs.components.beta > 0).all())
    counts = np.bincount(gs.labels.numpy(), minlength=8)
    big = np.nonzero(counts >= 0.2 * 4096)[0]
    assert len(big) == 3, counts
    mus = gs.components.mu.numpy()[big]
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(mus - t, axis=-1)) < 0.5
    # the unit-precision truth: lambda_diag near 2
    lam = gs.params.lmbda_diag.numpy()[big]
    assert np.all((lam > 1.5) & (lam < 2.7)), lam


def test_mng_vi_fused_trace_matches_jax_f64():
    rng = np.random.default_rng(21)
    x = rng.uniform(-3, 3, (1200, 2))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((1200, 1))
    jm = JaxILR.make(size=6, input_dim=2, output_dim=1, alpha=2.0,
                     kappa=0.05, diag=True, dtype=jnp.float64)
    jm.init_transform(jnp.asarray(x), jnp.asarray(y))
    init = jm._mf_update((jm._tx(jnp.asarray(x)), jm._ty(jnp.asarray(y))),
                         jnp.asarray(rng.dirichlet(np.ones(6), 1200)))
    tm = BayesianILR.make(size=6, input_dim=2, output_dim=1, alpha=2.0,
                          kappa=0.05, diag=True, dtype=torch.float64,
                          device='cpu')
    tm.init_transform(torch.tensor(x), torch.tensor(y))
    st_j, v_j = jm.fit_vi_fused((jnp.asarray(x), jnp.asarray(y)), maxiter=8,
                                init_state=init, randomize=False,
                                backend='xla', block_size=400)
    st_t, v_t = tm.fit_vi_fused(
        (torch.tensor(x), torch.tensor(y)), maxiter=8,
        init_state=state_from_numpy(jax.tree.map(np.asarray, init)),
        randomize=False, block_size=500)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _tree(st_t, jax.tree.map(np.asarray, st_j), rtol=1e-8, atol=1e-9)
    assert isinstance(st_t.components[1], MNG)


def test_mng_gibbs_then_vi_recovers_the_sine():
    """The flagship recipe with MNG experts on the fused engines (Gibbs
    init -> VI warm start -> predict) on tests/test_ilr.py's sine data,
    held to its diag-expert bound: RMSE < 0.15 (noise floor 0.1), a
    monotone ELBO in float64, mean NLPD < 0."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(-6.0, 6.0, (1200, 1)))
    y = torch.sin(x) + 0.1 * torch.tensor(rng.standard_normal((1200, 1)))
    m = BayesianILR.make(size=30, input_dim=1, output_dim=1,
                         gating='stick-breaking', alpha=5.0, kappa=0.05,
                         K_scale=1e-2, diag=True, dtype=torch.float64,
                         device='cpu')
    m.init_transform(x, y)
    g = m.fit_gibbs_fused((x, y), key=0, maxiter=50)
    assert type(g.params[1]).__name__ == 'DiagLinGaussParams'
    st, vlb = m.fit_vi_fused((x, y), key=1, maxiter=150,
                             init_state=MFState(g.components, g.gating),
                             randomize=False)
    d = np.diff(vlb.numpy())
    assert np.all(d > -1e-6), d.min()
    mu, var, std, nlpd = m.predict(st, x, y)
    rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
    assert rmse < 0.15, rmse
    assert float(nlpd.mean()) < 0.0
    assert bool((var > 0).all())


def test_diag_configs_and_bridge():
    g = MixtureConfig(size=4, dim=3, diag=True).build(torch.float64,
                                                      device='cpu')
    assert isinstance(g.components_prior, NG)
    assert g.components_prior.mu.dtype == torch.float64
    m = ILRConfig(size=5, input_dim=2, output_dim=3,
                  diag=True).build(device='cpu')
    assert isinstance(m.components_prior[1], MNG) and m.diag
    assert m.components_prior[1].alpha.shape == (5, 3)
    _, _, x, init = _vi_setup()
    src = jax.tree.map(np.asarray, init)
    port = state_from_numpy(src)
    assert isinstance(port.components, NG)
    _tree(port, src, rtol=0.0, atol=0.0)
    _, _, _, _, st_j, st_t = _ilr_setup(1, 1, 'f64')
    assert type(st_t.components[1]).__name__ == 'MNG'
    _tree(st_t, jax.tree.map(np.asarray, st_j), rtol=0.0, atol=0.0)
    params = state_from_numpy(jax.tree.map(
        np.asarray, jmg.mode_params(st_j.components[1])))
    assert type(params).__name__ == 'DiagLinGaussParams'
