"""The scale-tied families and the tied-affine experts of the port against
mimo_tpu, on the CPU: the poolers, the four exact tied draws (their
posteriors against the reference's in float64 at rtol 1e-8, their
moments, and the empty-component fault the port fixes), the TiedAffine
algebra and its exact draw, tied_affine_spec against the JAX spec, kernel
B1's and B2's plain versions on the tied-affine ILR theta against the
Pallas E-step in interpret mode, the B5/B6 coefficient branches for
tied-affine experts and a HierTied basis against the Pallas serving
kernels in interpret mode, and the fused VI traces of the tied GMMs and
of the tied-activation ILR from a shared JAX state (float64, rtol
1e-8)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.conjugate.families as jfam
from mimo_tpu.distributions import affine as jaff
from mimo_tpu.distributions import mnw as jmnw
from mimo_tpu.distributions import ng as jng
from mimo_tpu.distributions import niw as jniw
from mimo_tpu.distributions import tied_gibbs as jtg
from mimo_tpu.distributions.mnw import augment as jaugment
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas
from mimo_tpu.ops.pallas_gibbs import fused_gibbs_pallas
from mimo_tpu.ops.pallas_predict import (
    _ilr_p_predict_pallas, ilr_predict_pallas)

import mimo_tpu_torch.conjugate.families as tfam
import mimo_tpu_torch.models.ilr as tilr
import mimo_tpu_torch.models.mixture as tmix
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import ILRConfig, MixtureConfig
from mimo_tpu_torch.distributions import affine as taff
from mimo_tpu_torch.distributions import tied_gibbs as ttg
from mimo_tpu_torch.distributions.affine import TiedAffine
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs, cuda_ilr_predict
from mimo_tpu_torch.ops import family_estep as tfe

torch.set_num_threads(1)
TRUE_MU = np.array([[-3., 0.], [3., 0.], [0., 4.]])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(tree_np, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree_np)


def _tree(got, want, rtol, atol):
    """Leaf by leaf, in field order."""
    got, want = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _psd(rng, k, d, scale=1.0):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


# -- tied priors and one-hot statistics, as numpy trees of the JAX classes --

K, D, P = 4, 2, 2


def _prior(kind):
    """The tied prior of each base family (scale identical over K)."""
    if kind == 'niw':
        return _np(jniw.NIW.standard(K, D, kappa=0.05, psi_scale=0.5,
                                     dtype=jnp.float64))
    if kind == 'ng':
        return _np(jng.NG.standard(K, D, kappa=0.05, dtype=jnp.float64))
    if kind == 'mnw':
        return _np(jmnw.MNW.standard(K, P, D + 1, K_scale=0.1,
                                     dtype=jnp.float64))
    from mimo_tpu.distributions import mng as jmg
    return _np(jmg.MNG.standard(K, P, D + 1, K_scale=0.1, dtype=jnp.float64))


def _one_hot_stats(kind, rng, n=200, empty=1):
    """The kind's statistics of n points with one-hot labels, component
    `empty` holding none (its sums are exactly 0)."""
    x = rng.standard_normal((n, D)) * 2 + 0.5
    y = x @ rng.standard_normal((D, P)) + 0.3 * rng.standard_normal((n, P))
    labels = rng.integers(0, K - 1, n)
    labels[labels >= empty] += 1
    resp = jnp.asarray(np.eye(K)[labels])
    if kind == 'niw':
        st = jniw.suff_stats(jnp.asarray(x), resp)
    elif kind == 'ng':
        st = jng.suff_stats(jnp.asarray(x), resp)
    else:
        st = jmnw.suff_stats(jaugment(jnp.asarray(x), True), jnp.asarray(y),
                             resp)
    return _np(st)


_DRAWS = {'niw': (jtg.tied_niw_gibbs, ttg.tied_niw_gibbs),
          'ng': (jtg.tied_ng_gibbs, ttg.tied_ng_gibbs),
          'mnw': (jtg.tied_mnw_gibbs, ttg.tied_mnw_gibbs),
          'mng': (jtg.tied_mng_gibbs, ttg.tied_mng_gibbs)}


# -- the poolers --------------------------------------------------------------

@pytest.mark.parametrize('kind', ['niw', 'ng', 'mnw', 'mng'])
def test_poolers_match_jax_f64(kind):
    """The tied update pools the base posterior across K as the reference
    does: inv(mean psi^{-1}) and mean nu, or mean alpha and beta."""
    rng = np.random.default_rng(1)
    prior = _prior(kind)
    st = _np(_one_hot_stats(kind, rng, empty=3))
    st_j = _jax(st)
    base_j = {'niw': jfam.gaussian_family(), 'ng': jfam.diag_gaussian_family(),
              'mnw': jfam.linear_family(), 'mng': jfam.diag_linear_family()}
    base_t = {'niw': tfam.gaussian_family(), 'ng': tfam.diag_gaussian_family(),
              'mnw': tfam.linear_family(), 'mng': tfam.diag_linear_family()}
    post_j = base_j[kind].update(_jax(prior), st_j)
    pooled_j = jfam._POOLERS[type(post_j)](post_j)
    post_t = state_from_numpy(_np(post_j))
    _tree(tfam._POOLERS[type(post_t)](post_t), _np(pooled_j), rtol=1e-8,
          atol=1e-12)
    tied_t = tfam.tied_family(base_t[kind])
    _tree(tied_t.update(state_from_numpy(prior), state_from_numpy(st)),
          _np(pooled_j), rtol=1e-8, atol=1e-12)
    assert tied_t.gibbs_update is ttg.tied_gibbs_update


# -- the exact tied draws -----------------------------------------------------

@pytest.mark.parametrize('kind', ['niw', 'ng', 'mnw', 'mng'])
def test_tied_draw_posterior_matches_jax_f64(kind):
    """On one-hot statistics with an empty component (counts in {0} and
    [1, inf), x = 0 where n = 0) every exact tied draw's posterior equals
    the reference's in float64 at rtol 1e-8; the draws are the port's own
    (Philox, not threefry)."""
    rng = np.random.default_rng(2)
    prior, st = _prior(kind), _one_hot_stats(kind, rng)
    jdraw, tdraw = _DRAWS[kind]
    want, _ = jdraw(jax.random.PRNGKey(0), _jax(prior), _jax(st))
    got, params = tdraw(torch.Generator().manual_seed(0),
                        state_from_numpy(prior), state_from_numpy(st))
    _tree(got, _np(want), rtol=1e-8, atol=1e-12)
    for leaf in params:
        assert bool(torch.isfinite(leaf).all())
    # the shared scale is one draw, broadcast over K
    scale = params[1]
    assert torch.equal(scale, scale[:1].expand(scale.shape))


@pytest.mark.parametrize('kind', ['niw', 'ng'])
def test_tied_draw_empty_component_fault(kind):
    """The reference forms xbar = x / max(n, 1e-12): in float32 an empty
    component with x = 1e8 (and the second moment of that point) gives
    xbar^2 = inf and n xbar^2 = 0 inf = NaN in the shared scale. The
    port divides by max(n, 1) and its draw stays finite."""
    rng = np.random.default_rng(3)
    prior = jax.tree.map(lambda a: np.asarray(a, np.float32), _prior(kind))
    st = jax.tree.map(lambda a: np.array(a, np.float32),
                      _one_hot_stats(kind, rng))
    bad = np.array([1e8, -1e8], np.float32)
    st.x[1] = bad
    if kind == 'niw':
        st.xxT[1] = np.outer(bad, bad)
    else:
        st.xsq[1] = bad * bad
    jdraw, tdraw = _DRAWS[kind]
    ref, _ = jdraw(jax.random.PRNGKey(0), _jax(prior), _jax(st))
    scale = ref.psi if kind == 'niw' else ref.beta
    assert np.isnan(np.asarray(scale)).any()
    post, params = tdraw(torch.Generator().manual_seed(0),
                         state_from_numpy(prior), state_from_numpy(st))
    for leaf in jax.tree.leaves(state_to_numpy((post, params))):
        assert np.isfinite(leaf).all()


def _within(samples, want):
    """The draws' mean within 5 standard errors of `want`."""
    se = samples.std(0) / np.sqrt(samples.shape[0])
    assert bool(((samples.mean(0) - want).abs() <= 5 * se + 1e-12).all())


@pytest.mark.parametrize('kind', ['niw', 'ng', 'mnw', 'mng'])
def test_tied_draw_moments(kind):
    """Over 2000 draws from one conditional: the shared scale's mean is
    nu' psi' (Wishart) or alpha' / beta' (Gamma), and the locations
    (means or regression matrices) centre on the posterior's."""
    rng = np.random.default_rng(4)
    prior = state_from_numpy(_prior(kind))
    st = state_from_numpy(_one_hot_stats(kind, rng, n=40))
    gen = torch.Generator().manual_seed(5)
    draws = [ttg.tied_gibbs_update(gen, prior, st) for _ in range(2000)]
    post = draws[0][0]
    scale = torch.stack([p[1][0] for _, p in draws])
    loc = torch.stack([p[0] for _, p in draws])
    if kind in ('niw', 'mnw'):
        _within(scale, post.nu[0] * post.psi[0])
    else:
        _within(scale, post.alpha[0] / post.beta[0])
    _within(loc, post.mu if kind in ('niw', 'ng') else post.M)


# -- the tied-affine experts --------------------------------------------------

def _affine_arrays(rng, k=4, p=2, q=2):
    """A TiedAffine posterior (numpy leaves, 0-d nu) and its prior."""
    post = jaff.TiedAffine(M=rng.standard_normal((p, q)),
                           K_=_psd(rng, 1, q, 30.0)[0],
                           mus=rng.standard_normal((k, p)),
                           kappas=rng.uniform(20.0, 200.0, k),
                           psi=_psd(rng, 1, p, 0.05)[0],
                           nu=np.asarray(rng.uniform(50.0, 300.0)))
    prior = _np(jaff.TiedAffine.standard(k, p, q, K_scale=0.1, kappa=0.05,
                                         dtype=jnp.float64))
    return post, prior


def _affine_data(rng, n=150, k=4, p=2, q=2, one_hot=False):
    x = rng.uniform(-2, 2, (n, q))
    y = np.tanh(x @ rng.standard_normal((q, p))) + 0.1 * rng.standard_normal(
        (n, p))
    resp = (np.eye(k)[rng.integers(0, k, n)] if one_hot
            else rng.dirichlet(np.ones(k), n))
    return x, y, resp


@pytest.mark.parametrize('fn', ['suff_stats', 'update', 'to_packed_mnw',
                                'ell', 'kl', 'mode', 'mean', 'studentt',
                                'gaussian', 'slope_mstep'])
def test_affine_algebra_matches_jax_f64(fn):
    rng = np.random.default_rng(6)
    post, prior = _affine_arrays(rng)
    x, y, resp = _affine_data(rng)
    qj, pj = _jax(post), _jax(prior)
    qt, pt = state_from_numpy(post), state_from_numpy(prior)
    assert qt.nu.dim() == 0 and qt.M.shape == (2, 2)
    sj = jaff.suff_stats(jnp.asarray(x), jnp.asarray(y), jnp.asarray(resp))
    st = taff.suff_stats(torch.tensor(x), torch.tensor(y),
                         torch.tensor(resp))
    xa_j, xa_t = jaugment(jnp.asarray(x), True), torch.tensor(
        np.concatenate([x, np.ones((len(x), 1))], 1))
    yj, yt = jnp.asarray(y), torch.tensor(y)
    if fn == 'suff_stats':
        got, want = st, sj
    elif fn == 'update':
        got = taff.posterior_update(pt, st, nb_iter=6)
        want = jaff.posterior_update(pj, sj, nb_iter=6)
    elif fn == 'to_packed_mnw':
        got, want = taff.to_packed_mnw(qt), jaff.to_packed_mnw(qj)
    elif fn == 'ell':
        got = taff.expected_log_likelihood(qt, xa_t, yt)
        want = jaff.expected_log_likelihood(qj, xa_j, yj)
    elif fn == 'kl':
        got, want = taff.kl_divergence(qt, pt), jaff.kl_divergence(qj, pj)
    elif fn == 'mode':
        got, want = taff.mode_params(qt), jaff.mode_params(qj)
    elif fn == 'mean':
        got, want = taff.mean_params(qt), jaff.mean_params(qj)
    elif fn == 'studentt':
        got = taff.log_predictive_studentt(qt, xa_t, yt)
        want = jaff.log_predictive_studentt(qj, xa_j, yj)
    elif fn == 'gaussian':
        got = taff.log_predictive_gaussian(qt, xa_t, yt)
        want = jaff.log_predictive_gaussian(qj, xa_j, yj)
    else:
        got = taff._slope_precision_mstep(pt, st, qt.mus)
        want = jaff._slope_precision_mstep(pj, sj, qj.mus)
    _tree(got, _np(want), rtol=1e-8, atol=1e-10)


def test_affine_exact_draw_posterior_and_moments():
    """The exact tied-affine draw: its posterior equals the reference's
    (float64, rtol 1e-8) on one-hot statistics; over 2000 draws the
    shared Lambda's mean is nu' psi', the slope centres on M' and each
    offset on the posterior's offset mean."""
    rng = np.random.default_rng(7)
    _, prior = _affine_arrays(rng)
    x, y, resp = _affine_data(rng, n=60, one_hot=True)
    sj = jaff.suff_stats(jnp.asarray(x), jnp.asarray(y), jnp.asarray(resp))
    st = state_from_numpy(_np(sj))
    want, _ = jaff.gibbs_update_exact(jax.random.PRNGKey(0), _jax(prior), sj)
    pt = state_from_numpy(prior)
    gen = torch.Generator().manual_seed(8)
    draws = [taff.gibbs_update_exact(gen, pt, st) for _ in range(2000)]
    post = draws[0][0]
    _tree(post, _np(want), rtol=1e-8, atol=1e-12)
    a = torch.stack([p.A for _, p in draws])               # (S, K, p, q+1)
    lam = torch.stack([p.lmbda[0] for _, p in draws])
    assert all(torch.equal(p.A[:, :, :2], p.A[:1, :, :2].expand(4, 2, 2))
               for _, p in draws[:5])
    _within(lam, post.nu * post.psi)
    _within(a[:, 0, :, :2], post.M)
    _within(a[:, :, :, 2], post.mus)


@pytest.mark.parametrize('part', ['theta', 'theta_plugin', 'unpack', 'ell'])
def test_tied_affine_spec_pieces_match_jax(part):
    """tied_affine_spec and the ILR spec with a HierTied basis and
    tied-affine experts against mimo_tpu's; the transposed map is the
    affine ILR map the kernels assemble."""
    rng = np.random.default_rng(9)
    post, _ = _affine_arrays(rng, p=1, q=2)
    qj, qt = _jax(post), state_from_numpy(post)
    js, ts = jfe.tied_affine_spec(2, 1), tfe.tied_affine_spec(2, 1)
    if part == 'theta':
        got, want = ts.theta(qt), js.theta(qj)
    elif part == 'theta_plugin':
        got = ts.theta_plugin(taff.mode_params(qt))
        want = js.theta_plugin(jaff.mode_params(qj))
    elif part == 'unpack':
        acc = rng.standard_normal((4, tfe.linear_width(1, 3)))
        got, want = ts.unpack(torch.tensor(acc)), js.unpack(jnp.asarray(acc))
        assert type(got).__name__ == 'AffineStats'
    else:   # features . theta is the tied-affine expected log-likelihood
        x, y, _ = _affine_data(rng, p=1)
        got = ts.features((torch.tensor(x), torch.tensor(y))) @ ts.theta(qt).T
        want = jaff.expected_log_likelihood(qj, jaugment(jnp.asarray(x), True),
                                            jnp.asarray(y))
    _tree(got, _np(want), rtol=1e-10, atol=1e-12)
    spec = tfe.ilr_spec(2, 1, hier_basis=True, tied_affine=True)
    assert spec.features_t == tfe.ilr_features_t(True)
    assert cuda_estep.feature_kind(spec.features_t) == cuda_estep.ILR


# -- the tied-activation ILR: kernels B1, B2, B5, B6 --------------------------

@functools.lru_cache(maxsize=None)
def _ilr_setup(d, p, dtype, basis, experts):
    """(x, y, JAX model, port model, JAX state, port state) of an ILR with
    the given basis ('niw' or 'hier') and experts ('mnw', 'mng' or
    'tied'): N = 1000 points in float32, 400 in float64, K = 8,
    posteriors from responsibilities localised around random anchors."""
    n = 1000 if dtype == 'f32' else 400
    rng = np.random.default_rng(d + 10 * p + 200)
    x = rng.uniform(-3, 3, (n, d))
    y = np.tanh(x @ rng.standard_normal((d, p))) * 2.0 + 0.5 \
        + 0.1 * rng.standard_normal((n, p))
    jd = jnp.float64 if dtype == 'f64' else jnp.float32
    td = torch.float64 if dtype == 'f64' else torch.float32
    kw = dict(size=8, input_dim=d, output_dim=p, alpha=2.0, kappa=0.05,
              diag=experts == 'mng', tied_affine=experts == 'tied',
              hier_basis=basis == 'hier', maxsubiter=5)
    jm = JaxILR.make(dtype=jd, **kw)
    jm.init_transform(jnp.asarray(x, jd), jnp.asarray(y, jd))
    anchors = x[np.random.default_rng(0).choice(n, 8, replace=False)]
    logits = -np.sum((x[:, None, :] - anchors[None]) ** 2, -1) / 0.5
    resp = np.exp(logits - logits.max(-1, keepdims=True))
    resp /= resp.sum(-1, keepdims=True)
    st = jm._mf_update((jm._tx(jnp.asarray(x, jd)),
                        jm._ty(jnp.asarray(y, jd))), jnp.asarray(resp, jd))
    tm = BayesianILR.make(dtype=td, **kw, device='cpu')
    tm.init_transform(torch.as_tensor(x, dtype=td),
                      torch.as_tensor(y, dtype=td))
    return x, y, jm, tm, st, state_from_numpy(_np(st))


def test_tied_affine_b1_plain_matches_pallas_interpret_masked_tail():
    """B1's plain version on the tied-activation ILR theta (HierTied basis
    x tied-affine experts, the affine ILR map) against the Pallas E-step,
    N = 1000 over blocks of 384, at tests/test_pallas.py:128-133's
    tolerances."""
    x, y, jm, tm, st_j, st_t = _ilr_setup(2, 1, 'f32', 'hier', 'tied')
    n = 1000
    dj = (jm._tx(jnp.asarray(x, jnp.float32)),
          jm._ty(jnp.asarray(y, jnp.float32)))
    log_pi = st_t.gating.expected_log_pi()
    xts = tuple(jnp.pad(a.T, ((0, 0), (0, (-n) % 384))) for a in dj)
    want = fused_estep_pallas(jm._estep_spec(), st_j.components,
                              jnp.asarray(log_pi.numpy()), xts, 384, n)
    padded = tuple(torch.cat([torch.tensor(np.asarray(a)).T,
                              torch.full((a.shape[1], 24), 1e3)], 1)
                   for a in dj)
    got = cuda_estep.fused_estep_cuda(tm._estep_spec(), st_t.components,
                                      log_pi, padded, n)
    assert type(got.stats[1]).__name__ == 'AffineStats'
    _tree(got.stats, want.stats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


def test_tied_affine_b2_plain_labels_and_one_hot_stats():
    """B2's plain version on the packed tied-affine plug-in theta: labels
    equal the blockwise engine's (same Philox draws) and the statistics
    are the one-hot sums of its labels, unpacked to AffineStats."""
    x, y, jm, tm, _, st_t = _ilr_setup(2, 1, 'f64', 'hier', 'tied')
    spec = tm._estep_spec()
    dt = (tm._tx(torch.tensor(x)), tm._ty(torch.tensor(y)))
    params = tm.family.mode_params(st_t.components)
    lp = st_t.gating.expected_log_pi()
    seed = torch.tensor(123456789, dtype=torch.int64)
    labels, res = cuda_gibbs.fused_gibbs_cuda(spec, seed, params, lp,
                                              tuple(a.T for a in dt), 400)
    ref_labels, _ = tfe.fused_gibbs_blockwise(spec, seed, params, lp, dt, 128)
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    assert len(torch.unique(labels)) > 1
    oh = torch.nn.functional.one_hot(labels.long(), 8).double()
    want = spec.unpack(oh.T @ spec.features(dt))
    _tree(res.stats, state_to_numpy(want), rtol=1e-12, atol=1e-10)


def test_tied_affine_b2_pallas_stats_rebuild_from_its_labels():
    """The Pallas Gibbs sweep on the tied-activation ILR's packed plug-in
    theta (interpret mode, N = 1000 over blocks of 384, masked tail, its
    own PRNG): its statistics are the one-hot sums its labels give
    through the port's ILR map and AffineStats unpack, at
    tests/test_torch_diag.py's B2 tolerances."""
    x, y, jm, tm, st_j, st_t = _ilr_setup(2, 1, 'f32', 'hier', 'tied')
    n = 1000
    dj = (jm._tx(jnp.asarray(x, jnp.float32)),
          jm._ty(jnp.asarray(y, jnp.float32)))
    params_j = jm.family.mode_params(st_j.components)
    log_pi = np.log(np.asarray(st_j.gating.gamma)
                    / np.sum(st_j.gating.gamma))
    xts = tuple(jnp.pad(a.T, ((0, 0), (0, (-n) % 384))) for a in dj)
    lab_j, res_j = fused_gibbs_pallas(jm._estep_spec(), 7, params_j,
                                      jnp.asarray(log_pi, jnp.float32), xts,
                                      384, n)
    spec = tm._estep_spec()
    feats = spec.features(tuple(torch.tensor(np.asarray(a)) for a in dj))
    oh = torch.nn.functional.one_hot(torch.tensor(np.asarray(lab_j)).long(),
                                     8).float()
    _tree(spec.unpack(oh.T @ feats), res_j.stats, rtol=1e-5, atol=1e-4)


def test_tied_activation_kernel_route_casts_and_checks(monkeypatch):
    """The engines' kernel route (B1's plain version, float32) on the
    tied-activation ILR: the float32 statistics, AffineStats among them,
    cast back to float64, and the finite check walks a TiedAffine state
    (K-less leaves, 0-d nu); the trace tracks the float64 route."""
    x, y, _, tm, _, init = _ilr_setup(2, 1, 'f64', 'hier', 'tied')
    data = (torch.tensor(x), torch.tensor(y))
    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', 'raise')
    _, v_t = tm.fit_vi_fused(data, maxiter=4, init_state=init,
                             randomize=False)
    monkeypatch.setattr(tmix, 'resolve_backend', lambda backend, x: True)
    st_k, v_k = tm.fit_vi_fused(data, maxiter=4, init_state=init,
                                randomize=False)
    assert st_k.components[1].nu.dtype == torch.float64
    assert st_k.components[1].nu.dim() == 0
    np.testing.assert_allclose(v_k.numpy(), v_t.numpy(), rtol=1e-5)


def test_tied_affine_family_refuses_svi():
    """The tied-affine experts have no SVI blend, as in the reference."""
    with pytest.raises(NotImplementedError, match='tied-affine'):
        tfam.tied_affine_family().svi_blend(None, None, None, 1.0, 0.5)


@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
@pytest.mark.parametrize('basis,experts', [('niw', 'tied'), ('hier', 'mnw'),
                                           ('hier', 'mng'), ('hier', 'tied')])
def test_new_serving_branches_match_pallas_interpret(basis, experts, d, p):
    """B5 (p = 1) and B6 (p = 3) plain versions on the new coefficient
    branches (tied-affine experts repacked through to_packed_mnw; the
    HierTied basis rows) against ilr_predict_pallas /
    _ilr_p_predict_pallas in interpret mode (N = 1000 over blocks of
    256), average with y and mode without, at tests/test_pallas.py's
    tolerances."""
    x, y, jm, tm, st_j, st_t = _ilr_setup(d, p, 'f32', basis, experts)
    xx_j = jm._tx(jnp.asarray(x, jnp.float32))
    yy_j = jm._ty(jnp.asarray(y, jnp.float32))
    xx_t = tm._tx(torch.as_tensor(x, dtype=torch.float32))
    yy_t = tm._ty(torch.as_tensor(y, dtype=torch.float32))
    lw_j = jm.predictive_log_weights(st_j)
    lw_t = tm.predictive_log_weights(st_t)
    for prediction, with_y in (('average', True), ('mode', False)):
        if p == 1:
            want = ilr_predict_pallas(*st_j.components, lw_j, xx_j,
                                      yy_j if with_y else None, True,
                                      block_size=256, prediction=prediction)
            got = cuda_ilr_predict.ilr_predict_cuda(
                *st_t.components, lw_t, xx_t, yy_t if with_y else None, True,
                prediction)
        else:
            want = _ilr_p_predict_pallas(*st_j.components, lw_j, xx_j,
                                         yy_j if with_y else None, True, 256,
                                         prediction)
            got = cuda_ilr_predict.ilr_p_predict_cuda(
                *st_t.components, lw_t, xx_t, yy_t if with_y else None, True,
                prediction)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=2e-3, atol=1e-5 if p == 1 else 1e-4)
        if with_y:
            np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                       rtol=1e-3, atol=2e-3)
        else:
            assert got[2] is None


@pytest.mark.parametrize('p', [1, 3])
def test_tied_activation_predict_matches_jax_f64(monkeypatch, p):
    """The dense predict of the tied-activation ILR against mimo_tpu's at
    rtol 1e-8, and the model's kernel branch (B5/B6 plain versions,
    float32) against the dense path."""
    d = 1 if p == 1 else 2
    x, y, jm, tm, st_j, st_t = _ilr_setup(d, p, 'f64', 'hier', 'tied')
    want = jm.predict(st_j, jnp.asarray(x), jnp.asarray(y), backend='xla')
    got = tm.predict(st_t, torch.tensor(x), torch.tensor(y), backend='torch')
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-10)
    monkeypatch.setattr(tilr, 'resolve_backend', lambda backend, x: True)
    fused = tm.predict(st_t, torch.tensor(x).float(), torch.tensor(y).float())
    scale = tm.output_transform.scale.max().item()
    np.testing.assert_allclose(fused[0].numpy(), got[0].numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(fused[1].numpy(), got[1].numpy(), rtol=2e-3,
                               atol=1e-4 * scale ** 2)
    np.testing.assert_allclose(fused[3].numpy(), got[3].numpy(), rtol=1e-3,
                               atol=2e-3)


# -- the tied GMMs and the tied-activation ILR, whole -------------------------

def _tied_gmm_kw(diag):
    """A tied GMM: NIW with DP gating (tgmm), or NG with Dirichlet
    gating (tdgmm)."""
    kw = (dict(gating='dirichlet', diag=True) if diag
          else dict(gating='dp', psi_scale=0.5))
    return dict(size=8, dim=2, tied=True, kappa=0.05, **kw)


@functools.lru_cache(maxsize=None)
def _gmm_setup(diag):
    """N=4096, K=8, d=2 (tests/test_pallas.py's problem) in float64, the
    tied GMM and a JAX state after 2 VI sweeps from random
    responsibilities."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float64)
    jm = JaxGMM.make(dtype=jnp.float64, **_tied_gmm_kw(diag))
    init, _ = jm.fit_vi_fused(x, key=1, maxiter=2, backend='xla')
    tm = BayesianGMM.make(dtype=torch.float64, **_tied_gmm_kw(diag),
                          device='cpu')
    return jm, tm, x, init


@pytest.mark.parametrize('diag', [False, True])
def test_tied_gmm_vi_fused_matches_jax_f64(diag):
    """Fused VI of the tied GMM (the base spec over the pooled posterior)
    from a shared JAX state: the ELBO trace and the posterior at rtol
    1e-8; the scale stays pooled (equal over K)."""
    jm, tm, x, init = _gmm_setup(diag)
    st_j, v_j = jm.fit_vi_fused(x, maxiter=8, init_state=init,
                                randomize=False, backend='xla')
    st_t, v_t = tm.fit_vi_fused(torch.tensor(np.asarray(x)), maxiter=8,
                                init_state=state_from_numpy(_np(init)),
                                randomize=False, block_size=1000)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _tree(st_t, _np(st_j), rtol=1e-8, atol=1e-9)
    scale = st_t.components.beta if diag else st_t.components.psi
    torch.testing.assert_close(scale, scale[:1].expand(scale.shape))
    assert isinstance(st_t.components, NG if diag else NIW)


@pytest.mark.parametrize('diag', [False, True])
def test_tied_gmm_gibbs_fused_recovers_clusters(diag):
    """The tgmm / tdgmm recipe (tests/test_gmm.py:145-159) on the fused
    engine and the port's own chain: a component with > 100 points
    within 0.5 of each true mean, and one shared precision."""
    x = torch.tensor(np.asarray(_gmm_setup(diag)[2]), dtype=torch.float32)
    tm = BayesianGMM.make(**_tied_gmm_kw(diag), device='cpu')
    gs = tm.fit_gibbs_fused(x, key=10, maxiter=100, block_size=1024)
    counts = np.bincount(gs.labels.numpy(), minlength=8)
    mus = gs.components.mu.numpy()[counts > 100]
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(mus - t, axis=-1)) < 0.5, (mus, counts)
    lam = gs.params.lmbda_diag if diag else gs.params.lmbda
    assert torch.equal(lam, lam[:1].expand(lam.shape))


def test_tied_activation_vi_trace_matches_jax_f64():
    """Fused VI of the tied-activation ILR (HierTied basis, tied-affine
    experts, 5 inner rounds each) from a shared JAX state: the ELBO trace
    and the posterior at rtol 1e-8. The tied-affine update averages its
    slope and precision over K, so, in the reference as here, the ELBO
    is not monotone."""
    x, y, jm, tm, init, init_t = _ilr_setup(2, 1, 'f64', 'hier', 'tied')
    st_j, v_j = jm.fit_vi_fused((jnp.asarray(x), jnp.asarray(y)), maxiter=6,
                                init_state=init, randomize=False,
                                backend='xla', block_size=200)
    st_t, v_t = tm.fit_vi_fused((torch.tensor(x), torch.tensor(y)),
                                maxiter=6, init_state=init_t,
                                randomize=False, block_size=128)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _tree(st_t, _np(st_j), rtol=1e-8, atol=1e-9)
    assert isinstance(st_t.components[0], HierTied)
    assert isinstance(st_t.components[1], TiedAffine)
    assert st_t.components[1].M.shape == (1, 2)


def test_tied_activation_gibbs_then_vi_fits_the_sine():
    """The hilr tied-activation recipe (tests/test_ilr.py:166-187: Gibbs
    60 -> VI warm start -> predict) on the fused engines and the port's
    own chain, held to that test's bound: RMSE < 0.35."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(-6.0, 6.0, (1200, 1)))
    y = torch.sin(x) + 0.1 * torch.tensor(rng.standard_normal((1200, 1)))
    m = BayesianILR.make(size=25, input_dim=1, output_dim=1, alpha=5.0,
                         kappa=0.05, tied_affine=True, hier_basis=True,
                         maxsubiter=10, dtype=torch.float64, device='cpu')
    m.init_transform(x, y)
    g = m.fit_gibbs_fused((x, y), key=0, maxiter=60)
    assert type(g.params[1]).__name__ == 'LinGaussParams'
    st, vlb = m.fit_vi_fused((x, y), key=1, maxiter=60,
                             init_state=MFState(g.components, g.gating),
                             randomize=False)
    assert bool(torch.isfinite(vlb).all())
    mu, var, _, nlpd = m.predict(st, x, y)
    rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
    assert rmse < 0.35, rmse
    assert bool((var > 0).all()) and bool(torch.isfinite(nlpd).all())


def test_tied_configs_and_bridge():
    """The configs build the tied and tied-activation models; the bridge
    carries a TiedAffine (K-less leaves, 0-d nu) and AffineStats both
    ways."""
    g = MixtureConfig(size=4, dim=3, tied=True).build(torch.float64,
                                                      device='cpu')
    assert g.tied and isinstance(g.components_prior, NIW)
    g = MixtureConfig(size=4, dim=3, diag=True, tied=True).build(device='cpu')
    assert isinstance(g.components_prior, NG)
    m = ILRConfig(size=5, input_dim=2, output_dim=3, tied_affine=True,
                  hier_basis=True, maxsubiter=4).build(torch.float64,
                                                       device='cpu')
    assert isinstance(m.components_prior[0], HierTied)
    assert isinstance(m.components_prior[1], TiedAffine)
    assert m.affine and m.components_prior[1].M.shape == (3, 2)
    assert m.components_prior[1].nu.shape == ()
    _, _, _, _, st_j, st_t = _ilr_setup(1, 1, 'f64', 'hier', 'tied')
    src = _np(st_j)
    assert src.components[1].nu.shape == ()
    _tree(st_t, src, rtol=0.0, atol=0.0)
    back = state_to_numpy(st_t)
    assert type(back.components[1]).__name__ == 'TiedAffine'
    assert back.components[1].nu.shape == () and back.components[1].M.ndim == 2
    stats = state_from_numpy(_np(jaff.suff_stats(
        jnp.ones((3, 1)), jnp.ones((3, 1)), jnp.full((3, 5), 0.2))))
    assert type(stats).__name__ == 'AffineStats' and stats.ym.shape == (5, 1)
