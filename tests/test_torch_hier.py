"""The hierarchically-tied Gaussian family of the port against mimo_tpu,
on the CPU: the HierTied algebra (float64, rtol 1e-8), the exact
one-shot draw (its posterior against the reference's, its moments, and
the empty-component fault it fixes), hier_gaussian_spec against the JAX
spec, kernel B1's and B2's plain versions on the hierarchical theta
against the Pallas kernels in interpret mode (masked tail), kernel B3's
plain version on HierTied rows against gauss_predictive_pallas, and the
hierarchical GMM's fused VI trace from a shared JAX state (float64, rtol
1e-8)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions import hierarchical as jh
from mimo_tpu.distributions import niw as jniw
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas
from mimo_tpu.ops.pallas_gibbs import fused_gibbs_pallas
from mimo_tpu.ops.pallas_predict import gauss_predictive_pallas

import mimo_tpu_torch.models.mixture as tmix
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import MixtureConfig
from mimo_tpu_torch.conjugate import families as tfam
from mimo_tpu_torch.distributions import hierarchical as th
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.models import BayesianGMM, GibbsState
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs, cuda_predict
from mimo_tpu_torch.ops import family_estep as tfe

torch.set_num_threads(1)
TRUE_MU = np.array([[-3., 0.], [3., 0.], [0., 4.]])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(got, want, rtol, atol):
    """Leaf by leaf, in field order."""
    got, want = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _posterior(rng, k=5, d=2):
    """A HierTied posterior with numpy leaves, at the scales of a fit:
    (JAX HierTied, port HierTied), both float64."""
    a = rng.standard_normal((d, d))
    src = jh.HierTied(
        hyper=jniw.NIW(mu=rng.standard_normal((1, d)),
                       kappa=rng.uniform(5.0, 50.0, 1),
                       psi=(0.1 * (a @ a.T / d + np.eye(d)))[None],
                       nu=rng.uniform(20.0, 200.0, 1)),
        mus=rng.standard_normal((k, d)) * 2,
        kappas=1.0 + rng.uniform(10.0, 300.0, k), kappas0=np.ones(k))
    return jax.tree.map(jnp.asarray, src), state_from_numpy(src)


def _stats(rng, k=5, d=2, n=300, empty=None):
    """Gaussian statistics of n points under random (or, with `empty`,
    one-hot with that component empty) responsibilities: (JAX, port)."""
    x = rng.standard_normal((n, d)) * 2 + 1
    if empty is None:
        resp = rng.dirichlet(np.ones(k), n)
    else:
        labels = rng.integers(0, k - 1, n)
        labels[labels >= empty] += 1
        resp = np.eye(k)[labels]
    st = jniw.suff_stats(jnp.asarray(x), jnp.asarray(resp))
    return st, state_from_numpy(_np(st))


def _hier_prior(k=5, d=2):
    jp = jh.HierTied.standard(k, d, kappa=1.0, hyper_kappa=0.05,
                              psi_scale=0.5, dtype=jnp.float64)
    return jp, state_from_numpy(_np(jp))


# -- the algebra --------------------------------------------------------------

@pytest.mark.parametrize('fn', ['hyper_mstep', 'update', 'ell', 'kl',
                                'sample_shapes', 'mode', 'mean', 'studentt',
                                'gaussian'])
def test_hier_algebra_matches_jax_f64(fn):
    rng = np.random.default_rng(1)
    qj, qt = _posterior(rng)
    pj, pt = _hier_prior()
    sj, st = _stats(rng)
    x = rng.standard_normal((40, 2)) * 2
    xj, xt = jnp.asarray(x), torch.tensor(x)
    if fn == 'hyper_mstep':
        want = jh._hyper_mstep(pj, qj.mus, sj)
        got = th._hyper_mstep(pt, qt.mus, st)
    elif fn == 'update':
        want = jh.posterior_update(pj, sj, nb_iter=7)
        got = th.posterior_update(pt, st, nb_iter=7)
    elif fn == 'ell':
        want, got = (jh.expected_log_likelihood(qj, xj),
                     th.expected_log_likelihood(qt, xt))
    elif fn == 'kl':
        want, got = jh.kl_divergence(qj, pj), th.kl_divergence(qt, pt)
    elif fn == 'sample_shapes':
        want = jh.sample_params(jax.random.PRNGKey(0), qj)
        got = th.sample_params(torch.Generator().manual_seed(0), qt)
        for a, b in zip(got, want):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
        return
    elif fn == 'mode':
        want, got = jh.mode_params(qj), th.mode_params(qt)
    elif fn == 'mean':
        want, got = jh.mean_params(qj), th.mean_params(qt)
    elif fn == 'studentt':
        want, got = (jh.log_predictive_studentt(qj, xj),
                     th.log_predictive_studentt(qt, xt))
    else:
        want, got = (jh.log_predictive_gaussian(qj, xj),
                     th.log_predictive_gaussian(qt, xt))
    _tree(got, _np(want), rtol=1e-8, atol=1e-10)


def test_hier_family_matches_jax_f64():
    """hier_gaussian_family(nb_iter): update, ELL and predictives over a
    data tuple; the Gibbs hook is the exact draw."""
    import mimo_tpu.conjugate.families as jfam
    rng = np.random.default_rng(2)
    qj, qt = _posterior(rng)
    pj, pt = _hier_prior()
    sj, st = _stats(rng)
    fj, ft = jfam.hier_gaussian_family(nb_iter=5), tfam.hier_gaussian_family(5)
    x = rng.standard_normal((30, 2))
    dj, dt = (jnp.asarray(x),), (torch.tensor(x),)
    _tree(ft.update(pt, st), _np(fj.update(pj, sj)), 1e-8, 1e-10)
    for name in ('ell', 'log_predictive', 'log_predictive_gaussian'):
        _tree(getattr(ft, name)(qt, dt), _np(getattr(fj, name)(qj, dj)),
              1e-8, 1e-10)
    assert ft.gibbs_update is th.gibbs_update_exact


# -- the exact draw -----------------------------------------------------------

def test_exact_draw_posterior_and_empty_component_fault():
    """The exact one-shot draw forms xbar and the scatter with
    max(n_k, 1) instead of the reference's max(n_k, 1e-12) floor. On
    one-hot statistics with an empty component (x = 0 there) its
    posterior hyper-parameters equal the reference's in float64 at rtol
    1e-8; in float32, an empty component with x = 1e8 (and the xx^T of
    that point) makes the reference's psi NaN (1e20 squared is inf, times
    n = 0) and leaves the port's draw finite."""
    rng = np.random.default_rng(3)
    pj, pt = _hier_prior()
    sj, st = _stats(rng, empty=2)
    assert float(st.n1[2]) == 0.0 and float(st.x[2].abs().max()) == 0.0
    want, _ = jh.gibbs_update_exact(jax.random.PRNGKey(0), pj, sj)
    got, params = th.gibbs_update_exact(torch.Generator().manual_seed(0), pt,
                                        st)
    _tree(got.hyper, _np(want.hyper), rtol=1e-8, atol=1e-10)
    _tree(got.kappas, np.asarray(want.kappas), rtol=1e-12, atol=0.0)

    bad = np.array([1e8, -1e8], np.float32)
    s32 = jax.tree.map(lambda a: np.asarray(a, np.float32), _np(sj))
    s32 = s32._replace(x=s32.x.copy(), xxT=s32.xxT.copy())
    s32.x[2] = bad
    s32.xxT[2] = np.outer(bad, bad)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pj)
    ref, _ = jh.gibbs_update_exact(jax.random.PRNGKey(0), p32,
                                   jax.tree.map(jnp.asarray, s32))
    assert np.isnan(np.asarray(ref.hyper.psi)).any()
    post, params = th.gibbs_update_exact(
        torch.Generator().manual_seed(0), state_from_numpy(_np(p32)),
        state_from_numpy(s32))
    for leaf in jax.tree.leaves(state_to_numpy((post, params))):
        assert np.isfinite(leaf).all()


def test_exact_draw_moments():
    """Over 3000 draws from one conditional: the mean of Lambda is nu' psi'
    and the mean of tau-conditional means is the hyper mean, and each
    mu_k centres on its conditional mean, within 5 sigma of the draws'
    spread."""
    rng = np.random.default_rng(4)
    _, pt = _hier_prior(k=3)
    _, st = _stats(rng, k=3, n=60)
    gen = torch.Generator().manual_seed(5)
    draws = [th.gibbs_update_exact(gen, pt, st) for _ in range(3000)]
    post = draws[0][0]
    lam = torch.stack([p.lmbda[0] for _, p in draws])
    m_cond = torch.stack([q.mus for q, _ in draws])
    mus = torch.stack([p.mu for _, p in draws])

    def within(samples, want):
        se = samples.std(0) / np.sqrt(samples.shape[0])
        assert bool(((samples.mean(0) - want).abs() <= 5 * se + 1e-12).all())

    within(lam, post.hyper.nu[0] * post.hyper.psi[0])
    kap = pt.kappas0
    within(m_cond, (kap[:, None] * post.hyper.mu + st.x)
           / (kap + st.n1)[:, None])
    within(mus - m_cond, torch.zeros_like(post.mus))


# -- the spec and kernels B1, B2, B3 ------------------------------------------

@pytest.mark.parametrize('part', ['theta', 'theta_plugin', 'unpack', 'ell'])
def test_hier_spec_pieces_match_jax(part):
    rng = np.random.default_rng(6)
    qj, qt = _posterior(rng)
    js, ts = jfe.hier_gaussian_spec(), tfe.hier_gaussian_spec()
    if part == 'theta':
        got, want = ts.theta(qt), js.theta(qj)
    elif part == 'theta_plugin':
        got = ts.theta_plugin(th.mode_params(qt))
        want = js.theta_plugin(jh.mode_params(qj))
    elif part == 'unpack':
        acc = rng.standard_normal((5, tfe.gauss_width(2)))
        got, want = ts.unpack(torch.tensor(acc)), js.unpack(jnp.asarray(acc))
    else:   # features . theta is the HierTied expected log-likelihood
        x = rng.standard_normal((50, 2)) * 2
        got = ts.features((torch.tensor(x),)) @ ts.theta(qt).T
        want = jh.expected_log_likelihood(qj, jnp.asarray(x))
    _tree(got, _np(want), rtol=1e-10, atol=1e-12)
    # the spec reuses the Gauss map object, so B1/B2 run it as GAUSS
    assert ts.features_t is tfe.gauss_features_t
    assert cuda_estep.feature_kind(ts.features_t) == cuda_estep.GAUSS


@functools.lru_cache(maxsize=None)
def _gmm_problem():
    """tests/test_pallas.py:108-118's hierarchical problem: N=4096, K=8,
    d=2, DP gating, float32, and the JAX VI state after 3 sweeps."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2)).astype(jnp.float32)
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU, jnp.float32), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float32)
    jm = JaxGMM.make(size=8, dim=2, gating='dp', hierarchical=True,
                     kappa=0.05, psi_scale=0.5, dtype=jnp.float32)
    st, _ = jm.fit_vi_fused(x, key=1, maxiter=3, backend='xla')
    return jm, x, _np(st)


def test_hier_b1_plain_matches_pallas_interpret_masked_tail():
    """N=1000 over blocks of 384: the Pallas launcher pads and masks the
    tail; B1's plain version stops at n (the columns past it hold junk),
    at tests/test_pallas.py:128-133's tolerances."""
    _, x, st = _gmm_problem()
    n = 1000
    x = x[:n]
    post_j = jax.tree.map(jnp.asarray, st.components)
    log_pi = state_from_numpy(st).gating.expected_log_pi()
    xt_pad = jnp.pad(x.T, ((0, 0), (0, (-n) % 384)))
    want = fused_estep_pallas(jfe.hier_gaussian_spec(), post_j,
                              jnp.asarray(log_pi.numpy()), (xt_pad,), 384, n)
    padded = torch.cat([torch.tensor(np.asarray(x)).T,
                        torch.full((2, 24), 1e3)], 1)
    got = cuda_estep.fused_estep_cuda(tfe.hier_gaussian_spec(),
                                      state_from_numpy(st.components),
                                      log_pi, (padded,), n)
    _tree(got.stats, want.stats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


def test_hier_b2_plain_labels_and_stats_against_pallas():
    """B2 on the hierarchical plug-in theta (the shared mode precision):
    the Pallas sweep's statistics (interpret mode, masked tail, its own
    PRNG) are the one-hot sums its labels give through the port's map
    and unpack; the plain version's labels equal the blockwise engine's
    and follow the softmax over K."""
    _, x, st = _gmm_problem()
    n = 1000
    x = x[:n]
    params_j = jh.mode_params(jax.tree.map(jnp.asarray, st.components))
    log_pi = np.log(np.asarray(st.gating.gamma) / np.sum(st.gating.gamma))
    spec = tfe.hier_gaussian_spec()
    xt_pad = jnp.pad(x.T, ((0, 0), (0, (-n) % 384)))
    lab_j, res_j = fused_gibbs_pallas(jfe.hier_gaussian_spec(), 7, params_j,
                                      jnp.asarray(log_pi, jnp.float32),
                                      (xt_pad,), 384, n)
    xt = torch.tensor(np.asarray(x))
    feats = spec.features((xt,))
    oh = torch.nn.functional.one_hot(torch.tensor(np.asarray(lab_j)).long(),
                                     8).float()
    _tree(spec.unpack(oh.T @ feats), res_j.stats, rtol=1e-5, atol=1e-4)

    params_t = state_from_numpy(_np(params_j))
    seed = torch.tensor(123456789, dtype=torch.int64)
    lp = torch.tensor(log_pi, dtype=torch.float32)
    labels, res = cuda_gibbs.fused_gibbs_cuda(spec, seed, params_t, lp,
                                              (xt.T.contiguous(),), n)
    ref_labels, _ = tfe.fused_gibbs_blockwise(spec, seed, params_t, lp,
                                              (xt,), 256)
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    oh = torch.nn.functional.one_hot(labels.long(), 8).float()
    _tree(res.stats, state_to_numpy(spec.unpack(oh.T @ feats)), rtol=1e-6,
          atol=1e-4)
    probs = torch.softmax(feats.double() @ spec.theta_plugin(
        params_t).double().T + lp.double(), -1)
    expected = probs.sum(0).numpy()
    counts = np.bincount(labels.numpy(), minlength=8)
    assert np.all(np.abs(counts - expected)
                  <= 5 * np.sqrt(expected * (1 - expected / n)) + 5)


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_hier_b3_plain_matches_gauss_predictive_pallas(dist):
    """B3's plain version on HierTied rows (df = nu - d + 1 over K,
    precision df psi, no kappa factor) against gauss_predictive_pallas
    (interpret mode) on tests/test_pallas.py:536-551's problem, from the
    JAX state the bridge carried over, at rtol/atol 1e-4, whole and over
    a 1000-point tail."""
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((1024, 2)) * 2, jnp.float32)
    jm = JaxGMM.make(size=6, dim=2, hierarchical=True, kappa=0.5)
    st_j, _ = jm.fit_vi(x, key=3, maxiter=20)
    st_t = state_from_numpy(_np(st_j))
    assert isinstance(st_t.components, HierTied)
    tm = BayesianGMM.make(size=6, dim=2, hierarchical=True, kappa=0.5,
                          device='cpu')
    for m in (1024, 1000):
        want = gauss_predictive_pallas(st_j.components,
                                       jm.predictive_log_weights(st_j),
                                       x[:m], block_size=256, dist=dist)
        got = cuda_predict.gauss_predictive_cuda(
            st_t.components, tm.predictive_log_weights(st_t),
            torch.tensor(np.asarray(x[:m])), dist)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_hier_b3_coefficients_use_the_hyper_scale():
    """thq . [1, x, x (x) x] is the quad (x - mu_k)' df psi (x - mu_k)."""
    rng = np.random.default_rng(14)
    _, qt = _posterior(rng, k=4, d=3)
    thq, aux = cuda_predict.predictive_coefficients(
        qt, torch.zeros(4, dtype=torch.float64))
    mus, lmbdas, dfs = th.predictive_studentt_params(qt)
    assert torch.equal(dfs, (qt.hyper.nu - 2.0).expand(4))
    x = torch.tensor(rng.standard_normal((7, 3)))
    f = tfe.gauss_features_t((x.T,))
    dx = x[:, None, :] - mus[None]
    want = torch.einsum('nkd,kde,nke->nk', dx, lmbdas, dx)
    np.testing.assert_allclose((thq[:, :13] @ f).T.numpy(), want.numpy(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(aux[:, 2].numpy(), (1.0 / dfs).numpy())


# -- the hierarchical GMM, whole ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _vi_setup():
    """The data of _gmm_problem in float64 and a JAX state after 2 VI
    sweeps from random responsibilities."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float64)
    kw = dict(size=8, dim=2, gating='dp', alpha=1.0, hierarchical=True,
              kappa=0.05, psi_scale=0.5, maxsubiter=10)
    jm = JaxGMM.make(dtype=jnp.float64, **kw)
    init, _ = jm.fit_vi_fused(x, key=1, maxiter=2, backend='xla')
    return jm, BayesianGMM.make(dtype=torch.float64, **kw,
                                device='cpu'), x, init


@pytest.mark.parametrize('route', ['torch', 'kernel_plain'])
def test_hier_gmm_vi_fused_matches_jax_f64(monkeypatch, route):
    """Fused VI of the hierarchical GMM (10 inner rounds per sweep) from a
    shared JAX state: through the blockwise engine the ELBO trace and the
    posterior at rtol 1e-8; through B1's plain version (float32, as the
    kernel) the trace at rtol 1e-6 and the posterior at rtol 1e-4."""
    jm, tm, x, init = _vi_setup()
    st_j, v_j = jm.fit_vi_fused(x, maxiter=8, init_state=init,
                                randomize=False, backend='xla')
    tol = dict(trace=1e-8, state=1e-8, atol=1e-9)
    if route == 'kernel_plain':
        monkeypatch.setattr(tmix, 'resolve_backend', lambda backend, x: True)
        tol = dict(trace=1e-6, state=1e-4, atol=1e-5)
    st_t, v_t = tm.fit_vi_fused(torch.tensor(np.asarray(x)), maxiter=8,
                                init_state=state_from_numpy(_np(init)),
                                randomize=False, block_size=1000)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                               rtol=tol['trace'])
    _tree(st_t, _np(st_j), rtol=tol['state'], atol=tol['atol'])
    assert bool((torch.diff(v_t) > -1e-6).all())
    assert isinstance(st_t.components, HierTied)


def test_hier_gmm_log_predictive_matches_jax(monkeypatch):
    jm, tm, x, init = _vi_setup()
    st = state_from_numpy(_np(init))
    xt = torch.tensor(np.asarray(x))
    for dist in ('studentt', 'gaussian'):
        want = np.asarray(jm.log_predictive(init, x, dist=dist,
                                            backend='xla'))
        np.testing.assert_allclose(
            tm.log_predictive(st, xt, dist=dist).numpy(), want, rtol=1e-8)
    monkeypatch.setattr(tmix, 'resolve_backend', lambda backend, x: True)
    for dist in ('studentt', 'gaussian'):     # B3's plain version, float32
        want = np.asarray(jm.log_predictive(init, x, dist=dist,
                                            backend='xla'))
        np.testing.assert_allclose(
            tm.log_predictive(st, xt, dist=dist).numpy(), want, rtol=1e-4,
            atol=1e-4)


def test_hier_gmm_gibbs_fused_recovers_clusters():
    """tests/test_hierarchical.py::test_hier_gibbs_recovers (100 sweeps,
    a component with > 100 points within 0.4 of each true mean) on the
    fused engine and the port's own chain."""
    x = torch.tensor(np.asarray(_vi_setup()[2]), dtype=torch.float32)
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                          hierarchical=True, kappa=0.05, psi_scale=0.5,
                          device='cpu')
    gs = tm.fit_gibbs_fused(x, key=2, maxiter=100, block_size=1024)
    assert isinstance(gs, GibbsState) and isinstance(gs.components, HierTied)
    for leaf in jax.tree.leaves(state_to_numpy(gs[:4])):
        assert np.isfinite(leaf).all()
    counts = np.bincount(gs.labels.numpy(), minlength=8)
    mus = gs.components.mus.numpy()[counts > 100]
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(mus - t, axis=-1)) < 0.4, (mus, counts)


def test_hier_config_and_bridge():
    g = MixtureConfig(size=4, dim=3, hierarchical=True,
                      maxsubiter=3).build(torch.float64, device='cpu')
    assert isinstance(g.components_prior, HierTied)
    assert g.components_prior.hyper.psi.shape == (1, 3, 3)
    assert g.components_prior.kappas0.dtype == torch.float64
    with pytest.raises(ValueError, match='already precision-tied'):
        BayesianGMM(g.gating_prior, g.components_prior, tied=True)
    _, _, _, init = _vi_setup()
    src = _np(init)
    port = state_from_numpy(src)
    assert isinstance(port.components, HierTied)
    assert type(port.components.hyper).__name__ == 'NIW'
    _tree(port, src, rtol=0.0, atol=0.0)
    back = state_to_numpy(port)
    assert type(back.components).__name__ == 'HierTied'
    assert back.components.hyper.nu.shape == (1,)
