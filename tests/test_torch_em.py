"""The port's maximum-likelihood updates and its MAP / ML-EM engines
against mimo_tpu on the CPU, in float64: every family's `ml_update` on
the same statistics, `fit_map_fused` / `fit_em_fused` (the plug-in E-step
that runs kernel B1 on CUDA data) and the dense `fit_map` / `fit_em` /
`GMM.fit_em` from a shared start (the JAX run's initial responsibilities
or anchors handed to the port), and NG's float32 update on a tight cell."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.conjugate import families as jfam
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import GMM as JaxGMM
from mimo_tpu.models.gmm import BayesianGMM as JaxBGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.conjugate import families as tfam
from mimo_tpu_torch.distributions import ng as tng
from mimo_tpu_torch.models import BayesianGMM, BayesianILR, GMM
from mimo_tpu_torch.models import gmm as tgmm
from mimo_tpu_torch.models import mixture as tmix

torch.set_num_threads(1)

TRUE_MU = np.array([[-4., 0.], [4., 0.], [0., 5.]])
N = 1500


@pytest.fixture(scope='module')
def gmm_x():
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxBGMM.generate(jax.random.PRNGKey(7),
                            JParams(jnp.asarray(TRUE_MU), lm),
                            jnp.asarray([.3, .4, .3]), N)
    return x.astype(jnp.float64)


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (N, 1))
    y = np.sin(x) + 0.1 * rng.standard_normal((N, 1))
    return jnp.asarray(x), jnp.asarray(y)


def tt(a):
    return torch.from_numpy(np.array(a))


def leaves_close(got, want, rtol):
    """Every leaf of the port's tree against the JAX tree, rtol with an
    absolute floor of rtol x the leaf's largest magnitude."""
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def shared_start(monkeypatch, key, n, k):
    """Hand JAX's random responsibilities and anchors for `key` to the
    port's engines (their random streams cannot match JAX's)."""
    jkey = jax.random.PRNGKey(key)
    resp = tt(jmix._random_resp(jkey, n, k, jnp.float64))
    idx = tt(jax.random.choice(jkey, n, (k,), replace=False))
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: resp.clone())
    monkeypatch.setattr(tgmm, '_random_resp', lambda *a: resp.clone())
    monkeypatch.setattr(tmix, '_anchor_indices', lambda *a: idx.clone())


# -- the ML updates -----------------------------------------------------------

def _stats(fam_j, data, k, seed=0):
    """JAX statistics under random responsibilities with one empty
    component (its ML params take the dead-component branch)."""
    r = np.random.default_rng(seed).uniform(0.05, 1.0, (data[0].shape[0], k))
    r[:, -1] = 0.0
    r /= r.sum(-1, keepdims=True)
    return fam_j.suff_stats(data, jnp.asarray(r))


BASES = {
    'niw': (jfam.gaussian_family, tfam.gaussian_family, 'x'),
    'ng': (jfam.diag_gaussian_family, tfam.diag_gaussian_family, 'x'),
    'mnw': (jfam.linear_family, tfam.linear_family, 'xy'),
    'mng': (jfam.diag_linear_family, tfam.diag_linear_family, 'xy'),
}


@pytest.mark.parametrize('tied', [False, True], ids=['base', 'tied'])
@pytest.mark.parametrize('name', list(BASES))
def test_ml_update_matches_jax(gmm_x, ilr_xy, name, tied):
    make_j, make_t, kind = BASES[name]
    fj, ft = make_j(), make_t()
    if tied:
        fj, ft = jfam.tied_family(fj), tfam.tied_family(ft)
    data = (gmm_x,) if kind == 'x' else ilr_xy
    stats = _stats(fj, data, 5)
    want = fj.ml_update(stats)
    got = ft.ml_update(state_from_numpy(jax.tree.map(np.asarray, stats)))
    assert type(got).__name__ == type(want).__name__
    leaves_close(got, want, 1e-8)


def test_product_ml_update_matches_jax(ilr_xy):
    fj, ft = jfam.ilr_family(), tfam.ilr_family()
    stats = _stats(fj, ilr_xy, 4, seed=1)
    leaves_close(ft.ml_update(state_from_numpy(
        jax.tree.map(np.asarray, stats))), fj.ml_update(stats), 1e-8)


def test_hierarchical_families_have_no_ml_update(gmm_x):
    assert tfam.hier_gaussian_family().ml_update is None
    assert jfam.hier_gaussian_family().ml_update is None
    assert tfam.ilr_family(hier_basis=True).ml_update is None
    assert tfam.ilr_family(tied_affine=True).ml_update is None
    m = BayesianGMM.make(size=3, dim=2, hierarchical=True,
                         dtype=torch.float64, device='cpu')
    x = tt(gmm_x)
    for engine in (m.fit_em, m.fit_em_fused):
        with pytest.raises(NotImplementedError):
            engine(x, key=0, maxiter=5)


# -- fused MAP and ML-EM against JAX ------------------------------------------

CONFIGS = {
    'dpgmm': dict(size=4, gating='dp', kappa=0.05, psi_scale=0.5),
    'diag': dict(size=4, gating='dirichlet', diag=True, kappa=0.05),
    'tied': dict(size=4, gating='dp', tied=True, kappa=0.05, psi_scale=0.5),
    'ilr': dict(size=6, alpha=2.0, kappa=0.05),
    'ilr-mng': dict(size=6, alpha=2.0, kappa=0.05, diag=True),
}


def make_pair(name, gmm_x, ilr_xy):
    kw = dict(CONFIGS[name])
    if name.startswith('ilr'):
        jm = JaxILR.make(input_dim=1, output_dim=1, dtype=jnp.float64, **kw)
        tm = BayesianILR.make(input_dim=1, output_dim=1, dtype=torch.float64,
                              device='cpu', **kw)
        x, y = ilr_xy
        jm.init_transform(x, y)
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (x, y), (tt(x), tt(y))
    jm = JaxBGMM.make(dim=2, dtype=jnp.float64, **kw)
    tm = BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw)
    return jm, tm, gmm_x, tt(gmm_x)


@pytest.mark.parametrize('engine', ['fit_map_fused', 'fit_em_fused'])
@pytest.mark.parametrize('name', list(CONFIGS))
def test_fused_plugin_engines_match_jax(monkeypatch, gmm_x, ilr_xy, name,
                                        engine):
    jm, tm, dj, dt = make_pair(name, gmm_x, ilr_xy)
    shared_start(monkeypatch, 1, N, tm.size)
    st_j, ll_j = getattr(jm, engine)(dj, key=1, maxiter=5, backend='xla',
                                     block_size=500)
    st_t, ll_t = getattr(tm, engine)(dt, key=1, maxiter=5, block_size=500)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)


@pytest.mark.parametrize('name', ['dpgmm', 'ilr'])
def test_fused_plugin_engines_match_the_dense_ones(gmm_x, ilr_xy, name):
    """The port's fused MAP / EM reproduce its own dense fit_map / fit_em
    (same init, same updates; the E-step only streams through blocks).
    BayesianILR's dense fit_map fits the data it is given, as mimo_tpu's
    does, so it is handed the standardized data its fused engine fits."""
    _, tm, _, dt = make_pair(name, gmm_x, ilr_xy)
    st_d, ll_d = tm.fit_em(dt, key=0, maxiter=20)
    st_f, ll_f = tm.fit_em_fused(dt, key=0, maxiter=20, block_size=400)
    np.testing.assert_allclose(ll_f.numpy(), ll_d.numpy(), rtol=1e-9)
    st_d, ll_d = tm.fit_map(tm._std(dt) if name == 'ilr' else dt, key=1,
                            maxiter=20)
    st_f, ll_f = tm.fit_map_fused(dt, key=1, maxiter=20, block_size=400)
    np.testing.assert_allclose(ll_f.numpy(), ll_d.numpy(), rtol=1e-9)
    mu_d = st_d.components[0].mu if name == 'ilr' else st_d.components.mu
    mu_f = st_f.components[0].mu if name == 'ilr' else st_f.components.mu
    np.testing.assert_allclose(mu_f.numpy(), mu_d.numpy(), rtol=1e-7)


def test_fused_engines_need_a_plugin_spec(gmm_x):
    m = BayesianGMM.make(size=3, dim=2, dtype=torch.float64, device='cpu')
    m._estep_spec = lambda: None
    for engine in (m.fit_map_fused, m.fit_em_fused):
        with pytest.raises(NotImplementedError):
            engine(tt(gmm_x), maxiter=2)
    with pytest.raises(ValueError):
        BayesianGMM.make(size=3, dim=2, device='cpu').fit_map_fused(
            tt(gmm_x).float(), maxiter=2, backend='kernel')


# -- dense MAP and EM against JAX ---------------------------------------------

@pytest.mark.parametrize('engine', ['fit_map', 'fit_em'])
@pytest.mark.parametrize('name', ['dpgmm', 'tied', 'ilr'])
def test_dense_plugin_engines_match_jax(monkeypatch, gmm_x, ilr_xy, name,
                                        engine):
    jm, tm, dj, dt = make_pair(name, gmm_x, ilr_xy)
    shared_start(monkeypatch, 2, N, tm.size)
    st_j, ll_j = getattr(jm, engine)(dj, key=2, maxiter=8)
    st_t, ll_t = getattr(tm, engine)(dt, key=2, maxiter=8)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)


def test_ml_gmm_fit_em_matches_jax(monkeypatch, gmm_x):
    shared_start(monkeypatch, 0, N, 3)
    st_j, ll_j = JaxGMM(3, 2).fit_em(gmm_x, key=0, maxiter=15)
    g = GMM(3, 2)
    x = tt(gmm_x)
    st_t, ll_t = g.fit_em(x, key=0, maxiter=15)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)
    jg = JaxGMM(3, 2)
    np.testing.assert_allclose(
        g.log_likelihood(st_t, x).numpy(),
        np.asarray(jg.log_likelihood(st_j, gmm_x)), rtol=1e-8)
    np.testing.assert_allclose(
        g.responsibilities(st_t, x).numpy(),
        np.asarray(jg.responsibilities(st_j, gmm_x)), rtol=1e-7, atol=1e-12)
    xs, lab = g.sample(st_t, key=3, n=4000)
    assert xs.shape == (4000, 2) and lab.shape == (4000,)
    assert bool(torch.isfinite(xs).all())


def test_em_recovers_the_clusters_in_float32(gmm_x):
    """The fused EM from the port's own anchors (float32, the plain
    version of B1's path) recovers the generating means."""
    m = BayesianGMM.make(size=3, dim=2, device='cpu')
    st, ll = m.fit_em_fused(tt(gmm_x).float(), key=0, maxiter=60,
                            block_size=512)
    assert bool(torch.isfinite(ll).all())
    d = np.diff(ll.double().numpy())
    assert d.min() > -1e-4 * abs(float(ll[-1]))
    est = st.params.mu.numpy()
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.3


# -- NG on a tight cell (ROADMAP §C) ---------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ng_update_and_ml_variance_stay_positive_on_a_tight_cell(seed):
    """NG's uncentred beta (s2 + kappa m^2 - kappa' m'^2) and the ML
    variance s2/n - mu^2 in float32 at mu = 1e3, sigma = 1e-2, N = 10,000,
    against float64. Both stay positive: the prior-mean term
    kappa n / kappa' (xbar - m)^2 / 2 ~ 2.5e4 is most of beta, and the
    variance's clamp keeps it >= 1e-8. Neither is accurate in float32:
    sigma^2 / mu^2 = 1e-10 is below f32's resolution of the statistic s2
    (~1e10), whatever form the update takes on these statistics."""
    rng = np.random.default_rng(seed)
    x64 = torch.from_numpy(1e3 + 1e-2 * rng.standard_normal((10_000, 2)))
    out = {}
    for dt in (torch.float64, torch.float32):
        x = x64.to(dt)
        stats = tng.suff_stats(x, torch.ones((x.shape[0], 1), dtype=dt))
        prior = tng.NG.standard(1, 2, kappa=0.05, dtype=dt)
        out[dt] = (tng.posterior_update(prior, stats).beta,
                   1.0 / tng.ml_params(stats).lmbda_diag)
    beta32, var32 = out[torch.float32]
    beta64, var64 = out[torch.float64]
    assert bool((beta32 > 0).all()) and bool((var32 > 0).all())
    assert bool(torch.isfinite(beta32).all() & torch.isfinite(var32).all())
    # the float64 reference: beta ~ 1 + 0.5 (N sigma^2 + 2.5e4 x 2), the
    # ML variance sigma^2
    np.testing.assert_allclose(beta64.numpy(), 25001.4, rtol=1e-4)
    np.testing.assert_allclose(var64.numpy(), 1e-4, rtol=0.05)
