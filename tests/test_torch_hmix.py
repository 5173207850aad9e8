"""The port's nested mixtures of mixtures against mimo_tpu on the CPU, in
float64: construction and the bridge, dense VI from a shared two-level
start (JAX's random responsibilities handed to the port), the
expectations, the Gibbs sweep's deterministic pieces and its separation
of two super-clusters, the density and regression serving paths (dense,
and the plain path of B3's per-cluster rows) and the flagship recipe
(`TrainConfig` / `flagship_fit`)."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.config import TrainConfig as JaxTrainConfig
from mimo_tpu.config import flagship_fit as jax_flagship_fit
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.hmix import BayesianMixtureOfMixtures as JaxHMix
from mimo_tpu.utils import data as jdata
from mimo_tpu.utils.stats import sample_categorical_from_log as jcat

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import TrainConfig, flagship_fit
from mimo_tpu_torch.models import BayesianGMM, BayesianMixtureOfMixtures
from mimo_tpu_torch.models import hmix as thmix
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.ops import cuda_predict

torch.set_num_threads(1)

N_ILR = 600


@pytest.fixture(scope='module')
def nested_x():
    """Two super-clusters of two blobs each (tests/test_hierarchical.py's
    nested data): 1,000 points left, 1,000 right."""
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 500), blob([-5, -3], 500),
                   blob([5, 5], 500), blob([5, 3], 500)])
    return jnp.asarray(x[rng.permutation(2000)])


def ilr_data(p):
    """x ~ U(-2, 2), y = sin 3x (p = 1) or (sin x, cos x) (p = 2) plus
    0.1 noise."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (N_ILR, 1))
    y = (np.sin(3 * x) if p == 1
         else np.concatenate([np.sin(x), np.cos(x)], -1))
    return jnp.asarray(x), jnp.asarray(y + 0.1 * rng.standard_normal(y.shape))


def tt(a):
    return torch.from_numpy(np.array(a))


def conv(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree))


def leaves_close(got, want, rtol):
    """Every leaf of the port's tree against the JAX tree, rtol with an
    absolute floor of rtol x the leaf's largest magnitude."""
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def two_level_start(monkeypatch, jkey, n, m, k):
    """Hand JAX's two-level random responsibilities for `jkey` (fit_vi's
    and the fused engines': outer from jkey, inner from fold_in(jkey, 1))
    to the port."""
    r = jax.random.uniform(jkey, (n, m), dtype=jnp.float64, minval=1e-3,
                           maxval=1.0)
    ir = jax.random.uniform(jax.random.fold_in(jkey, 1), (m, n, k),
                            dtype=jnp.float64, minval=1e-3, maxval=1.0)
    outer = tt(r / jnp.sum(r, -1, keepdims=True))
    inner = tt(ir / jnp.sum(ir, -1, keepdims=True))
    monkeypatch.setattr(thmix, '_two_level_resp',
                        lambda *a: (outer.clone(), inner.clone()))


GMM_KW = dict(cluster_size=2, mixture_size=3, dim=2, kappa=0.5,
              psi_scale=0.5, maxsubiter=5, means=[[-5, -4], [5, 4]])
ILR_KW = dict(cluster_size=2, mixture_size=4, input_dim=1, kappa=0.05)


def make_pair(name, nested_x):
    """(JAX model, port model, JAX data, port data) for 'niw' (nested
    GMM), 'hier' (hierarchical nested GMM) and 'ilr' / 'ilr2' (nested
    ILR, p = 1 / 2, standardized)."""
    if name.startswith('ilr'):
        p = 2 if name == 'ilr2' else 1
        jm = JaxHMix.make_ilr(output_dim=p, dtype=jnp.float64, **ILR_KW)
        tm = BayesianMixtureOfMixtures.make_ilr(
            output_dim=p, dtype=torch.float64, device='cpu', **ILR_KW)
        x, y = ilr_data(p)
        jm.init_transform(x, y)
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (x, y), (tt(x), tt(y))
    kw = dict(GMM_KW, hierarchical=name == 'hier')
    jm = JaxHMix.make_gmm(dtype=jnp.float64, **kw)
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **kw)
    return jm, tm, nested_x, tt(nested_x)


@pytest.fixture(scope='module')
def jax_vi(nested_x):
    """name -> (JAX model, port model, JAX VI state, its trace, JAX data,
    port data): one JAX fit_vi (key 3, 4 sweeps of 2 inner rounds) per
    configuration, shared by the tests that need a fitted state."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, tm, dj, dt = make_pair(name, nested_x)
            st, tr = jm.fit_vi(dj, key=3, maxiter=4, maxsubiter=2)
            cache[name] = (jm, tm, st, tr, dj, dt)
        return cache[name]
    return get


# -- construction and the bridge ----------------------------------------------

@pytest.mark.parametrize('hierarchical', [False, True], ids=['niw', 'hier'])
def test_make_gmm_priors_match_jax(hierarchical):
    kw = dict(GMM_KW, hierarchical=hierarchical, alpha=2.0, inner_alpha=0.5)
    jm = JaxHMix.make_gmm(dtype=jnp.float64, **kw)
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **kw)
    assert (tm.cluster_size, tm.mixture_size) == (2, 3)
    for got, want in ((tm.outer_gating_prior, jm.outer_gating_prior),
                      (tm.inner_gating_prior, jm.inner_gating_prior),
                      (tm.components_prior, jm.components_prior)):
        assert type(got).__name__ == type(want).__name__
        leaves_close(got, want, 1e-15)
    plain = BayesianMixtureOfMixtures.make_gmm(
        2, 3, 2, hierarchical=hierarchical, dtype=torch.float64,
        device='cpu')
    leaves_close(plain.components_prior, JaxHMix.make_gmm(
        2, 3, 2, hierarchical=hierarchical,
        dtype=jnp.float64).components_prior, 1e-15)


def test_make_ilr_priors_match_jax():
    kw = dict(ILR_KW, output_dim=2, K_scale=0.1, psi_scale=2.0)
    jm = JaxHMix.make_ilr(dtype=jnp.float64, **kw)
    tm = BayesianMixtureOfMixtures.make_ilr(dtype=torch.float64,
                                            device='cpu', **kw)
    assert tm.kind == 'ilr' and tm.affine
    leaves_close(tm.components_prior, jm.components_prior, 1e-15)
    leaves_close(tm.inner_gating_prior, jm.inner_gating_prior, 1e-15)
    leaves_close(tm.outer_gating_prior, jm.outer_gating_prior, 1e-15)
    if not torch.cuda.is_available():   # built on the card by default
        with pytest.raises(RuntimeError):
            BayesianMixtureOfMixtures.make_ilr(2, 3, 1, 1)


def test_hmix_states_round_trip_the_bridge(jax_vi):
    jm, _, st, _, x, _ = jax_vi('niw')
    gs = jm.fit_gibbs(x, key=1, maxiter=2, maxsubiter=1)
    em, _ = jm.fit_em(x, key=2, maxiter=2, maxsubiter=1)
    for state, cls in ((st, thmix.HMixState), (gs, thmix.HMixGibbsState),
                       (em, thmix.HMixEMState)):
        got = conv(state)
        assert type(got) is cls
        leaves_close(got, state, 0.0)
        back = state_to_numpy(got)
        assert type(back) is cls and back._fields == state._fields


# -- dense VI and the expectations --------------------------------------------

@pytest.mark.parametrize('name', ['niw', 'hier', 'ilr'])
def test_dense_vi_matches_jax(monkeypatch, jax_vi, name):
    _, tm, st_j, tr_j, _, dt = jax_vi(name)
    n = dt[0].shape[0] if name == 'ilr' else dt.shape[0]
    two_level_start(monkeypatch, jax.random.PRNGKey(3), n, 2,
                    tm.mixture_size)
    st_t, tr_t = tm.fit_vi(dt, key=3, maxiter=4, maxsubiter=2)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)


@pytest.mark.parametrize('name', ['niw', 'hier', 'ilr'])
def test_expectations_match_jax(jax_vi, name):
    """expected_cluster_loglik and expected_responsibilities on a given
    (JAX-fitted) state, and the inner elc they sum."""
    jm, tm, st_j, _, dj, dt = jax_vi(name)
    st_t = conv(st_j)
    dj, dt = jm._tx_data(dj), tm._tx_data(dt)
    np.testing.assert_allclose(
        tm.expected_cluster_loglik(st_t, dt).numpy(),
        np.asarray(jm.expected_cluster_loglik(st_j, dj)), rtol=1e-10)
    np.testing.assert_allclose(
        tm.expected_responsibilities(st_t, dt).numpy(),
        np.asarray(jm.expected_responsibilities(st_j, dj)), rtol=1e-8,
        atol=1e-14)
    np.testing.assert_allclose(tm._inner_elc(st_t, dt).numpy(),
                               np.asarray(jm._inner_elc(st_j, dj)),
                               rtol=1e-10)


# -- Gibbs --------------------------------------------------------------------

@pytest.mark.parametrize('name', ['niw', 'hier', 'ilr'])
def test_gibbs_sweep_pieces_match_jax(jax_vi, name):
    """On given outer labels, sampled params, inner weights and inner
    labels (JAX's draws), the sweep's deterministic pieces: the (M, N, K)
    log-probs, the outer marginal, the weighted statistics and counts,
    and the inner posteriors."""
    jm, tm, st_j, _, dj, dt = jax_vi(name)
    dj, dt = jm._tx_data(dj), tm._tx_data(dt)
    n, m, k = dj[0].shape[0], 2, tm.mixture_size
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    labels = jax.random.randint(keys[0], (n,), 0, m)
    params = jax.vmap(jm.family.sample_params)(
        jax.random.split(keys[1], m), st_j.components)
    probs = jax.vmap(lambda g, kk: g.sample(kk))(
        st_j.inner_gating, jax.random.split(keys[2], m))
    logp_j = jax.vmap(lambda p, pr: jm.family.loglik(p, dj) + jnp.log(
        jnp.clip(pr, 1e-37, None))[None, :])(params, probs)
    z = jax.vmap(lambda lp, kk: jcat(kk, lp, axis=-1))(
        logp_j, jax.random.split(keys[3], m))
    outer_w = jdata.one_hot(labels, m, dtype=jnp.float64)
    wk = jax.vmap(lambda zz, w: jdata.one_hot(zz, k, dtype=jnp.float64)
                  * w[:, None])(z, outer_w.T)
    stats_j = jax.vmap(lambda w: jm.family.suff_stats(dj, w))(wk)
    post_j = jax.vmap(jm.family.update)(jm.components_prior, stats_j)

    logp_t = tm._gibbs_inner_logp(conv(params), tt(probs), dt)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j),
                               rtol=1e-10)
    np.testing.assert_allclose(
        torch.logsumexp(logp_t, -1).T.numpy(),
        np.asarray(jax.scipy.special.logsumexp(logp_j, axis=-1).T),
        rtol=1e-10)
    stats_t, counts_t = tm._gibbs_inner_stats(
        tt(z), tt(outer_w), dt)
    leaves_close(stats_t, stats_j, 1e-12)
    np.testing.assert_array_equal(counts_t.numpy(),
                                  np.asarray(jnp.sum(wk, 1)))
    post_t = torch.func.vmap(tm.family.update)(tm.components_prior, stats_t)
    leaves_close(post_t, post_j, 1e-10)


def test_fit_gibbs_separates_the_super_clusters(nested_x):
    """With per-cluster prior means, the dense nested Gibbs chain puts
    the two super-clusters on distinct outer labels, each holding at
    least 900 of its 1,000 points (tests/test_hierarchical.py's bar)."""
    tm = BayesianMixtureOfMixtures.make_gmm(
        dtype=torch.float64, device='cpu',
        **dict(GMM_KW, hierarchical=False))
    x = tt(nested_x)
    gs = tm.fit_gibbs(x, key=1, maxiter=30, maxsubiter=2)
    lab = gs.labels.numpy()
    assert gs.labels.dtype == torch.int32 and lab.shape == (2000,)
    left = x[:, 0].numpy() < 0
    l_major = Counter(lab[left].tolist()).most_common(1)[0]
    r_major = Counter(lab[~left].tolist()).most_common(1)[0]
    assert l_major[0] != r_major[0]
    assert l_major[1] >= 900 and r_major[1] >= 900
    g2 = tm.fit_gibbs(x, key=2, maxiter=2, init_labels='random')
    assert int(g2.labels.min()) >= 0 and int(g2.labels.max()) < 2


def test_hierarchical_fit_gibbs_runs(nested_x):
    """The dense chain of the hierarchical nested GMM: a finite state
    whose inner counts cover every point once. (Its outer labels need not
    split the super-clusters in 30 sweeps, in mimo_tpu either; the fused
    joint M*K draw does, tests/test_torch_hmix_engines.py.)"""
    tm = BayesianMixtureOfMixtures.make_gmm(
        dtype=torch.float64, device='cpu', **dict(GMM_KW, hierarchical=True))
    gs = tm.fit_gibbs(tt(nested_x), key=1, maxiter=10, maxsubiter=2)
    for leaf in jax.tree.leaves(state_to_numpy(gs)):
        assert np.isfinite(leaf).all()
    counts = gs.inner_gating.alpha - tm.inner_gating_prior.alpha
    assert float(counts.sum()) == 2000.0
    assert int(gs.labels.min()) >= 0 and int(gs.labels.max()) < 2


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
@pytest.mark.parametrize('name', ['niw', 'hier'])
def test_log_predictive_matches_jax(jax_vi, name, dist):
    jm, tm, st, _, dj, dt = jax_vi(name)
    want = np.asarray(jm.log_predictive(st, dj, dist=dist))
    got = tm.log_predictive(conv(st), dt, dist=dist)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    far = tm.log_predictive(conv(st), dt + 40.0, dist=dist)
    assert bool((far < got).all())


@pytest.mark.parametrize('name', ['niw', 'hier'])
def test_b3_rows_plain_path_equals_the_dense_density(jax_vi, name):
    """B3's M*K rows, built one cluster at a time (a HierTied cluster
    keeps its own shared scale), through B3's plain version in float64:
    the dense density to rtol 1e-10, both dists."""
    _, tm, st, _, _, dt = jax_vi(name)
    st_t = conv(st)
    xt = dt.T.contiguous()
    for dist in ('studentt', 'gaussian'):
        thq, aux = tm._predictive_rows(st_t, dist)
        assert thq.shape == (6, 8) and aux.shape == (6, 8)
        got = cuda_predict.predict_plain(xt, thq, aux, dt.shape[0],
                                         dist == 'studentt')
        np.testing.assert_allclose(
            got.numpy(), tm.log_predictive(st_t, dt, dist=dist,
                                           backend='torch').numpy(),
            rtol=1e-10)
    with pytest.raises(ValueError):
        tm.log_predictive(st_t, dt, backend='kernel')


@pytest.mark.parametrize('prediction', ['average', 'mode'])
@pytest.mark.parametrize('name', ['ilr', 'ilr2'], ids=['p1', 'p2'])
def test_predict_matches_jax(jax_vi, name, prediction):
    """The dense two-level predict in original units, with y (the NLPD
    with its Jacobian) and without, Student-t and Gaussian, and
    `incremental`."""
    jm, tm, st, _, (xj, yj), (xt, yt) = jax_vi(name)
    st_t = conv(st)
    for dist in ('studentt', 'gaussian'):
        want = jm.predict(st, xj, yj, prediction=prediction, dist=dist,
                          backend='xla')
        got = tm.predict(st_t, xt, yt, prediction=prediction, dist=dist)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                       atol=1e-12)
    want = jm.predict(st, xj, incremental=True, prediction=prediction,
                      backend='xla')
    got = tm.predict(st_t, xt, incremental=True, prediction=prediction)
    assert got[3] is None and want[3] is None
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-12)


def test_predictive_weights_sum_to_one(jax_vi):
    jm, tm, st, _, (xj, _), (xt, _) = jax_vi('ilr')
    st_t = conv(st)
    for dist in ('gaussian', 'studentt'):
        w = tm.predictive_weights(st_t, tm._tx(xt), dist)
        assert w.shape == (N_ILR, 2, 4)
        np.testing.assert_allclose(w.sum((1, 2)).numpy(), 1.0, rtol=1e-12)
        np.testing.assert_allclose(
            w.numpy(), np.asarray(jm.predictive_weights(
                st, jm.input_transform.transform(xj), dist)), rtol=1e-8,
            atol=1e-14)
    np.testing.assert_allclose(
        tm.predictive_activation(st_t, xt).numpy(),
        np.asarray(jm.predictive_activation(st, xj)), rtol=1e-8, atol=1e-14)
    tg = BayesianMixtureOfMixtures.make_gmm(2, 3, 2, dtype=torch.float64,
                                            device='cpu')
    with pytest.raises(ValueError):     # predict is for make_ilr models
        tg.predict(None, torch.zeros((4, 2), dtype=torch.float64))


# -- the flagship recipe ------------------------------------------------------

def flat_batches(key, n, batch_size, maxiter):
    """The batch indices the JAX package's flat fit_svi draws for `key`."""
    _, k_loop = jax.random.split(jax.random.PRNGKey(key))
    return [tt(jdata.sample_batch_indices(jax.random.split(k)[0], n,
                                          batch_size))
            for k in jax.random.split(k_loop, maxiter)]


@pytest.mark.parametrize('engine', ['vi', 'svi+vi'])
def test_flagship_fit_matches_jax(monkeypatch, nested_x, engine):
    """TrainConfig's fields and defaults, and flagship_fit from the same
    Gibbs state (JAX's, handed to both models' fit_gibbs), with JAX's
    SVI batch indices: the final state and the re-anchored priors."""
    assert TrainConfig() == TrainConfig(**vars(JaxTrainConfig()))
    kw = dict(size=4, gating='dp', kappa=0.05, psi_scale=0.5)
    jm = JaxGMM.make(dim=2, dtype=jnp.float64, **kw)
    tm = BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw)
    x = nested_x
    g_j = jm.fit_gibbs(x, key=7, maxiter=5, init_labels='random')
    jm.fit_gibbs = lambda *a, **k: g_j
    tm.fit_gibbs = lambda *a, **k: conv(g_j)
    cfg = dict(super_iters=2, gibbs_iters=5, vi_iters=4, svi_iters=3,
               svi_batch_size=64, seed=11, engine=engine, tol=1e-9)
    batches = iter([b for it in range(2)
                    for b in flat_batches(11 + it + 1, 2000, 64, 3)])
    monkeypatch.setattr(tmix, 'sample_batch_indices',
                        lambda *a, **k: next(batches))
    jm2, st_j = jax_flagship_fit(jm, x, JaxTrainConfig(**cfg))
    tm2, st_t = flagship_fit(tm, tt(x), TrainConfig(**cfg))
    leaves_close(st_t, st_j, 1e-8)
    leaves_close(tm2.components_prior, jm2.components_prior, 1e-8)
    leaves_close(tm2.gating_prior, jm2.gating_prior, 1e-8)


def test_flagship_fit_rejects_an_unknown_engine(nested_x):
    tm = BayesianGMM.make(size=3, dim=2, dtype=torch.float64, device='cpu')
    jm = JaxGMM.make(size=3, dim=2, dtype=jnp.float64)
    msgs = []
    for fit, model, cfg in ((flagship_fit, tm, TrainConfig),
                            (jax_flagship_fit, jm, JaxTrainConfig)):
        with pytest.raises(ValueError) as err:
            fit(model, None, cfg(engine='svi+gibbs'))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
