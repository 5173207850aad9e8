"""The port's nested engines against mimo_tpu on the CPU, in float64, from
a shared start (JAX's two-level random responsibilities, anchors or batch
indices handed to the port): the fused VI / MAP / ML-EM over the flat M*K
expert axis (the plain twin of kernel B1's path), the dense ML-EM and MAP
with the ML scoring functions, one SVI step, a long SVI run, and the
fused Gibbs sweep (the plain twin of kernel B2's path) separating two
super-clusters, with the exact draws on the hierarchical model."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.models.hmix import BayesianMixtureOfMixtures as JaxHMix
from mimo_tpu.utils import data as jdata

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import BayesianMixtureOfMixtures
from mimo_tpu_torch.models import hmix as thmix

torch.set_num_threads(1)

N, N_ILR = 2000, 600


@pytest.fixture(scope='module')
def nested_x():
    """Two super-clusters of two blobs each (tests/test_hierarchical.py's
    nested data)."""
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 500), blob([-5, -3], 500),
                   blob([5, 5], 500), blob([5, 3], 500)])
    return jnp.asarray(x[rng.permutation(N)])


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (N_ILR, 1))
    y = np.sin(3 * x) + 0.1 * rng.standard_normal((N_ILR, 1))
    return jnp.asarray(x), jnp.asarray(y)


def tt(a):
    return torch.from_numpy(np.array(a))


def conv(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree))


def leaves_close(got, want, rtol):
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def uniform_resp(key, shape):
    r = jax.random.uniform(key, shape, dtype=jnp.float64, minval=1e-3,
                           maxval=1.0)
    return tt(r / jnp.sum(r, -1, keepdims=True))


def patch_start(monkeypatch, k_outer, k_inner, n, m, k):
    """Hand JAX's two-level random responsibilities (outer from k_outer,
    inner from k_inner) to the port."""
    outer = uniform_resp(k_outer, (n, m))
    inner = uniform_resp(k_inner, (m, n, k))
    monkeypatch.setattr(thmix, '_two_level_resp',
                        lambda *a: (outer.clone(), inner.clone()))


def patch_anchors(monkeypatch, key, n, m, k):
    """Hand JAX's anchors for `key` to the port: (M, K) for the dense
    engines, (M*K,) for fit_em_fused."""
    jkey = jax.random.PRNGKey(key)
    idx = {(m, k): tt(jax.random.choice(jkey, n, (m, k), replace=False)),
           (m * k,): tt(jax.random.choice(jkey, n, (m * k,),
                                          replace=False))}
    monkeypatch.setattr(thmix, '_anchor_indices',
                        lambda gen, n, shape, device: idx[shape].clone())


GMM_KW = dict(cluster_size=2, mixture_size=3, dim=2, kappa=0.5,
              psi_scale=0.5, maxsubiter=5, means=[[-5, -4], [5, 4]])


def make_pair(name, nested_x, ilr_xy):
    if name == 'ilr':
        kw = dict(cluster_size=2, mixture_size=4, input_dim=1, output_dim=1,
                  kappa=0.05)
        jm = JaxHMix.make_ilr(dtype=jnp.float64, **kw)
        tm = BayesianMixtureOfMixtures.make_ilr(dtype=torch.float64,
                                                device='cpu', **kw)
        x, y = ilr_xy
        jm.init_transform(x, y)
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (x, y), (tt(x), tt(y)), N_ILR
    kw = dict(GMM_KW, hierarchical=name == 'hier')
    jm = JaxHMix.make_gmm(dtype=jnp.float64, **kw)
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **kw)
    return jm, tm, nested_x, tt(nested_x), N


# -- the fused engines over the flat M*K axis ---------------------------------

FUSED = [('fit_vi_fused', 'niw'), ('fit_vi_fused', 'hier'),
         ('fit_vi_fused', 'ilr'), ('fit_map_fused', 'niw'),
         ('fit_map_fused', 'hier'), ('fit_map_fused', 'ilr'),
         ('fit_em_fused', 'niw'), ('fit_em_fused', 'ilr')]


@pytest.mark.parametrize('engine,name', FUSED)
def test_fused_engines_match_jax(monkeypatch, nested_x, ilr_xy, engine,
                                 name):
    """5 sweeps from the shared start: the trace (the nested ELBO, or the
    data log-likelihood at each sweep's plug-in params) and the final
    state."""
    jm, tm, dj, dt, n = make_pair(name, nested_x, ilr_xy)
    jkey = jax.random.PRNGKey(1)
    patch_start(monkeypatch, jkey, jax.random.fold_in(jkey, 1), n, 2,
                tm.mixture_size)
    patch_anchors(monkeypatch, 1, n, 2, tm.mixture_size)
    st_j, tr_j = getattr(jm, engine)(dj, key=1, maxiter=5, backend='xla',
                                     block_size=n // 4)
    st_t, tr_t = getattr(tm, engine)(dt, key=1, maxiter=5,
                                     block_size=n // 4)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)


def test_fused_vi_stops_on_tol_and_matches_dense_vi(nested_x):
    """fit_vi_fused's `tol` stops early and constant-extends the trace;
    from one start it equals dense fit_vi at maxsubiter=1 (the same
    posteriors: the flat softmax factors into outer x inner)."""
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **GMM_KW)
    x = tt(nested_x)
    st_f, tr = tm.fit_vi_fused(x, key=2, maxiter=40, tol=5e-3,
                               block_size=500)
    stop = int(torch.nonzero(tr == tr[-1])[0])
    assert stop < 39 and bool((tr[stop:] == tr[-1]).all())
    assert float(torch.diff(tr).min()) > -1e-8 * abs(float(tr[-1]))
    st_d, _ = tm.fit_vi(x, key=2, maxiter=stop + 1, maxsubiter=1)
    leaves_close(st_f, state_to_numpy(st_d), 1e-6)


def test_ml_engines_refuse_hierarchical_models(nested_x):
    kw = dict(GMM_KW, hierarchical=True)
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **kw)
    jm = JaxHMix.make_gmm(dtype=jnp.float64, **kw)
    for m, x in ((tm, tt(nested_x)), (jm, nested_x)):
        for engine in (m.fit_em, m.fit_em_fused):
            with pytest.raises(NotImplementedError):
                engine(x, key=0, maxiter=2)
    with pytest.raises(ValueError):
        tm.fit_vi_fused(tt(nested_x), maxiter=1, backend='kernel')


# -- dense ML-EM and MAP ------------------------------------------------------

@pytest.mark.parametrize('engine', ['fit_em', 'fit_map'])
@pytest.mark.parametrize('name', ['niw', 'ilr'])
def test_dense_plugin_engines_match_jax(monkeypatch, nested_x, ilr_xy, name,
                                        engine):
    """From JAX's anchors: the trace and the final state; after fit_em,
    log_likelihood, responsibilities and cluster_log_likelihood."""
    jm, tm, dj, dt, n = make_pair(name, nested_x, ilr_xy)
    patch_anchors(monkeypatch, 2, n, 2, tm.mixture_size)
    st_j, tr_j = getattr(jm, engine)(dj, key=2, maxiter=4, maxsubiter=2)
    st_t, tr_t = getattr(tm, engine)(dt, key=2, maxiter=4, maxsubiter=2)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)
    if engine == 'fit_em':
        for fn, rtol, atol in (('log_likelihood', 1e-9, 0.0),
                               ('cluster_log_likelihood', 1e-9, 0.0),
                               ('responsibilities', 1e-7, 1e-12)):
            np.testing.assert_allclose(
                getattr(tm, fn)(st_t, dt).numpy(),
                np.asarray(getattr(jm, fn)(st_j, dj)), rtol=rtol, atol=atol)


# -- SVI ----------------------------------------------------------------------

def nested_batches(key, n, batch_size, maxiter, warm=False):
    """JAX's fit_svi for `key`: (k1, k2) for the two-level start (None
    for a warm start, which draws none) and the batch indices of each
    step."""
    k1 = k2 = None
    k_loop = jax.random.PRNGKey(key)
    if not warm:
        k1, k2, k_loop = jax.random.split(k_loop, 3)
    return k1, k2, [tt(jdata.sample_batch_indices(
        jax.random.fold_in(k, 0), n, batch_size))
        for k in jax.random.split(k_loop, maxiter)]


@pytest.mark.parametrize('name', ['niw', 'ilr'])
def test_fit_svi_step_matches_jax(monkeypatch, nested_x, ilr_xy, name):
    """One step from the random start and two warm-started steps, with
    JAX's start and batch indices."""
    jm, tm, dj, dt, n = make_pair(name, nested_x, ilr_xy)
    k1, k2, idx = nested_batches(4, n, 64, 1)
    patch_start(monkeypatch, k1, k2, n, 2, tm.mixture_size)
    batches = iter(idx)
    monkeypatch.setattr(thmix, 'sample_batch_indices',
                        lambda *a, **k: next(batches))
    kw = dict(maxiter=1, step_size=0.4, batch_size=64, maxsubiter=2)
    st_j = jm.fit_svi(dj, key=4, **kw)
    st_t = tm.fit_svi(dt, key=4, **kw)
    leaves_close(st_t, st_j, 1e-8)
    _, _, idx = nested_batches(5, n, 64, 2, warm=True)
    batches = iter(idx)
    kw.update(maxiter=2)
    warm_j = jm.fit_svi(dj, key=5, init_state=st_j, randomize=False, **kw)
    warm_t = tm.fit_svi(dt, key=5, init_state=conv(st_j), randomize=False,
                        **kw)
    leaves_close(warm_t, warm_j, 1e-8)


def test_fit_svi_runs_100_steps(nested_x):
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **GMM_KW)
    st = tm.fit_svi(tt(nested_x), key=0, maxiter=100, step_size=0.5,
                    batch_size=128)
    for leaf in jax.tree.leaves(state_to_numpy(st)):
        assert np.isfinite(leaf).all()
    w = st.outer_gating.mean().numpy()
    assert w.min() > 0.3, w


# -- fused Gibbs --------------------------------------------------------------

@pytest.mark.parametrize('hierarchical', [False, True], ids=['niw', 'hier'])
def test_fit_gibbs_fused_separates_the_super_clusters(nested_x,
                                                      hierarchical):
    """The joint M*K label draw (kernel B2's plain twin) puts the two
    super-clusters on distinct outer labels, each holding at least 900 of
    its 1,000 points; the hierarchical model runs the exact draws (its
    family's gibbs_update), the NIW one the posterior draws."""
    tm = BayesianMixtureOfMixtures.make_gmm(
        dtype=torch.float64, device='cpu',
        **dict(GMM_KW, hierarchical=hierarchical))
    assert (tm.family.gibbs_update is not None) == hierarchical
    x = tt(nested_x)
    gs = tm.fit_gibbs_fused(x, key=1, maxiter=30, block_size=500)
    lab = gs.labels.numpy()
    assert gs.labels.dtype == torch.int32 and lab.shape == (N,)
    for leaf in jax.tree.leaves(state_to_numpy(gs)):
        assert np.isfinite(leaf).all()
    left = x[:, 0].numpy() < 0
    l_major = Counter(lab[left].tolist()).most_common(1)[0]
    r_major = Counter(lab[~left].tolist()).most_common(1)[0]
    assert l_major[0] != r_major[0]
    assert l_major[1] >= 900 and r_major[1] >= 900
    again = tm.fit_gibbs_fused(x, key=1, maxiter=30, block_size=250)
    assert torch.equal(again.labels, gs.labels)
