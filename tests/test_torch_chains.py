"""Multi-chain inference in the port (mimo_tpu_torch/parallel/chains.py and
the chained engines of models/mixture.py) on the CPU, in float64, where
kernels B1/B2 run their plain versions:

  * the plain versions of B1/B2 and the blockwise fused sweeps with a
    chain axis against C separate calls (Gauss, diagonal and ILR maps);
  * the chained fused VI / MAP / ML-EM engines against mimo_tpu's fits
    from the same C starts (rtol 1e-8), and against the port's own
    single-chain fits with the same keys (rtol 1e-10), `tol` included;
  * fused and dense Gibbs chains (finite, distinct, JAX's shapes), the
    dense engines through fit_chains, best_of and systematic resampling
    against JAX, smc_gibbs, finite_report's chain, and the fixed-state
    two-sample check on B2's plain twin;
  * chains of nested mixtures: the fused engines' chains against the
    port's nested fits with the same keys (rtol 1e-10), mimo_tpu's
    fit_chains structure, and smc_gibbs' refusal of nested models."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.parallel import chains as jchains

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.models.mixture import MFState, stack_trees
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.ops import precision
from mimo_tpu_torch.ops.cuda_estep import (
    DIAG, GAUSS, ILR, kernel_xts, pad_theta)
from mimo_tpu_torch.parallel import (
    best_of, fit_chains, smc_gibbs, systematic_indices, systematic_resample)
from mimo_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

N, N_ILR = 1500, 800
KEYS = (3, 7, 11)


def tt(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def gmm_x():
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(7),
                           JParams(jnp.asarray([[-4., 0.], [4., 0.],
                                                [0., 5.]]), lm),
                           jnp.asarray([.3, .4, .3]), N)
    return x.astype(jnp.float64)


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(3)
    x = rng.uniform(-6, 6, (N_ILR, 1))
    y = np.sin(x) + 0.1 * rng.standard_normal((N_ILR, 1))
    return jnp.asarray(x), jnp.asarray(y)


CONFIGS = {
    'dpgmm': dict(size=5, gating='dp', kappa=0.05, psi_scale=0.5),
    'diag': dict(size=5, gating='dirichlet', diag=True, kappa=0.05),
    'ilr': dict(size=6, alpha=2.0, kappa=0.05),
}


def make_pair(name, gmm_x, ilr_xy):
    """(JAX model, port model, JAX data, port data), float64."""
    kw = dict(CONFIGS[name])
    if name == 'ilr':
        jm = JaxILR.make(input_dim=1, output_dim=1, dtype=jnp.float64, **kw)
        tm = BayesianILR.make(input_dim=1, output_dim=1, dtype=torch.float64,
                              device='cpu', **kw)
        x, y = ilr_xy
        jm.init_transform(x, y)
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (x, y), (tt(x), tt(y))
    jm = JaxGMM.make(dim=2, dtype=jnp.float64, **kw)
    tm = BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw)
    return jm, tm, gmm_x, tt(gmm_x)


def leaves_close(got, want, rtol):
    """Every leaf of the port's tree against the JAX tree, rtol with an
    absolute floor of rtol x the leaf's largest magnitude."""
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def chain(tree, c):
    return tree_map(lambda a: a[c], tree)


# -- the kernels' plain versions and the fused sweeps over chains -------------

def _map_inputs(kind, c=3, n=1000, k=6, seed=0):
    """Stacked (rows, n) float64 data and C random thetas over a map."""
    g = torch.Generator().manual_seed(seed)
    d, p = (2, 0) if kind != ILR else (2, 1)
    xt = torch.randn((d + p, n), generator=g, dtype=torch.float64)
    m = cuda_estep.feature_width(kind, d, p)
    m8 = -(-m // 8) * 8
    theta = 0.3 * torch.randn((c, k, m8), generator=g, dtype=torch.float64)
    theta[..., m:] = 0.0
    return xt, theta, p


MAPS = {'gauss': GAUSS, 'diag': DIAG, 'ilr': ILR}


@pytest.mark.parametrize('kind', list(MAPS))
def test_estep_plain_chains_equal_separate_calls(kind):
    xt, theta, p = _map_inputs(MAPS[kind])
    acc, lse = cuda_estep.estep_plain(xt, theta, 997, MAPS[kind], p)
    assert acc.shape == theta.shape and lse.shape == (3,)
    for c in range(3):
        a, s = cuda_estep.estep_plain(xt, theta[c], 997, MAPS[kind], p)
        torch.testing.assert_close(acc[c], a, rtol=1e-12, atol=0.0)
        torch.testing.assert_close(lse[c], s, rtol=1e-12, atol=0.0)
    # the wrapper takes the plain version for CPU tensors, chains included
    acc_w, lse_w = cuda_estep.estep(xt, theta, 997, MAPS[kind], p)
    assert torch.equal(acc_w, acc) and torch.equal(lse_w, lse)


@pytest.mark.parametrize('kind', list(MAPS))
def test_gibbs_plain_chains_equal_separate_calls(kind):
    xt, theta, p = _map_inputs(MAPS[kind], seed=1)
    seeds = torch.tensor([5, 2 ** 40 + 3, 77], dtype=torch.int64)
    labels, acc = cuda_gibbs.gibbs_plain(xt, theta, seeds, 997, MAPS[kind],
                                         p)
    assert labels.shape == (3, 997) and labels.dtype == torch.int32
    for c in range(3):
        lab, a = cuda_gibbs.gibbs_plain(xt, theta[c], seeds[c], 997,
                                        MAPS[kind], p)
        assert torch.equal(labels[c], lab)
        torch.testing.assert_close(acc[c], a, rtol=1e-12, atol=0.0)
    assert len({tuple(labels[c, :50].tolist()) for c in range(3)}) == 3
    lab_w, _ = cuda_gibbs.gibbs(xt, theta, seeds, 997, MAPS[kind], p)
    assert torch.equal(lab_w, labels)


def _fam_state(name, gmm_x, ilr_xy, c):
    """A port model, its data and C-stacked posteriors of short fits."""
    _, tm, _, dt = make_pair(name, gmm_x, ilr_xy)
    dt = dt if isinstance(dt, tuple) else (dt,)
    if name == 'ilr':
        dt = tm._std(dt)
    states = [tm.fit_vi_fused(dt, key=k, maxiter=2)[0] for k in range(c)]
    return tm, dt, stack_trees(states)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_fused_estep_blockwise_chains_equal_separate_calls(gmm_x, ilr_xy,
                                                           name):
    tm, data, st = _fam_state(name, gmm_x, ilr_xy, 3)
    spec = tm._estep_spec()
    log_pi = torch.vmap(lambda g: g.expected_log_pi())(st.gating)
    res = tfe.fused_estep_blockwise(tfe.chain_spec(spec), st.components,
                                    log_pi, data, block_size=333)
    assert res.lse.shape == (3,) and res.counts.shape == (3, tm.size)
    for c in range(3):
        one = tfe.fused_estep_blockwise(spec, chain(st.components, c),
                                        log_pi[c], data, block_size=333)
        torch.testing.assert_close(res.lse[c], one.lse, rtol=1e-12, atol=0.0)
        for a, b in zip(tree_map(lambda t: t, chain(res.stats, c)),
                        one.stats):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_fused_gibbs_blockwise_chains_equal_separate_calls(gmm_x, ilr_xy,
                                                           name):
    tm, data, st = _fam_state(name, gmm_x, ilr_xy, 3)
    spec = tm._estep_spec()
    params = torch.vmap(tm.family.mode_params)(st.components)
    log_pi = torch.vmap(lambda g: g.expected_log_pi())(st.gating)
    seeds = torch.tensor([1, 2, 3], dtype=torch.int64)
    labels, res = tfe.fused_gibbs_blockwise(tfe.chain_spec(spec), seeds,
                                            params, log_pi, data,
                                            block_size=333)
    assert labels.shape == (3, data[0].shape[0])
    for c in range(3):
        lab, one = tfe.fused_gibbs_blockwise(spec, seeds[c], chain(params, c),
                                             log_pi[c], data, block_size=333)
        assert torch.equal(labels[c], lab)
        torch.testing.assert_close(res.counts[c], one.counts, rtol=1e-12,
                                   atol=0.0)


# -- the chained engines against mimo_tpu from shared starts -------------------

def _jax_starts(jm, dj, keys):
    """C start states made by mimo_tpu: its fused VI, two sweeps per key."""
    return [jax.tree.map(np.asarray, jm.fit_vi_fused(
        dj, key=k, maxiter=2, backend='xla', block_size=100)[0])
        for k in keys]


def _chain_draws(monkeypatch, keys, n, k):
    """Hand each chain's JAX random responsibilities and anchors (for
    `keys` in order) to the port's chained engines, which draw them one
    chain at a time."""
    resps = iter([tt(jmix._random_resp(jax.random.PRNGKey(key), n, k,
                                       jnp.float64)) for key in keys])
    idxs = iter([tt(jax.random.choice(jax.random.PRNGKey(key), n, (k,),
                                      replace=False)) for key in keys])
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: next(resps))
    monkeypatch.setattr(tmix, '_anchor_indices', lambda *a: next(idxs))


@pytest.mark.parametrize('name', list(CONFIGS))
def test_chained_vi_matches_jax_from_shared_starts(gmm_x, ilr_xy, name):
    jm, tm, dj, dt = make_pair(name, gmm_x, ilr_xy)
    starts = _jax_starts(jm, dj, KEYS)
    init = stack_trees([state_from_numpy(s) for s in starts])
    st, vlb = fit_chains(tm, 'fit_vi_fused', dt, list(KEYS), maxiter=6,
                         init_state=init, randomize=False, block_size=100)
    assert vlb.shape == (3, 6)
    for c, s in enumerate(starts):
        st_j, v_j = jm.fit_vi_fused(dj, key=KEYS[c], maxiter=6,
                                    init_state=s, randomize=False,
                                    backend='xla', block_size=100)
        np.testing.assert_allclose(vlb[c].numpy(), np.asarray(v_j),
                                   rtol=1e-8)
        leaves_close(chain(st, c), st_j, 1e-8)


@pytest.mark.parametrize('engine', ['fit_map_fused', 'fit_em_fused'])
@pytest.mark.parametrize('name', list(CONFIGS))
def test_chained_plugin_engines_match_jax(monkeypatch, gmm_x, ilr_xy, name,
                                          engine):
    jm, tm, dj, dt = make_pair(name, gmm_x, ilr_xy)
    _chain_draws(monkeypatch, KEYS, dt[0].shape[0] if name == 'ilr'
                 else dt.shape[0], tm.size)
    st, ll = fit_chains(tm, engine, dt, list(KEYS), maxiter=5,
                        block_size=100)
    assert ll.shape == (3, 5)
    for c, key in enumerate(KEYS):
        st_j, ll_j = getattr(jm, engine)(dj, key=key, maxiter=5,
                                         backend='xla', block_size=100)
        np.testing.assert_allclose(ll[c].numpy(), np.asarray(ll_j),
                                   rtol=1e-8)
        leaves_close(chain(st, c), st_j, 1e-8)


# -- fit_chains against the port's single-chain fits ---------------------------

@pytest.mark.parametrize('engine', ['fit_vi_fused', 'fit_map_fused',
                                    'fit_em_fused'])
@pytest.mark.parametrize('name', ['dpgmm', 'ilr'])
def test_fit_chains_equal_serial_fits_and_repeat(gmm_x, ilr_xy, name,
                                                 engine):
    _, tm, _, dt = make_pair(name, gmm_x, ilr_xy)
    keys = torch.tensor(KEYS, dtype=torch.int64)
    st, tr = fit_chains(tm, engine, dt, keys, maxiter=8)
    st2, tr2 = fit_chains(tm, engine, dt, keys, maxiter=8)
    assert torch.equal(tr, tr2)
    for c, key in enumerate(KEYS):
        st_1, tr_1 = getattr(tm, engine)(dt, key=key, maxiter=8)
        torch.testing.assert_close(tr[c], tr_1, rtol=1e-10, atol=0.0)
        for a, b in zip(tree_map(lambda t: t.reshape(-1),
                                       chain(st, c)).__iter__(),
                        tree_map(lambda t: t.reshape(-1), st_1)):
            for x, y in zip(jax.tree.leaves(state_to_numpy(a)),
                            jax.tree.leaves(state_to_numpy(b))):
                np.testing.assert_allclose(x, y, rtol=1e-10,
                                           atol=1e-10 * np.abs(y).max())


def test_chained_vi_tol_stops_each_chain_on_its_own(gmm_x):
    """With tol, each chain stops on its own rule and its trace is
    constant-extended from its own stop, as the serial fit's."""
    _, tm, _, x = make_pair('dpgmm', gmm_x, None)
    st, tr = fit_chains(tm, 'fit_vi_fused', x, list(KEYS), maxiter=60,
                        tol=0.3)
    stops = []
    for c, key in enumerate(KEYS):
        st_1, tr_1 = tm.fit_vi_fused(x, key=key, maxiter=60, tol=0.3)
        torch.testing.assert_close(tr[c], tr_1, rtol=1e-10, atol=0.0)
        torch.testing.assert_close(chain(st.components.mu, c),
                                   st_1.components.mu, rtol=1e-10,
                                   atol=1e-10)
        stops.append(int((tr_1[1:] != tr_1[:-1]).sum()))
    assert max(stops) < 59 and len(set(stops)) > 1


def test_fused_gibbs_chains_finite_distinct_and_repeatable(gmm_x):
    """As tests/test_chains.py asks of JAX: labels (C, N), finite
    weights, chains that differ; and the same keys give the same chains."""
    _, tm, _, x = make_pair('dpgmm', gmm_x, None)
    gs = fit_chains(tm, 'fit_gibbs_fused', x, list(KEYS), maxiter=5)
    gs2 = fit_chains(tm, 'fit_gibbs_fused', x, list(KEYS), maxiter=5)
    lab = gs.labels
    assert lab.shape == (3, N) and lab.dtype == torch.int32
    assert bool(torch.isfinite(gs.log_pi).all())
    assert gs.components.mu.shape == (3, 5, 2)
    assert len({tuple(lab[i, :40].tolist()) for i in range(3)}) == 3
    assert torch.equal(gs.labels, gs2.labels)
    assert torch.equal(gs.params.mu, gs2.params.mu)


@pytest.mark.parametrize('name', ['tied', 'hier'])
def test_fused_chains_run_the_tied_and_hierarchical_draws(gmm_x, name):
    """The exact tied and hierarchical Gibbs draws and their VI updates
    run under the chains' vmap."""
    kw = dict(tied=True) if name == 'tied' else dict(hierarchical=True,
                                                    maxsubiter=3)
    tm = BayesianGMM.make(size=5, dim=2, gating='dp', kappa=0.05,
                          dtype=torch.float64, device='cpu', **kw)
    x = tt(gmm_x)
    gs = fit_chains(tm, 'fit_gibbs_fused', x, [1, 2], maxiter=4)
    assert gs.labels.shape == (2, N) and bool(torch.isfinite(
        gs.log_pi).all())
    st, tr = fit_chains(tm, 'fit_vi_fused', x, [1, 2], maxiter=4)
    _, tr_1 = tm.fit_vi_fused(x, key=2, maxiter=4)
    torch.testing.assert_close(tr[1], tr_1, rtol=1e-10, atol=0.0)


# -- dense engines through fit_chains -----------------------------------------

@pytest.mark.parametrize('engine', ['fit_vi', 'fit_gibbs', 'fit_map',
                                    'fit_em', 'fit_svi'])
def test_dense_engines_through_fit_chains_have_jax_shapes(gmm_x, engine):
    jm, tm, dj, dt = make_pair('dpgmm', gmm_x, None)
    kw = {'fit_vi': dict(maxiter=4), 'fit_map': dict(maxiter=4),
          'fit_em': dict(maxiter=4),
          'fit_gibbs': dict(maxiter=4, track_loglik=True),
          'fit_svi': dict(maxiter=5, batch_size=64)}[engine]
    got = fit_chains(tm, engine, dt, list(KEYS), **kw)
    want = jchains.fit_chains(jm, engine, dj,
                              jax.random.split(jax.random.PRNGKey(0), 3),
                              **kw)
    gl, wl = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert [a.shape for a in gl] == [tuple(b.shape) for b in wl]
    assert all(np.isfinite(a).all() for a in gl
               if np.issubdtype(a.dtype, np.floating))
    if engine == 'fit_gibbs':
        state, ll = got
        assert ll.shape == (3, 4)
        one = tm.fit_gibbs(dt, key=KEYS[1], maxiter=0)
        assert torch.equal(
            fit_chains(tm, 'fit_gibbs', dt, list(KEYS),
                       maxiter=0).labels[1], one.labels)


def test_dense_gibbs_chains_statistics_are_per_chain(gmm_x):
    """The chained dense sweep's flat (N, C K) statistics give each
    chain's own: a sweep from C different label sets equals the
    single-chain sweep's statistics on each."""
    _, tm, _, x = make_pair('dpgmm', gmm_x, None)
    data = (x,)
    st = stack_trees([tm.fit_gibbs(x, key=k, maxiter=0) for k in KEYS])
    stats_flat = tm.family.suff_stats(data, tmix.one_hot(
        st.labels.T, tm.size, dtype=x.dtype).reshape(N, -1))
    for c in range(3):
        one = tm.family.suff_stats(
            data, tmix.one_hot(st.labels[c], tm.size, dtype=x.dtype))
        for a, b in zip(stats_flat, one):
            torch.testing.assert_close(a[c * tm.size:(c + 1) * tm.size], b,
                                       rtol=1e-12, atol=1e-12)


# -- best_of and systematic resampling -----------------------------------------

def test_best_of_picks_jaxs_chain(gmm_x):
    jm, tm, dj, dt = make_pair('dpgmm', gmm_x, None)
    starts = _jax_starts(jm, dj, KEYS)
    fits = [jm.fit_vi_fused(dj, key=k, maxiter=4, init_state=s,
                            randomize=False, backend='xla', block_size=100)
            for k, s in zip(KEYS, starts)]
    jst = jax.tree.map(lambda *a: jnp.stack(a), *[f[0] for f in fits])
    jv = jnp.stack([f[1] for f in fits])
    want_state, want_idx = jchains.best_of(jst, jv)
    st = state_from_numpy(jax.tree.map(np.asarray, jst))
    got_state, got_idx = best_of(st, tt(jv))
    assert int(got_idx) == int(want_idx)
    leaves_close(got_state, want_state, 1e-12)


@pytest.mark.parametrize('case', range(6))
def test_systematic_resample_indices_equal_jax(case):
    rng = np.random.default_rng(case)
    c = [4, 8, 16][case % 3]
    log_w = rng.standard_normal(c) * (3.0 if case >= 3 else 0.5)
    key = jax.random.PRNGKey(100 + case)
    tree = {'a': jnp.arange(c)}
    _, want = jchains.systematic_resample(key, jnp.asarray(log_w), tree)
    u = float(jax.random.uniform(key, ()))
    got = systematic_indices(torch.tensor(u, dtype=torch.float64),
                             torch.tensor(log_w))
    assert got.tolist() == np.asarray(want).tolist()


def test_systematic_resample_moves_the_tree():
    log_w = torch.tensor([0.0, -50.0, -50.0, -50.0], dtype=torch.float64)
    tree = MFState(torch.arange(4.0), (torch.arange(8.0).view(4, 2),))
    out, idx = systematic_resample(0, log_w, tree)
    assert idx.tolist() == [0, 0, 0, 0]
    assert out.components.tolist() == [0.0] * 4
    assert out.gating[0].tolist() == [[0.0, 1.0]] * 4


# -- smc_gibbs ------------------------------------------------------------------

def test_smc_gibbs_gmm_improves(gmm_x):
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', kappa=0.05,
                          psi_scale=0.5, dtype=torch.float64, device='cpu')
    states, lls = smc_gibbs(tm, tt(gmm_x), key=0, n_chains=4, n_rounds=6,
                            sweeps_per_round=5)
    assert bool(torch.isfinite(lls).all()) and lls.shape == (6,)
    assert float(lls[-1]) > float(lls[0])
    assert states.labels.shape == (4, N)


def test_smc_gibbs_ilr_transform_consistency(ilr_xy):
    """Everything runs on the transformed data: the chains' start (the
    base-class engine) and their sweeps and scores alike."""
    x, y = tt(ilr_xy[0]), tt(ilr_xy[1])
    tm = BayesianILR.make(size=10, input_dim=1, output_dim=1, alpha=2.0,
                          kappa=0.05, dtype=torch.float64, device='cpu')
    tm.init_transform(x, y)
    states, lls = smc_gibbs(tm, (x, y), key=1, n_chains=4, n_rounds=4,
                            sweeps_per_round=5)
    assert bool(torch.isfinite(lls).all())
    assert float(lls[-1]) > float(lls[0])
    # the basis means live on the standardized scale (|mean| ~ 1, not 6)
    assert float(states.components[0].mu.abs().max()) < 4.0


NESTED_KEYS = (4, 9, 13)


def nested_model(kind, hierarchical=False):
    """A small float64 nested model on the CPU and its data."""
    if kind == 'ilr':
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.uniform(-6, 6, (600, 1)))
        y = torch.sin(x) + 0.1 * torch.from_numpy(
            rng.standard_normal((600, 1)))
        hm = BayesianMixtureOfMixtures.make_ilr(2, 3, 1, 1, kappa=0.05,
                                                dtype=torch.float64,
                                                device='cpu')
        hm.init_transform(x, y)
        return hm, (x, y)
    rng = np.random.default_rng(6)
    c = np.array([[-5., -4.], [5., 4.]])
    x = torch.from_numpy(c[np.arange(900) % 2]
                         + 0.7 * rng.standard_normal((900, 2)))
    hm = BayesianMixtureOfMixtures.make_gmm(
        3, 4, 2, hierarchical=hierarchical, kappa=0.5, psi_scale=0.5,
        maxsubiter=3, dtype=torch.float64, device='cpu')
    return hm, (x,)


@pytest.mark.parametrize('engine,kind,hier', [
    ('fit_vi_fused', 'gmm', False), ('fit_vi_fused', 'gmm', True),
    ('fit_vi_fused', 'ilr', False), ('fit_map_fused', 'gmm', False),
    ('fit_map_fused', 'gmm', True), ('fit_em_fused', 'gmm', False),
    ('fit_em_fused', 'ilr', False)])
def test_nested_chains_equal_serial_fits(engine, kind, hier):
    """Chain c of a nested fused engine through fit_chains is the nested
    fit with key c (each chain's start drawn from its own generator), and
    the same keys repeat the chains."""
    hm, data = nested_model(kind, hier)
    st, tr = fit_chains(hm, engine, data, list(NESTED_KEYS), maxiter=6)
    assert tr.shape == (len(NESTED_KEYS), 6)
    for i, k in enumerate(NESTED_KEYS):
        s1, t1 = getattr(hm, engine)(data, key=k, maxiter=6)
        torch.testing.assert_close(tr[i], t1, rtol=1e-10, atol=0.0)
        for a, b in zip(jax.tree.leaves(state_to_numpy(
                tree_map(lambda v: v[i], st))),
                jax.tree.leaves(state_to_numpy(s1))):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    _, tr2 = fit_chains(hm, engine, data, list(NESTED_KEYS), maxiter=6)
    assert torch.equal(tr, tr2)


def test_nested_vi_chains_tol_stop_each_chain_on_its_own():
    hm, data = nested_model('gmm')
    st, tr = fit_chains(hm, 'fit_vi_fused', data, list(NESTED_KEYS),
                        maxiter=40, tol=1e-3)
    for i, k in enumerate(NESTED_KEYS):
        _, t1 = hm.fit_vi_fused(data, key=k, maxiter=40, tol=1e-3)
        torch.testing.assert_close(tr[i], t1, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize('hier', [False, True])
def test_nested_gibbs_chains_finite_distinct_and_repeatable(hier):
    hm, data = nested_model('gmm', hier)
    gs = fit_chains(hm, 'fit_gibbs_fused', data, [1, 2, 3], maxiter=8)
    assert gs.labels.shape == (3, 900)
    assert int(gs.labels.max()) < hm.cluster_size
    for leaf in jax.tree.leaves(state_to_numpy(gs)):
        assert np.isfinite(leaf).all()
    mus = (gs.components.mus if hier else gs.components.mu)
    assert not torch.equal(mus[0], mus[1])
    gs2 = fit_chains(hm, 'fit_gibbs_fused', data, [1, 2, 3], maxiter=8)
    assert torch.equal(gs.labels, gs2.labels)
    torch.testing.assert_close(mus, gs2.components.mus if hier
                               else gs2.components.mu, rtol=0, atol=0)


def _jax_nested(hier):
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures as JaxHMix
    return JaxHMix.make_gmm(3, 4, 2, hierarchical=hier, kappa=0.5,
                            psi_scale=0.5, maxsubiter=3, dtype=jnp.float64)


@pytest.mark.parametrize('engine', ['fit_vi_fused', 'fit_gibbs_fused',
                                    'fit_map_fused', 'fit_em_fused',
                                    'fit_vi', 'fit_gibbs', 'fit_map',
                                    'fit_em', 'fit_svi'])
def test_nested_chains_have_jax_structure(engine):
    """fit_chains over a nested model returns what mimo_tpu's vmapped
    fit_chains returns: the same tree with a leading C axis on every leaf,
    and (C, maxiter) traces."""
    hm, data = nested_model('gmm')
    jm = _jax_nested(False)
    kw = dict(maxiter=3)
    if engine == 'fit_svi':
        kw.update(batch_size=64)
    out = fit_chains(hm, engine, data, [1, 2, 3], **kw)
    jout = jchains.fit_chains(jm, engine, jnp.asarray(data[0].numpy()),
                              jax.random.split(jax.random.PRNGKey(0), 3),
                              **kw)
    shapes = [a.shape for a in jax.tree.leaves(state_to_numpy(out))]
    jshapes = [np.shape(a) for a in jax.tree.leaves(jout)]
    assert shapes == jshapes


def test_nested_models_are_refused():
    """smc_gibbs refuses nested models, as mimo_tpu's does; fit_chains
    takes them (the tests above)."""
    hm = BayesianMixtureOfMixtures.make_gmm(2, 3, 2, hierarchical=False,
                                            dtype=torch.float64,
                                            device='cpu')
    x = torch.randn(200, 2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match='nested mixtures'):
        smc_gibbs(hm, x, key=0, n_chains=2, n_rounds=1)


def test_fit_chains_refuses_unknown_engines(gmm_x):
    _, tm, _, x = make_pair('dpgmm', gmm_x, None)
    with pytest.raises(ValueError, match='unknown engine'):
        fit_chains(tm, 'fit_vi_stream', x, [0, 1])


def test_finite_report_names_the_chain(monkeypatch):
    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', 'warn')
    from mimo_tpu_torch.utils.sanitize import finite_report
    trace = torch.zeros((3, 6))
    trace[1, 4:] = float('nan')
    trace[2, 2] = float('inf')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        finite_report((MFState(torch.zeros(3), torch.zeros(3)), trace),
                      'fit_vi_fused')
    msg = str(caught[-1].message)
    assert 'chain 1 from sweep 4' in msg and 'chain 2 from sweep 2' in msg


# -- the fixed-state two-sample check on B2's plain twin ------------------------

def test_fixed_state_two_sample_check_on_the_plain_twin():
    """S = 64 label sweeps of one fixed state (a short fused Gibbs fit at
    N = 5,000, K = 10) as 64 chains of B2's plain version, against the
    exact and the precision rule's expectation, under the thresholds
    chip_smoke.py holds the kernel to."""
    g = torch.Generator().manual_seed(0)
    centres = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]])
    x = (centres[torch.arange(5000) % 3]
         + 1.5 * torch.randn((5000, 2), generator=g))
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device='cpu')
    gs = m.fit_gibbs_fused(x, key=3, maxiter=5)
    theta, _ = pad_theta(m._estep_spec().theta_plugin(gs.params), gs.log_pi,
                         torch.float32)
    seeds = 1000 + torch.arange(64, dtype=torch.int64)
    stats, labels = precision.fixed_state_check(kernel_xts((x,))[0], theta,
                                                seeds, 5000)
    assert labels.shape == (64, 5000)
    for name, st in stats.items():
        assert st['live'] >= 3, (name, st)
        assert precision.passes(st), (name, st)
    # the rule's logits sit within float32 rounding of the exact ones
    assert abs(stats['exact']['max_z'] - stats['emulated']['max_z']) < 1e-3


def test_two_sample_check_catches_a_biased_sampler():
    """Labels drawn at a shifted state fail the thresholds: the check
    has power at the sizes it runs."""
    g = torch.Generator().manual_seed(1)
    xt = torch.randn((2, 5000), generator=g)
    theta = torch.zeros((4, 8))
    theta[:, 1] = torch.tensor([-1.0, 0.0, 1.0, 2.0])
    seeds = torch.arange(64, dtype=torch.int64)
    biased = theta.clone()
    biased[0, 0] += 0.1                  # ~10% more weight on component 0
    labels, _ = cuda_gibbs.gibbs_plain(
        xt, biased.expand(64, 4, 8).contiguous(), seeds, 5000)
    counts = precision.chain_counts(labels, 4)
    f64 = cuda_estep.assemble_features(xt.double(), 8)
    stats = precision.count_stats(
        counts, *precision.count_moments(theta.double() @ f64))
    assert not precision.passes(stats)
