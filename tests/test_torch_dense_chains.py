"""The dense engines batched over chains (models.mixture and models.hmix
with chains=True, through parallel.fit_chains) and the ILR feature map over
a diagonal basis on kernels B1/B2, on the CPU in float64 where B1/B2 run
their plain versions:

  * ilr_spec(diag_basis=True): the port's dense E-step and B1's plain twin
    against mimo_tpu's dense E-step (rtol 1e-8), the kernels' kinds and
    widths against mimo_tpu's product width, and B1/B2's plain twins
    against the Pallas kernels in interpret mode (float32, masked tail);
  * chain c of the dense VI, MAP, ML-EM and SVI of every flat family, and
    of the nested mixtures, against the fit with key c (rtol 1e-10), the
    same keys repeating the chains bitwise; `tol`, `track_elbo` and the
    Robbins-Monro schedule per chain; Gibbs chains finite, distinct and
    repeatable;
  * chains with their own data and their own priors (`with_priors` of a
    C-stacked state) against jax.vmap of mimo_tpu's fit_vi (rtol 1e-8),
    and the port's SVI and Gibbs over them against its serial fits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.conjugate.families as jfam
from mimo_tpu.distributions import mng as jmng
from mimo_tpu.distributions import mnw as jmnw
from mimo_tpu.distributions import ng as jng
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas
from mimo_tpu.ops.pallas_gibbs import fused_gibbs_pallas

import mimo_tpu_torch.conjugate.families as tfam
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.parallel import fit_chains
from mimo_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)
KEYS = (3, 7, 11)


def _leaves(tree):
    return jax.tree.leaves(state_to_numpy(tree))


def close(got, want, rtol):
    """Leaf by leaf, rtol with an absolute floor of rtol x the leaf's
    largest magnitude."""
    g, w = _leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


def chain(tree, c):
    return tree_map(lambda a: a[c], tree)


def to_jax(tree):
    """A port state as the JAX package's NamedTuples of the same names."""
    import mimo_tpu.distributions as jd
    import mimo_tpu.models.mixture as jmix
    mods = [jmix] + [getattr(jd, m) for m in ('gating', 'niw', 'mnw')]

    def conv(t):
        if isinstance(t, torch.Tensor):
            return jnp.asarray(t.numpy())
        items = [conv(a) for a in t]
        if not hasattr(t, '_fields'):
            return tuple(items)
        cls = next(getattr(m, type(t).__name__) for m in mods
                   if hasattr(m, type(t).__name__))
        return cls(*items)
    return conv(tree)


def chains_equal_serial(fit, keys=KEYS, rtol=1e-10):
    """fit(key, chains) over C keys: chain c equals the fit with key c, and
    the same keys repeat the chains bitwise. Returns the chains."""
    out = fit(list(keys), True)
    equal(out, fit(list(keys), True))
    for c, k in enumerate(keys):
        close(chain(out, c), state_to_numpy(fit(k, False)), rtol)
    return out


# -- the ILR map over a diagonal basis -----------------------------------------

def _diag_basis_problem(affine, diag_expert, dtype=np.float64, n=1000, k=6,
                        seed=5):
    """ILR data (d=2, p=1) and a posterior of NG basis x MNW or MNG experts:
    the standard priors updated by random responsibilities, in both
    packages."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 2))
    y = np.sin(x[:, :1]) + 0.3 * x[:, 1:] + 0.1 * rng.standard_normal((n, 1))
    resp = rng.dirichlet(np.ones(k), n)
    q = 2 + int(affine)
    if diag_expert:
        jexp = jmng.MNG.standard(k, 1, q, K_scale=0.5, dtype=jnp.float64)
        jef = jfam.diag_linear_family(affine)
    else:
        jexp = jmnw.MNW.standard(k, 1, q, K_scale=0.5, dtype=jnp.float64)
        jef = jfam.linear_family(affine)
    jf = jfam.product_family((jfam.diag_gaussian_family(), jef),
                             ((0,), (0, 1)))
    prior = (jng.NG.standard(k, 2, kappa=0.5, dtype=jnp.float64), jexp)
    post = jf.update(prior, jf.suff_stats((jnp.asarray(x), jnp.asarray(y)),
                                          jnp.asarray(resp)))
    post = jax.tree.map(lambda a: np.asarray(a, dtype), post)
    log_pi = np.log(rng.dirichlet(np.ones(k) * 3)).astype(dtype)
    return x.astype(dtype), y.astype(dtype), post, log_pi, jf


SPECS = [(a, e) for a in (True, False) for e in (False, True)]


@pytest.mark.parametrize('affine,diag_expert', SPECS)
def test_diag_basis_estep_matches_jax_f64(affine, diag_expert):
    """The port's dense E-step and B1's plain twin over ILR_DIAG /
    ILR_DIAG_LINEAR against mimo_tpu's dense E-step (rtol 1e-8); the
    kernels' width is mimo_tpu's product width."""
    x, y, post, log_pi, _ = _diag_basis_problem(affine, diag_expert)
    kw = dict(affine=affine, diag_basis=True, diag_expert=diag_expert)
    js, ts = jfe.ilr_spec(2, 1, **kw), tfe.ilr_spec(2, 1, **kw)
    want = jfe.fused_estep_dense(js, jax.tree.map(jnp.asarray, post),
                                 jnp.asarray(log_pi),
                                 (jnp.asarray(x), jnp.asarray(y)))
    kind = cuda_estep.feature_kind(ts.features_t)
    assert kind == (cuda_estep.ILR_DIAG if affine
                    else cuda_estep.ILR_DIAG_LINEAR)
    width = js.features((jnp.asarray(x), jnp.asarray(y))).shape[-1]
    assert cuda_estep.feature_width(kind, 2, 1) == width
    assert tfe.ilr_width(2, 1, affine, True) == width
    pt, lp = state_from_numpy(post), torch.tensor(log_pi)
    dt = (torch.tensor(x), torch.tensor(y))
    for got in (tfe.fused_estep_dense(ts, pt, lp, dt),
                cuda_estep.fused_estep_cuda(
                    ts, pt, lp, tuple(a.T.contiguous() for a in dt),
                    x.shape[0])):
        close(got.stats, want.stats, 1e-8)
        np.testing.assert_allclose(float(got.lse), float(want.lse),
                                   rtol=1e-8)
        np.testing.assert_allclose(got.counts.numpy(),
                                   np.asarray(want.counts), rtol=1e-8)


@pytest.mark.parametrize('affine,diag_expert', SPECS)
def test_diag_basis_b1_plain_matches_pallas_interpret_masked_tail(
        affine, diag_expert):
    """N=1000 over blocks of 384 (tests/test_pallas.py's tolerances): the
    Pallas launcher pads and masks the tail; B1's plain version stops at n
    (the columns past it hold junk)."""
    x, y, post, log_pi, _ = _diag_basis_problem(affine, diag_expert,
                                                np.float32)
    kw = dict(affine=affine, diag_basis=True, diag_expert=diag_expert)
    n = x.shape[0]
    xt = np.concatenate([x.T, y.T])
    xt_pad = jnp.pad(jnp.asarray(xt), ((0, 0), (0, (-n) % 384)))
    want = fused_estep_pallas(jfe.ilr_spec(2, 1, **kw),
                              jax.tree.map(jnp.asarray, post),
                              jnp.asarray(log_pi), (xt_pad[:2], xt_pad[2:]),
                              384, n)
    padded = torch.cat([torch.tensor(xt), torch.full((3, 24), 1e3)], 1)
    got = cuda_estep.fused_estep_cuda(
        tfe.ilr_spec(2, 1, **kw), state_from_numpy(post),
        torch.tensor(log_pi), (padded[:2], padded[2:]), n)
    close(got.stats, want.stats, 2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


@pytest.mark.parametrize('affine', [True, False])
def test_diag_basis_b2_plain_labels_and_stats_against_pallas(affine):
    """B2 over ILR_DIAG / ILR_DIAG_LINEAR: the Pallas sweep's statistics
    (interpret mode, masked tail, its own PRNG) are the one-hot sums its
    labels give through the port's map and unpack; the plain version's
    labels equal the blockwise engine's (the same Philox draws), follow
    the softmax over K, and its statistics are its labels' one-hot
    sums."""
    x, y, post, log_pi, jf = _diag_basis_problem(affine, False, np.float32)
    kw = dict(affine=affine, diag_basis=True)
    n, k = x.shape[0], log_pi.shape[0]
    params_j = jf.mode_params(jax.tree.map(jnp.asarray, post))
    xt = np.concatenate([x.T, y.T])
    xt_pad = jnp.pad(jnp.asarray(xt), ((0, 0), (0, (-n) % 384)))
    lab_j, res_j = fused_gibbs_pallas(jfe.ilr_spec(2, 1, **kw), 7, params_j,
                                      jnp.asarray(log_pi),
                                      (xt_pad[:2], xt_pad[2:]), 384, n)
    spec = tfe.ilr_spec(2, 1, **kw)
    data = (torch.tensor(x), torch.tensor(y))
    feats = spec.features(data)
    oh = torch.nn.functional.one_hot(torch.tensor(np.asarray(lab_j)).long(),
                                     k).float()
    close(spec.unpack(oh.T @ feats), res_j.stats, 2e-5)

    params_t = state_from_numpy(jax.tree.map(np.asarray, params_j))
    seed = torch.tensor(123456789, dtype=torch.int64)
    lp = torch.tensor(log_pi)
    labels, res = cuda_gibbs.fused_gibbs_cuda(spec, seed, params_t, lp,
                                              cuda_estep.kernel_xts(data), n)
    ref_labels, _ = tfe.fused_gibbs_blockwise(spec, seed, params_t, lp, data,
                                              256)
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    oh = torch.nn.functional.one_hot(labels.long(), k).float()
    close(res.stats, state_to_numpy(spec.unpack(oh.T @ feats)), 1e-5)
    probs = torch.softmax(feats.double() @ spec.theta_plugin(
        params_t).double().T + lp.double(), -1)
    expected = probs.sum(0).numpy()
    counts = np.bincount(labels.numpy(), minlength=k)
    assert np.all(np.abs(counts - expected)
                  <= 5 * np.sqrt(expected * (1 - expected / n)) + 5)


# -- the flat dense engines over chains -----------------------------------------

@pytest.fixture(scope='module')
def gmm_x():
    rng = np.random.default_rng(11)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return torch.from_numpy(c[np.arange(600) % 3]
                            + rng.standard_normal((600, 2)))


@pytest.fixture(scope='module')
def sine():
    rng = np.random.default_rng(12)
    x = rng.uniform(-6, 6, (400, 1))
    return (torch.from_numpy(x),
            torch.from_numpy(np.sin(x) + 0.1 * rng.standard_normal((400, 1))))


FAMILIES = {
    'dpgmm': dict(gating='dp', kappa=0.05, psi_scale=0.5),
    'diag': dict(gating='dirichlet', diag=True, kappa=0.05),
    'tied': dict(gating='dp', tied=True, kappa=0.05, psi_scale=0.5),
    'hier': dict(gating='dp', hierarchical=True, kappa=0.05, maxsubiter=3),
    'ilr': dict(alpha=2.0, kappa=0.05),
    'ilr_mng': dict(alpha=2.0, kappa=0.05, diag=True),
    'ilr_tied': dict(alpha=2.0, kappa=0.05, tied_affine=True,
                     hier_basis=True, maxsubiter=3),
}
ENGINES = {'fit_vi': dict(maxiter=6), 'fit_map': dict(maxiter=5),
           'fit_em': dict(maxiter=5),
           'fit_svi': dict(maxiter=15, step_size=0.5, batch_size=64)}
# no maximum-likelihood update (hierarchical parts), no SVI blend
# (tied-affine experts), as in the JAX package
UNSUPPORTED = {('hier', 'fit_em'), ('ilr_tied', 'fit_em'),
               ('ilr_tied', 'fit_svi')}


def flat_model(name, gmm_x, sine):
    kw = FAMILIES[name]
    if name.startswith('ilr'):
        m = BayesianILR.make(size=6, input_dim=1, output_dim=1,
                             dtype=torch.float64, device='cpu', **kw)
        m.init_transform(*sine)
        return m, sine
    return BayesianGMM.make(size=5, dim=2, dtype=torch.float64,
                            device='cpu', **kw), gmm_x


@pytest.mark.parametrize('engine', list(ENGINES))
@pytest.mark.parametrize('name', list(FAMILIES))
def test_dense_chains_equal_serial_fits(gmm_x, sine, name, engine):
    """fit_chains of a dense engine runs the C chains as one program;
    chain c is the fit with key c (rtol 1e-10), and the same keys repeat
    the chains bitwise."""
    m, data = flat_model(name, gmm_x, sine)
    kw = ENGINES[engine]
    if (name, engine) in UNSUPPORTED:
        with pytest.raises(NotImplementedError):
            fit_chains(m, engine, data, list(KEYS), **kw)
        return
    st, tr = chains_equal_serial(
        lambda k, c: (fit_chains(m, engine, data, k, **kw) if c
                      else getattr(m, engine)(data, key=k, **kw)))
    assert tr.shape == (len(KEYS), kw['maxiter'])
    assert not torch.equal(tr[0], tr[1]) or engine == 'fit_svi'


@pytest.mark.parametrize('engine', ['fit_vi', 'fit_map', 'fit_em'])
def test_dense_chains_with_point_weights_and_warm_starts(gmm_x, engine):
    """fit_vi's point weights and C-stacked warm start, and the plug-in
    engines over the ILR wrappers' data tuple, chain by chain."""
    m, x = flat_model('dpgmm', gmm_x, None)
    if engine == 'fit_vi':
        w = torch.from_numpy(np.random.default_rng(2).uniform(0, 2, 600))
        init = tmix.stack_trees([m.fit_vi(x, key=k, maxiter=2)[0]
                                 for k in KEYS])
        chains_equal_serial(lambda k, c: m.fit_vi(
            x, key=k, chains=c, maxiter=4, point_weights=w, randomize=False,
            init_state=init if c else chain(init, KEYS.index(k))))
    else:
        chains_equal_serial(lambda k, c: getattr(m, engine)(
            x, key=k, chains=c, maxiter=4))


def test_dense_vi_tol_stops_each_chain_on_its_own(gmm_x):
    """With tol each chain stops on its own rule, its trace constant-
    extended from its own stop, as the serial fit's."""
    m, x = flat_model('dpgmm', gmm_x, None)
    _, tr = chains_equal_serial(lambda k, c: m.fit_vi(
        x, key=k, chains=c, maxiter=60, tol=0.5))
    stops = [int((t[1:] != t[:-1]).sum()) for t in tr]
    assert max(stops) < 59 and len(set(stops)) > 1


@pytest.mark.parametrize('schedule', ['track_elbo', 'forgetting'])
def test_dense_svi_chains_track_elbo_and_schedule(gmm_x, sine, schedule):
    """track_elbo (every chain's full-data ELBO after each step) and the
    Robbins-Monro schedule (forgetting, delay) behave per chain as in a
    single fit."""
    m, x = flat_model('ilr', gmm_x, sine)
    kw = (dict(track_elbo=True) if schedule == 'track_elbo'
          else dict(forgetting=0.7, delay=2.0, step_size=0.9))
    _, tr = chains_equal_serial(lambda k, c: m.fit_svi(
        x, key=k, chains=c, maxiter=12, batch_size=32, **kw))
    assert bool((tr != 0).all()) == (schedule == 'track_elbo')


@pytest.mark.parametrize('name', ['dpgmm', 'ilr_tied'])
def test_dense_gibbs_chains_finite_distinct_and_repeatable(gmm_x, sine,
                                                           name):
    m, data = flat_model(name, gmm_x, sine)
    gs, ll = fit_chains(m, 'fit_gibbs', data, list(KEYS), maxiter=4,
                        track_loglik=True)
    gs2, _ = fit_chains(m, 'fit_gibbs', data, list(KEYS), maxiter=4,
                        track_loglik=True)
    equal(gs, gs2)
    assert ll.shape == (3, 4) and bool(torch.isfinite(ll).all())
    assert all(np.isfinite(a).all() for a in _leaves(gs)
               if np.issubdtype(a.dtype, np.floating))
    assert len({tuple(gs.labels[i, :40].tolist()) for i in range(3)}) == 3


# -- nested mixtures -------------------------------------------------------------

def nested_model(kind, hier=False):
    rng = np.random.default_rng(6)
    if kind == 'ilr':
        x = torch.from_numpy(rng.uniform(-6, 6, (300, 1)))
        y = torch.sin(x) + 0.1 * torch.from_numpy(
            rng.standard_normal((300, 1)))
        hm = BayesianMixtureOfMixtures.make_ilr(2, 3, 1, 1, kappa=0.05,
                                                dtype=torch.float64,
                                                device='cpu')
        hm.init_transform(x, y)
        return hm, (x, y)
    c = np.array([[-5., -4.], [5., 4.]])
    x = torch.from_numpy(c[np.arange(400) % 2]
                         + 0.7 * rng.standard_normal((400, 2)))
    return BayesianMixtureOfMixtures.make_gmm(
        3, 4, 2, hierarchical=hier, kappa=0.5, psi_scale=0.5, maxsubiter=2,
        dtype=torch.float64, device='cpu'), (x,)


NESTED = [(e, kind, hier) for kind, hier in (('gmm', False), ('gmm', True),
                                             ('ilr', False))
          for e in ('fit_vi', 'fit_map', 'fit_em', 'fit_svi')
          if not (hier and e == 'fit_em')]


@pytest.mark.parametrize('engine,kind,hier', NESTED)
def test_nested_dense_chains_equal_serial_fits(engine, kind, hier):
    """A nested dense engine's chains run as one program (one more vmap
    over C around the M-vmapped algebra); chain c is the nested fit with
    key c (rtol 1e-10)."""
    hm, data = nested_model(kind, hier)
    kw = (dict(maxiter=10, step_size=0.3, batch_size=32)
          if engine == 'fit_svi' else dict(maxiter=3, maxsubiter=2))
    chains_equal_serial(lambda k, c: (
        fit_chains(hm, engine, data, k, **kw) if c
        else getattr(hm, engine)(data, key=k, **kw)))


@pytest.mark.parametrize('hier', [False, True])
def test_nested_dense_gibbs_chains_finite_distinct_and_repeatable(hier):
    """The nested dense Gibbs chains draw from one generator seeded by the
    chains' keys: finite, distinct, and the same keys repeat them."""
    hm, data = nested_model('gmm', hier)
    gs = fit_chains(hm, 'fit_gibbs', data, [1, 2, 3], maxiter=4)
    equal(gs, fit_chains(hm, 'fit_gibbs', data, [1, 2, 3], maxiter=4))
    assert gs.labels.shape == (3, 400) and gs.labels.dtype == torch.int32
    assert int(gs.labels.max()) < hm.cluster_size
    assert all(np.isfinite(a).all() for a in _leaves(gs)
               if np.issubdtype(a.dtype, np.floating))
    mus = gs.components.mus if hier else gs.components.mu
    assert not torch.equal(mus[0], mus[1])


# -- each chain's own data and priors --------------------------------------------

def _own_splits(x, y=None, s=3, n_tr=250, seed=4):
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(x.shape[0])[:n_tr] for _ in range(s)])
    if y is None:
        return (x[perms],)
    return x[perms], y[perms]


@pytest.mark.parametrize('name', ['dpgmm', 'ilr'])
def test_own_data_and_priors_match_jax_vmap(gmm_x, sine, name):
    """jax.vmap(lambda x, st: m.with_priors(st).fit_vi(x, init_state=st,
    randomize=False, maxiter=5)) over S stacked splits equals the port's
    batched fit_vi over (S, N, ...) data under S-stacked priors (rtol
    1e-8): deterministic, so it holds the own-data, own-priors path
    directly."""
    m, data = flat_model(name, gmm_x, sine)
    own = _own_splits(*(a.numpy() for a in (data if name == 'ilr'
                                             else (data,))))
    keys = list(KEYS)
    g = m.fit_gibbs(tuple(torch.from_numpy(a) for a in own), key=keys,
                    chains=True, maxiter=3)
    st = MFState(g.components, g.gating)
    kw = dict(alpha=2.0, kappa=0.05) if name == 'ilr' else dict(
        gating='dp', kappa=0.05, psi_scale=0.5)
    if name == 'ilr':
        jm = JaxILR.make(size=6, input_dim=1, output_dim=1,
                         dtype=jnp.float64, **kw)
        jm.init_transform(*(jnp.asarray(a.numpy()) for a in sine))
    else:
        jm = JaxGMM.make(size=5, dim=2, dtype=jnp.float64, **kw)
    st_j = to_jax(st)

    def one(d, s):
        return jm.with_priors(s).fit_vi(d, key=jax.random.PRNGKey(0),
                                        init_state=s, randomize=False,
                                        maxiter=5)
    want = jax.vmap(one)(tuple(jnp.asarray(a) for a in own), st_j)
    got = m.with_priors(st).fit_vi(tuple(torch.from_numpy(a) for a in own),
                                   key=keys, chains=True, init_state=st,
                                   randomize=False, maxiter=5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-8)
    close(got[0], want[0], 1e-8)


def test_own_data_and_priors_svi_map_and_gibbs(sine):
    """The sinc study's recipe over S splits: Gibbs, then SVI under the
    model's priors, then SVI and MAP under the chains' own re-anchored
    priors; every SVI and MAP chain equals the serial fit on its split
    under its priors (rtol 1e-10), and the Gibbs chains are finite and
    repeat."""
    m, _ = flat_model('ilr', None, sine)
    own = tuple(torch.from_numpy(a) for a in _own_splits(
        *(a.numpy() for a in sine)))
    keys = list(KEYS)
    g = m.fit_gibbs(own, key=keys, chains=True, maxiter=3)
    equal(g, m.fit_gibbs(own, key=keys, chains=True, maxiter=3))
    assert g.labels.shape == (3, 250)
    st0 = MFState(g.components, g.gating)
    kw = dict(maxiter=10, step_size=0.5, batch_size=32)

    def svi(model, models, init):
        def fit(k, c):
            if c:
                return model.fit_svi(own, key=k, chains=True,
                                     init_state=init, **kw)
            i = keys.index(k)
            return models(i).fit_svi(tuple(a[i] for a in own), key=k,
                                     init_state=chain(init, i), **kw)
        return chains_equal_serial(fit)

    st1, _ = svi(m, lambda i: m, st0)
    mm = m.with_priors(st1)
    svi(mm, lambda i: m.with_priors(chain(st1, i)), st1)
    chains_equal_serial(lambda k, c: (
        mm.fit_map(own, key=k, chains=True, maxiter=4) if c else
        m.with_priors(chain(st1, keys.index(k))).fit_map(
            tuple(a[keys.index(k)] for a in own), key=k, maxiter=4)))
    g2 = mm.fit_gibbs(own, key=keys, chains=True, maxiter=2)
    assert all(np.isfinite(a).all() for a in _leaves(g2)
               if np.issubdtype(a.dtype, np.floating))


def test_own_chain_axes_are_checked(gmm_x):
    m, x = flat_model('dpgmm', gmm_x, None)
    own = torch.stack([x[:300], x[300:]])
    with pytest.raises(ValueError, match='3 chain keys, 2 chains of data'):
        m.fit_vi(own, key=list(KEYS), chains=True, maxiter=1)
    st, _ = m.fit_vi(x, key=[1, 2], chains=True, maxiter=1)
    with pytest.raises(ValueError, match='need chains=True'):
        m.with_priors(st).fit_vi(x, key=1, maxiter=1)
    with pytest.raises(ValueError, match='shared data'):
        m.fit_em(own, key=[1, 2], chains=True, maxiter=1)


def test_diag_basis_product_family_is_the_jax_one():
    """The port's product of the NG basis and MNW experts (the family
    ilr_spec(diag_basis=True) describes) has the JAX family's statistics
    and update (rtol 1e-10)."""
    x, y, post, _, jf = _diag_basis_problem(True, False)
    tf = tfam.product_family((tfam.diag_gaussian_family(),
                              tfam.linear_family(True)), ((0,), (0, 1)))
    resp = np.random.default_rng(0).dirichlet(np.ones(6), x.shape[0])
    want = jf.suff_stats((jnp.asarray(x), jnp.asarray(y)), jnp.asarray(resp))
    got = tf.suff_stats((torch.tensor(x), torch.tensor(y)),
                        torch.tensor(resp))
    close(got, want, 1e-10)
    close(tf.update(state_from_numpy(post), got),
          jf.update(jax.tree.map(jnp.asarray, post), want), 1e-10)
