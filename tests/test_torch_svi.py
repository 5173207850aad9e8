"""The port's stochastic VI against mimo_tpu on the CPU, in float64: every
family's and gating's `svi_blend` on the same posterior, prior and
statistics, `fit_svi` steps given JAX's batch indices (a fixed step and
the Robbins-Monro schedule), the minibatch sampler, and a long run that
finds three separated clusters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.conjugate import families as jfam
from mimo_tpu.distributions import gating as jgating
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.utils import data as jdata

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.conjugate import families as tfam
from mimo_tpu_torch.distributions import gating as tgating
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.utils.data import nan_mask, one_hot, sample_batch_indices

torch.set_num_threads(1)

TRUE_MU = np.array([[-4., 0.], [4., 0.], [0., 5.]])
N = 1200


@pytest.fixture(scope='module')
def gmm_x():
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(5),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), N)
    return x.astype(jnp.float64)


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(4)
    x = rng.uniform(-3, 3, (N, 1))
    y = np.sin(x) + 0.1 * rng.standard_normal((N, 1))
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


# -- the blends -------------------------------------------------------------------

FAMILIES = {
    'niw': (jfam.gaussian_family, tfam.gaussian_family, 'x'),
    'ng': (jfam.diag_gaussian_family, tfam.diag_gaussian_family, 'x'),
    'mnw': (jfam.linear_family, tfam.linear_family, 'xy'),
    'mng': (jfam.diag_linear_family, tfam.diag_linear_family, 'xy'),
    'hier': (lambda: jfam.hier_gaussian_family(nb_iter=5),
             lambda: tfam.hier_gaussian_family(5), 'x'),
    'tied-niw': (lambda: jfam.tied_family(jfam.gaussian_family()),
                 lambda: tfam.tied_family(tfam.gaussian_family()), 'x'),
    'tied-ng': (lambda: jfam.tied_family(jfam.diag_gaussian_family()),
                lambda: tfam.tied_family(tfam.diag_gaussian_family()), 'x'),
    'tied-mnw': (lambda: jfam.tied_family(jfam.linear_family()),
                 lambda: tfam.tied_family(tfam.linear_family()), 'xy'),
}


def _prior(name, k):
    from mimo_tpu.distributions import hierarchical, mng, mnw, ng, niw
    if name == 'hier':
        return hierarchical.HierTied.standard(k, 2, hyper_kappa=0.05,
                                              dtype=jnp.float64)
    if name in ('niw', 'tied-niw'):
        return niw.NIW.standard(k, 2, kappa=0.05, psi_scale=0.5,
                                dtype=jnp.float64)
    if name in ('ng', 'tied-ng'):
        return ng.NG.standard(k, 2, kappa=0.05, dtype=jnp.float64)
    if name in ('mnw', 'tied-mnw'):
        return mnw.MNW.standard(k, 1, 2, dtype=jnp.float64)
    return mng.MNG.standard(k, 1, 2, dtype=jnp.float64)


@pytest.mark.parametrize('name', list(FAMILIES))
def test_family_svi_blend_matches_jax(gmm_x, ilr_xy, name):
    """A posterior from the full data, then one blend toward a 200-point
    minibatch's statistics (scale 200 / N, step 0.3)."""
    make_j, make_t, kind = FAMILIES[name]
    fj, ft = make_j(), make_t()
    k = 4
    data = (gmm_x,) if kind == 'x' else ilr_xy
    r = np.random.default_rng(0).uniform(0.05, 1.0, (N, k))
    r = jnp.asarray(r / r.sum(-1, keepdims=True))
    prior = _prior(name, k)
    post = fj.update(prior, fj.suff_stats(data, r))
    batch = tuple(a[:200] for a in data)
    stats = fj.suff_stats(batch, r[:200])
    want = fj.svi_blend(post, prior, stats, 200 / N, 0.3)
    got = ft.svi_blend(conv(post), conv(prior), conv(stats), 200 / N, 0.3)
    leaves_close(got, want, 1e-8)


@pytest.mark.parametrize('cls', ['Dirichlet', 'StickBreaking'])
def test_gating_svi_blend_matches_jax(cls):
    rng = np.random.default_rng(1)
    prior_j = getattr(jgating, cls).standard(6, alpha=2.0, dtype=jnp.float64)
    post_j = prior_j.update(jnp.asarray(rng.uniform(0, 300, 6)))
    counts = jnp.asarray(rng.uniform(0, 40, 6))
    want = prior_j.svi_blend(post_j, counts, 0.1, 0.25)
    prior_t, post_t = conv(prior_j), conv(post_j)
    assert type(prior_t) is getattr(tgating, cls)
    got = prior_t.svi_blend(post_t, tt(counts), 0.1, 0.25)
    leaves_close(got, want, 1e-12)


def test_tied_affine_blend_raises_as_in_jax():
    from mimo_tpu.distributions import affine as jaff
    prior = jaff.TiedAffine.standard(3, 1, 1, dtype=jnp.float64)
    with pytest.raises(NotImplementedError):
        jfam.tied_affine_family().svi_blend(prior, prior, None, 0.1, 0.5)
    with pytest.raises(NotImplementedError):
        tfam.tied_affine_family().svi_blend(conv(prior), conv(prior), None,
                                            0.1, 0.5)
    m = BayesianILR.make(size=3, input_dim=1, output_dim=1, tied_affine=True,
                         dtype=torch.float64, device='cpu')
    x = torch.rand(300, 1, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        m.fit_svi((x, torch.sin(x)), maxiter=2, batch_size=32)


# -- fit_svi against JAX ------------------------------------------------------------

def jax_batches(key, n, batch_size, maxiter):
    """The batch indices JAX's fit_svi draws for `key` at each step."""
    _, k_loop = jax.random.split(jax.random.PRNGKey(key))
    return [tt(jdata.sample_batch_indices(jax.random.split(k)[0], n,
                                          batch_size))
            for k in jax.random.split(k_loop, maxiter)]


def make_pair(name, gmm_x, ilr_xy):
    if name == 'ilr':
        kw = dict(size=5, input_dim=1, output_dim=1, alpha=2.0, kappa=0.05)
        jm = JaxILR.make(dtype=jnp.float64, **kw)
        tm = BayesianILR.make(dtype=torch.float64, device='cpu', **kw)
        x, y = ilr_xy
        jm.init_transform(x, y)
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (x, y), (tt(x), tt(y))
    kw = dict(size=5, gating='dp', kappa=0.05, psi_scale=0.5)
    jm = JaxGMM.make(dim=2, dtype=jnp.float64, **kw)
    tm = BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw)
    return jm, tm, gmm_x, tt(gmm_x)


@pytest.mark.parametrize('schedule', ['fixed', 'robbins-monro'])
@pytest.mark.parametrize('name', ['dpgmm', 'ilr'])
def test_fit_svi_steps_match_jax(monkeypatch, gmm_x, ilr_xy, name, schedule):
    jm, tm, dj, dt = make_pair(name, gmm_x, ilr_xy)
    init, _ = jm.fit_vi(dj, key=0, maxiter=2)
    kw = dict(maxiter=3, step_size=0.4, batch_size=64, track_elbo=True)
    if schedule == 'robbins-monro':
        kw.update(step_size=1.0, forgetting=0.7, delay=2.0)
    batches = iter(jax_batches(3, N, 64, 3))
    monkeypatch.setattr(tmix, 'sample_batch_indices',
                        lambda *a, **k: next(batches))
    st_j, v_j = jm.fit_svi(dj, key=3, init_state=init, randomize=False, **kw)
    st_t, v_t = tm.fit_svi(dt, key=3, init_state=conv(init), randomize=False,
                           **kw)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)


def test_fit_svi_finds_three_separated_clusters():
    from mimo_tpu_torch.distributions.niw import GaussParams
    far = torch.tensor([[-8., 0.], [8., 0.], [0., 10.]], dtype=torch.float64)
    x, _ = BayesianGMM.generate(
        torch.Generator().manual_seed(100),
        GaussParams(far, torch.eye(2, dtype=torch.float64).expand(3, 2, 2)
                    * 2.0), [.3, .4, .3], N)
    tm = BayesianGMM.make(size=6, dim=2, gating='dp', kappa=0.05,
                          psi_scale=0.5, dtype=torch.float64, device='cpu')
    st, vlb = tm.fit_svi(x, key=0, maxiter=200, step_size=0.5,
                         batch_size=128)
    assert vlb.shape == (200,) and bool((vlb == 0).all())
    for leaf in jax.tree.leaves(state_to_numpy(st)):
        assert np.isfinite(leaf).all()
    w = st.gating.mean().numpy()
    assert np.sort(w)[-3:].sum() >= 0.9, w
    mus = st.components.mu.numpy()[np.argsort(w)[-3:]]
    for t in far.numpy():
        assert np.min(np.linalg.norm(mus - t, axis=-1)) < 0.5


# -- data helpers ----------------------------------------------------------------

def test_sample_batch_indices_replacement_rule():
    gen = torch.Generator().manual_seed(0)
    small = sample_batch_indices(gen, 1000, 100)       # a permutation's head
    assert small.shape == (100,) and len(set(small.tolist())) == 100
    big = sample_batch_indices(gen, 10_000_000, 256)   # with replacement
    assert big.shape == (256,) and int(big.min()) >= 0
    assert int(big.max()) < 10_000_000
    forced = sample_batch_indices(gen, 50, 50, replace=False)
    assert sorted(forced.tolist()) == list(range(50))
    again = sample_batch_indices(torch.Generator().manual_seed(0), 1000, 100)
    assert torch.equal(again, small)


def test_one_hot_and_nan_mask_match_jax():
    lab = np.array([0, 2, 1, 2, 0])
    np.testing.assert_array_equal(
        one_hot(tt(lab), 3, torch.float64).numpy(),
        np.asarray(jdata.one_hot(jnp.asarray(lab), 3, jnp.float64)))
    a = np.array([[1.0, np.nan], [2.0, 3.0], [4.0, 5.0]])
    b = np.array([[1.0], [np.nan], [2.0]])
    (ca, cb), w = nan_mask(tt(a), tt(b))
    (ja, jb), jw = jdata.nan_mask(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ca.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jb))
    single, w1 = nan_mask(tt(a))
    assert single.shape == (3, 2) and w1.tolist() == [0.0, 1.0, 1.0]
