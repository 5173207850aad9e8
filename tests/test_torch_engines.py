"""The port's dense engines and model glue against mimo_tpu on the CPU, in
float64: `fit_vi` from a shared start (with and without `tol`, with
point weights), `elbo`, `used_labels`, `nb_params`, `with_priors`; the
deterministic pieces of the dense Gibbs sweep, the categorical sampler's
frequencies and `fit_gibbs` on separated clusters (tied: the exact shared
draw); the ILR's `predictive_activation` and the fitted models' `sample`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.models.mixture import GibbsState
from mimo_tpu_torch.utils.stats import sample_categorical_from_log

torch.set_num_threads(1)

TRUE_MU = np.array([[-4., 0.], [4., 0.], [0., 5.]])
N = 1200


@pytest.fixture(scope='module')
def gmm_x():
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(9),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), N)
    return x.astype(jnp.float64)


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(6)
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


def shared_resp(monkeypatch, key, n, k):
    resp = tt(jmix._random_resp(jax.random.PRNGKey(key), n, k, jnp.float64))
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: resp.clone())


GMM_KW = dict(size=5, gating='dp', kappa=0.05, psi_scale=0.5)


def gmm_pair(**extra):
    kw = dict(GMM_KW, **extra)
    return (JaxGMM.make(dim=2, dtype=jnp.float64, **kw),
            BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw))


def ilr_pair(ilr_xy, **extra):
    kw = dict(size=6, input_dim=1, output_dim=1, alpha=2.0, kappa=0.05,
              **extra)
    jm = JaxILR.make(dtype=jnp.float64, **kw)
    tm = BayesianILR.make(dtype=torch.float64, device='cpu', **kw)
    x, y = ilr_xy
    jm.init_transform(x, y)
    tm.init_transform(tt(x), tt(y))
    return jm, tm


# -- dense VI -----------------------------------------------------------------------

@pytest.mark.parametrize('variant', ['plain', 'tol', 'weights', 'ilr'])
def test_fit_vi_matches_jax(monkeypatch, gmm_x, ilr_xy, variant):
    if variant == 'ilr':
        jm, tm = ilr_pair(ilr_xy)
        dj, dt = ilr_xy, (tt(ilr_xy[0]), tt(ilr_xy[1]))
    else:
        jm, tm = gmm_pair()
        dj, dt = gmm_x, tt(gmm_x)
    shared_resp(monkeypatch, 1, N, tm.size)
    kw = dict(key=1, maxiter=10)
    if variant == 'tol':
        _, full = jm.fit_vi(dj, key=1, maxiter=10)
        kw['tol'] = float(np.abs(np.diff(np.asarray(full)))[4]) * 1.01
    if variant == 'weights':
        w = np.random.default_rng(2).uniform(0, 1, N)
        w[::7] = 0.0
        st_j, v_j = jm.fit_vi(dj, point_weights=jnp.asarray(w), **kw)
        st_t, v_t = tm.fit_vi(dt, point_weights=tt(w), **kw)
    else:
        st_j, v_j = jm.fit_vi(dj, **kw)
        st_t, v_t = tm.fit_vi(dt, **kw)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)
    if variant == 'tol':
        assert v_t[-1] == v_t[-2]           # stopped, constant-extended


def test_fit_vi_warm_start_and_elbo_match_jax(gmm_x):
    jm, tm = gmm_pair()
    init, _ = jm.fit_vi(gmm_x, key=0, maxiter=3)
    st_j, v_j = jm.fit_vi(gmm_x, maxiter=4, init_state=init, randomize=False)
    st_t, v_t = tm.fit_vi(tt(gmm_x), maxiter=4, init_state=conv(init),
                          randomize=False)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)
    resp = jm.expected_responsibilities(init, (gmm_x,))
    np.testing.assert_allclose(
        tm.expected_responsibilities(conv(init), (tt(gmm_x),)).numpy(),
        np.asarray(resp), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(
        float(tm.elbo(conv(init), (tt(gmm_x),), tt(resp))),
        float(jm.elbo(init, (gmm_x,), resp)), rtol=1e-10)
    np.testing.assert_allclose(
        tm.expected_log_complete(conv(init), (tt(gmm_x),)).numpy(),
        np.asarray(jm.expected_log_complete(init, (gmm_x,))), rtol=1e-10)


# -- model utilities ----------------------------------------------------------------

def test_used_labels_nb_params_and_with_priors_match_jax(gmm_x, ilr_xy):
    jm, tm = gmm_pair()
    st, _ = jm.fit_vi(gmm_x, key=0, maxiter=15)
    np.testing.assert_array_equal(
        tm.used_labels(conv(st), tt(gmm_x), threshold=10).numpy(),
        np.asarray(jm.used_labels(st, gmm_x, threshold=10)))
    cases = [gmm_pair(), gmm_pair(diag=True), gmm_pair(tied=True),
             ilr_pair(ilr_xy), ilr_pair(ilr_xy, diag=True)]
    for j, t in cases:
        assert t.nb_params == j.nb_params
    for j, t in (gmm_pair(hierarchical=True),
                 ilr_pair(ilr_xy, tied_affine=True, hier_basis=True)):
        for model in (j, t):
            with pytest.raises(NotImplementedError):
                model.nb_params
    jr, tr = jm.with_priors(st), tm.with_priors(conv(st))
    assert type(tr) is BayesianGMM and tr.tied == tm.tied
    leaves_close(tr.components_prior, jr.components_prior, 0)
    leaves_close(tr.gating_prior, jr.gating_prior, 0)
    ji, ti = ilr_pair(ilr_xy)
    sti, _ = ji.fit_vi(ilr_xy, key=0, maxiter=3)
    tri = ti.with_priors(conv(sti))
    assert tri.input_transform is ti.input_transform and tri.affine


# -- dense Gibbs --------------------------------------------------------------------

@pytest.mark.parametrize('name', ['dpgmm', 'diag', 'ilr'])
def test_gibbs_sweep_deterministic_pieces_match_jax(gmm_x, ilr_xy, name):
    """Given labels, the sweep's conditional posteriors are deterministic
    (the plain update of the one-hot statistics); given the params it
    drew, its log p(x, z) and data log-likelihood are too."""
    if name == 'ilr':
        jm, tm = ilr_pair(ilr_xy)
        dj = (jm._tx(ilr_xy[0]), jm._ty(ilr_xy[1]))
    else:
        jm, tm = gmm_pair(diag=(name == 'diag'))
        dj = (gmm_x,)
    dt = tuple(tt(a) for a in dj)
    labels = np.random.default_rng(3).integers(0, tm.size, N)
    lab_j = jnp.asarray(labels, jnp.int32)
    start_j = jmix.GibbsState(
        components=jm.components_prior, gating=jm.gating_prior,
        params=jm.family.mode_params(jm.components_prior),
        log_pi=jnp.full((jm.size,), -np.log(jm.size)), labels=lab_j)
    new_j, _ = jm._gibbs_sweep(start_j, dj, jax.random.PRNGKey(0))
    new_t, loglik = tm._gibbs_sweep(conv(start_j), dt,
                                    torch.Generator().manual_seed(0))
    leaves_close(new_t.components, new_j.components, 1e-10)
    leaves_close(new_t.gating, new_j.gating, 1e-12)
    assert new_t.labels.dtype == torch.int32
    assert int(new_t.labels.min()) >= 0 and int(new_t.labels.max()) < tm.size
    params_j = jax.tree.map(jnp.asarray, state_to_numpy(new_t.params))
    log_pi_j = jnp.asarray(new_t.log_pi.numpy())
    want = jm.log_complete_likelihood(params_j, log_pi_j, dj)
    got = tm.log_complete_likelihood(new_t.params, new_t.log_pi, dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(
        float(loglik),
        float(jnp.sum(jax.scipy.special.logsumexp(want, axis=-1))),
        rtol=1e-12)


def test_categorical_sampler_frequencies_match_the_softmax():
    gen = torch.Generator().manual_seed(4)
    logits = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0],
                           [2.0, -1.0, 0.5, 0.0, -3.0],
                           [-30.0, -31.0, -29.5, -40.0, -30.2],
                           [5.0, 5.0, -5.0, 0.0, 1.0]], dtype=torch.float64)
    reps = 1 << 15
    lab = sample_categorical_from_log(gen, logits.repeat_interleave(reps, 0))
    assert lab.dtype == torch.int64 and lab.shape == (4 * reps,)
    p = torch.softmax(logits, -1)
    for i in range(4):
        cnt = torch.bincount(lab[i * reps:(i + 1) * reps], minlength=5)
        sigma = torch.sqrt(reps * p[i] * (1 - p[i]))
        assert bool(((cnt - reps * p[i]).abs() <= 5 * sigma + 1).all()), i


@pytest.mark.parametrize('tied', [False, True], ids=['full', 'tied'])
def test_fit_gibbs_recovers_three_clusters(gmm_x, tied):
    tm = BayesianGMM.make(size=6, dim=2, gating='dp', kappa=0.05,
                          psi_scale=0.5, tied=tied, dtype=torch.float64,
                          device='cpu')
    # a blocked chain can keep two clusters merged for many sweeps (the
    # JAX package's does too, at other keys): one fixed key
    gs, ll = tm.fit_gibbs(tt(gmm_x), key=1, maxiter=60, track_loglik=True)
    assert ll.shape == (60,) and bool(torch.isfinite(ll).all())
    assert gs.labels.shape == (N,) and gs.labels.dtype == torch.int32
    counts = np.bincount(gs.labels.numpy(), minlength=6)
    big = np.nonzero(counts >= 0.2 * N)[0]
    assert len(big) == 3, counts
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(gs.params.mu.numpy()[big] - t,
                                     axis=-1)) < 0.5
    if tied:    # the exact tied draw: one shared precision over K
        lm = gs.params.lmbda
        assert torch.equal(lm, lm[:1].expand(lm.shape))
        np.testing.assert_allclose(lm[0].numpy(), 2.0 * np.eye(2), atol=0.4)
    again = tm.fit_gibbs(tt(gmm_x), key=1, maxiter=60)
    assert torch.equal(again.labels, gs.labels)
    more = tm.fit_gibbs(tt(gmm_x), key=3, maxiter=2, init_state=gs,
                        init_labels='random')
    assert isinstance(more, GibbsState)


# -- ILR glue and sampling --------------------------------------------------------

def test_predictive_activation_matches_jax(ilr_xy):
    jm, tm = ilr_pair(ilr_xy)
    st, _ = jm.fit_vi(ilr_xy, key=0, maxiter=5)
    x = ilr_xy[0][:300]
    want = jm.predictive_activation(st, x)
    got = tm.predictive_activation(conv(st), tt(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize('params', ['mode', 'mean', 'draw'])
def test_gmm_sample_shapes_and_moments(params):
    mu = torch.tensor(TRUE_MU, dtype=torch.float64)
    from mimo_tpu_torch.distributions.niw import NIW
    from mimo_tpu_torch.distributions.gating import Dirichlet
    tm = BayesianGMM.make(size=3, dim=2, dtype=torch.float64, device='cpu')
    post = NIW(mu=mu, kappa=torch.full((3,), 1e4, dtype=torch.float64),
               psi=torch.eye(2, dtype=torch.float64).expand(3, 2, 2) * 1e-3,
               nu=torch.full((3,), 2002.0, dtype=torch.float64))
    gating = Dirichlet(alpha=torch.tensor([3000., 4000., 3000.],
                                          dtype=torch.float64))
    x, z = tm.sample(tmix.MFState(post, gating), key=5, n=20000,
                     params=params)
    assert x.shape == (20000, 2) and z.shape == (20000,)
    np.testing.assert_allclose(np.bincount(z.numpy(), minlength=3) / 20000,
                               [.3, .4, .3], atol=0.02)
    for k in range(3):
        xk = x[z == k].numpy()
        np.testing.assert_allclose(xk.mean(0), TRUE_MU[k], atol=0.1)
        # precision (nu - d) psi ~ 2 I at the mode: variance ~ 0.5
        np.testing.assert_allclose(xk.var(0), 0.5, rtol=0.1)
    diag = BayesianGMM.make(size=3, dim=2, diag=True, dtype=torch.float64,
                            device='cpu')
    sd, _ = diag.fit_vi(x, key=0, maxiter=20)
    xd, zd = diag.sample(sd, key=1, n=500, params=params)
    assert xd.shape == (500, 2) and bool(torch.isfinite(xd).all())


def test_ilr_sample_is_in_original_units(ilr_xy):
    _, tm = ilr_pair(ilr_xy)
    x, y = tt(ilr_xy[0]) * 10.0 + 50.0, tt(ilr_xy[1]) * 3.0
    tm.init_transform(x, y)
    gs = tm.fit_gibbs((x, y), key=1, maxiter=30)
    st, _ = tm.fit_vi((x, y), maxiter=30, randomize=False,
                      init_state=tmix.MFState(gs.components, gs.gating))
    xs, ys, zs = tm.sample(st, key=2, n=20000)
    assert xs.shape == (20000, 1) and ys.shape == (20000, 1)
    assert zs.shape == (20000,)
    np.testing.assert_allclose(float(xs.mean()), float(x.mean()), atol=1.5)
    np.testing.assert_allclose(float(xs.std()), float(x.std()), rtol=0.1)
    # y follows 3 sin((x - 50) / 10) to within the noise and the fit
    resid = ys[:, 0] - 3.0 * torch.sin((xs[:, 0] - 50.0) / 10.0)
    inside = (xs[:, 0] > 25.0) & (xs[:, 0] < 75.0)
    assert float(resid[inside].abs().mean()) < 0.6
