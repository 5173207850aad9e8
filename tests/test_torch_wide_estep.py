"""B1 and B2's plain versions and the fused engines at the shapes past the
kernels' plain layout (on the card they run csrc/tc.cuh's streamed
layout), against mimo_tpu on the CPU in float64: the Gauss map at d=16,
K=128 and d=32, K=256 (the fed cells of bench.py:296-312), the diagonal
map at d=32, K=256 and the ILR map at d=16, p=1 (m8 = 584).

  * B1's plain version (through fused_estep_cuda on CPU tensors) against
    JAX's blockwise XLA E-step at the same posterior: rtol 1e-8 (the two
    sum the same float64 products in other orders);
  * B2's plain version: its one-hot statistics against JAX's feature map
    and unpack applied to the same labels (rtol 1e-10), its plug-in theta
    against JAX's;
  * fit_vi_fused from JAX's one-sweep state (randomize=False),
    fit_map_fused and fit_em_fused from JAX's random start and anchors, 3
    sweeps each: traces and states at rtol 1e-8;
  * log_predictive of the d=32, K=256 VI state: rtol 1e-9.

N is 1200 to 1500, so each case runs in seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.mnw import MNW as JMNW
from mimo_tpu.distributions.ng import NG as JNG
from mimo_tpu.distributions.niw import NIW as JNIW
from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.ops import family_estep as jfe

import mimo_tpu_torch.conjugate.families as tfam
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.models import gmm as tgmm
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs
from mimo_tpu_torch.ops import family_estep as tfe

torch.set_num_threads(1)

# name -> (map, d, p, K); every one past the plain layout of B1/B2
CASES = {
    'gauss16': ('gauss', 16, 0, 128),
    'gauss32': ('gauss', 32, 0, 256),
    'diag32': ('diag', 32, 0, 256),
    'ilr16': ('ilr', 16, 1, 50),
}
N = 1500


def _psd(rng, k, d, scale):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _problem(name, n=N, seed=0):
    """Points and a posterior with the scales of a fit at N ~ 1e3, as
    numpy arrays for both packages: (data, spec pair, JAX posterior,
    port posterior, log_pi)."""
    kind, d, p, k = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * 2
    log_pi = np.log(rng.dirichlet(np.ones(k) * 3))
    if kind == 'gauss':
        post = dict(mu=rng.standard_normal((k, d)) * 2,
                    kappa=rng.uniform(1, 5, k), psi=_psd(rng, k, d, 0.1),
                    nu=rng.uniform(d + 2, d + 8, k))
        specs = jfe.gaussian_spec(), tfe.gaussian_spec()
        jpost = JNIW(**{f: jnp.asarray(v) for f, v in post.items()})
        tpost = NIW(**{f: torch.as_tensor(v) for f, v in post.items()})
        data = (x,)
    elif kind == 'diag':
        post = dict(mu=rng.standard_normal((k, d)) * 2,
                    kappa=rng.uniform(1, 5, (k, d)),
                    alpha=rng.uniform(2, 6, (k, d)),
                    beta=rng.uniform(0.5, 2, (k, d)))
        specs = jfe.diag_gaussian_spec(), tfe.diag_gaussian_spec()
        jpost = JNG(**{f: jnp.asarray(v) for f, v in post.items()})
        tpost = NG(**{f: torch.as_tensor(v) for f, v in post.items()})
        data = (x,)
    else:
        x = rng.uniform(-2, 2, (n, d))
        y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal(
            (n, p))
        q = d + 1
        niw = dict(mu=rng.standard_normal((k, d)),
                   kappa=rng.uniform(50, 300, k), psi=_psd(rng, k, d, 0.02),
                   nu=rng.uniform(50, 300, k))
        mnw = dict(M=rng.standard_normal((k, p, q)),
                   K_=_psd(rng, k, q, 80.0), psi=_psd(rng, k, p, 0.05),
                   nu=rng.uniform(50, 300, k))
        specs = jfe.ilr_spec(d, p), tfe.ilr_spec(d, p)
        jpost = (JNIW(**{f: jnp.asarray(v) for f, v in niw.items()}),
                 JMNW(**{f: jnp.asarray(v) for f, v in mnw.items()}))
        tpost = (NIW(**{f: torch.as_tensor(v) for f, v in niw.items()}),
                 MNW(**{f: torch.as_tensor(v) for f, v in mnw.items()}))
        data = (x, y)
    return data, specs, jpost, tpost, log_pi


def _past_plain_layout(k, m8):
    """Whether B1/B2 run (K, m8) past their plain layout (csrc/tc.cuh):
    m8 past the widest compiled width, or K's 16-row slabs past a block's
    warps (16 up to m8 = 64, else 8)."""
    return m8 > 256 or -(-k // 16) > (16 if m8 <= 64 else 8)


def _close_tree(got, want, rtol, atol=0.0):
    """Leaf by leaf, in field order, rtol with an absolute floor of rtol
    x the leaf's largest magnitude (and `atol`)."""
    got, want = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=rtol,
            atol=max(atol, rtol * float(np.abs(b).max(initial=0.0))))


def _xts(data):
    return tuple(torch.as_tensor(a.T.copy()) for a in data)


@pytest.mark.parametrize('name', list(CASES))
def test_b1_plain_matches_jax_blockwise_f64(name):
    """B1's plain version past the plain layout, over the kernels' (d_i,
    N) layout, against JAX's fused blockwise E-step in float64."""
    data, (js, ts), jpost, tpost, log_pi = _problem(name)
    m8 = -(-ts.theta(tpost).shape[-1] // 8) * 8
    assert _past_plain_layout(CASES[name][3], m8)
    want = jfe.fused_estep_blockwise(js, jpost, jnp.asarray(log_pi),
                                     tuple(jnp.asarray(a) for a in data),
                                     500)
    got = cuda_estep.fused_estep_cuda(ts, tpost, torch.as_tensor(log_pi),
                                      _xts(data), N)
    _close_tree(got.stats, want.stats, rtol=1e-8)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-10)


@pytest.mark.parametrize('name', list(CASES))
def test_b2_plain_one_hot_stats_match_jax_f64(name):
    """B2's plain version past the plain layout: labels in range and its
    statistics equal to JAX's feature map and unpack over the one-hot of
    the same labels."""
    data, (js, ts), _, tpost, log_pi = _problem(name, seed=1)
    fam = {'gauss': tfam.gaussian_family, 'diag': tfam.diag_gaussian_family,
           'ilr': tfam.ilr_family}[CASES[name][0]]()
    params = fam.mode_params(tpost)
    seed = torch.tensor(20240917, dtype=torch.int64)
    labels, res = cuda_gibbs.fused_gibbs_cuda(
        ts, seed, params, torch.as_tensor(log_pi), _xts(data), N)
    k = CASES[name][3]
    lab = labels.numpy()
    assert lab.shape == (N,) and lab.min() >= 0 and lab.max() < k
    feats = js.features(tuple(jnp.asarray(a) for a in data))
    acc = jax.nn.one_hot(jnp.asarray(lab), k, dtype=jnp.float64).T @ feats
    _close_tree(res.stats, js.unpack(acc), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(res.counts.numpy(),
                                  np.bincount(lab, minlength=k))


@pytest.mark.parametrize('name', ['gauss16', 'gauss32'])
def test_theta_plugin_matches_jax(name):
    _, (js, ts), _, tpost, _ = _problem(name, n=10, seed=2)
    params = tfam.gaussian_family().mode_params(tpost)
    want = js.theta_plugin(JParams(jnp.asarray(params.mu.numpy()),
                                   jnp.asarray(params.lmbda.numpy())))
    np.testing.assert_allclose(ts.theta_plugin(params).numpy(),
                               np.asarray(want), rtol=1e-10, atol=1e-10)


# -- the fused engines ----------------------------------------------------------

FITS = {'gauss16': (16, 128), 'gauss32': (32, 256)}
N_FIT = 1200


def _fit_data(d, seed=7):
    """bench.py:90-98's mixture at d: 3 clusters, centres 4 N(0, I),
    precision 2 I, weights .3 / .4 / .3."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((3, d)) * 4.0
    lab = rng.choice(3, N_FIT, p=[.3, .4, .3])
    return mu[lab] + rng.standard_normal((N_FIT, d)) * np.sqrt(0.5)


def _models(d, k):
    kw = dict(size=k, dim=d, gating='dp', alpha=1.0, kappa=0.05,
              psi_scale=0.5)
    return (JaxGMM.make(dtype=jnp.float64, **kw),
            BayesianGMM.make(dtype=torch.float64, device='cpu', **kw))


@pytest.fixture(scope='module')
def vi_starts():
    """Per fit shape: (data, JAX's state after one fused VI sweep)."""
    out = {}
    for name, (d, k) in FITS.items():
        x = jnp.asarray(_fit_data(d))
        jm, _ = _models(d, k)
        st, _ = jm.fit_vi_fused(x, key=1, maxiter=1, backend='xla',
                                block_size=400)
        out[name] = (x, st)
    return out


@pytest.mark.parametrize('name', list(FITS))
def test_vi_fused_from_jax_state_matches_jax_f64(name, vi_starts):
    d, k = FITS[name]
    jm, tm = _models(d, k)
    x, init = vi_starts[name]
    st_j, v_j = jm.fit_vi_fused(x, maxiter=3, init_state=init,
                                randomize=False, backend='xla',
                                block_size=400)
    st_t, v_t = tm.fit_vi_fused(torch.as_tensor(np.array(x)), maxiter=3,
                                init_state=state_from_numpy(
                                    jax.tree.map(np.asarray, init)),
                                randomize=False, block_size=400)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _close_tree(st_t, st_j, rtol=1e-8)


@pytest.mark.parametrize('engine', ['fit_map_fused', 'fit_em_fused'])
@pytest.mark.parametrize('name', list(FITS))
def test_plugin_fits_match_jax_f64(monkeypatch, name, engine):
    """MAP-EM and ML-EM through B1's plug-in theta from JAX's random
    responsibilities and anchors for key 1 (their random streams cannot
    match)."""
    d, k = FITS[name]
    jm, tm = _models(d, k)
    x = jnp.asarray(_fit_data(d, seed=8))
    jkey = jax.random.PRNGKey(1)
    resp = torch.as_tensor(np.asarray(
        jmix._random_resp(jkey, N_FIT, k, jnp.float64)))
    idx = torch.as_tensor(np.asarray(
        jax.random.choice(jkey, N_FIT, (k,), replace=False)))
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: resp.clone())
    monkeypatch.setattr(tgmm, '_random_resp', lambda *a: resp.clone())
    monkeypatch.setattr(tmix, '_anchor_indices', lambda *a: idx.clone())
    st_j, ll_j = getattr(jm, engine)(x, key=1, maxiter=3, backend='xla',
                                     block_size=400)
    st_t, ll_t = getattr(tm, engine)(torch.as_tensor(np.array(x)), key=1,
                                     maxiter=3, block_size=400)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-8)
    _close_tree(st_t, st_j, rtol=1e-8)


def test_log_predictive_d32_k256_matches_jax_f64(vi_starts):
    """B3's plain path at d=32, K=256 (the padded width 32 on the card)
    from the same VI state."""
    d, k = FITS['gauss32']
    jm, tm = _models(d, k)
    x, st = vi_starts['gauss32']
    for dist in ('studentt', 'gaussian'):
        want = jm.log_predictive(st, x, dist=dist)
        got = tm.log_predictive(state_from_numpy(jax.tree.map(np.asarray,
                                                              st)),
                                torch.as_tensor(np.array(x)), dist=dist)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9)
