"""The port's main path as a whole against mimo_tpu, on the CPU: fused VI
from a shared initial state (float64, rtol 1e-8 on the ELBO trace and the
posterior), the `tol` early stop, the predictive of the fitted state, and
a fused Gibbs run that recovers the generating clusters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.distributions.niw import GaussParams
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.models.mixture import _elbo_loop
from mimo_tpu_torch.utils.sanitize import finite_report

torch.set_num_threads(1)

TRUE_MU = np.array([[-3., 0.], [3., 0.], [0., 4.]])


@pytest.fixture(scope='module')
def setup():
    """The data of tests/test_pallas.py::_spec_problem (N=4096, K=8, d=2,
    DP gating) in float64, and a JAX VI state after 2 sweeps."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray(TRUE_MU), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float64)
    jm = JaxGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                     psi_scale=0.5, dtype=jnp.float64)
    init, _ = jm.fit_vi_fused(x, key=1, maxiter=2, backend='xla')
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                          psi_scale=0.5, dtype=torch.float64, device='cpu')
    return jm, tm, x, init


def _assert_tree_close(got, want, rtol):
    got = state_to_numpy(got)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if hasattr(w, '_fields'):
            _assert_tree_close(g, w, rtol)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                       atol=1e-9)


@pytest.mark.parametrize('backend', ['auto', 'torch'])
def test_vi_fused_matches_jax_f64(setup, backend):
    jm, tm, x, init = setup
    st_j, v_j = jm.fit_vi_fused(x, maxiter=10, init_state=init,
                                randomize=False, backend='xla')
    st_t, v_t = tm.fit_vi_fused(torch.tensor(np.asarray(x)), maxiter=10,
                                init_state=state_from_numpy(
                                    jax.tree.map(np.asarray, init)),
                                randomize=False, backend=backend,
                                block_size=1000)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _assert_tree_close(st_t, st_j, rtol=1e-8)
    assert bool((torch.diff(v_t) > -1e-6).all())


def test_vi_tol_stops_where_jax_does(setup):
    jm, tm, x, init = setup
    _, full = jm.fit_vi_fused(x, maxiter=40, init_state=init,
                              randomize=False, backend='xla')
    d = np.abs(np.diff(np.asarray(full)))
    # the first two sweeps move little here, so a tol just below their
    # step fires late in the trace instead of at sweep 2
    tol = float(d[0]) * 0.99
    _, v_j = jm.fit_vi_fused(x, maxiter=40, init_state=init, randomize=False,
                             backend='xla', tol=tol)
    _, v_t = tm.fit_vi_fused(torch.tensor(np.asarray(x)), maxiter=40,
                             init_state=state_from_numpy(
                                 jax.tree.map(np.asarray, init)),
                             randomize=False, tol=tol)
    v_j = np.asarray(v_j)
    stop = int(np.argmax(np.diff(v_j) == 0.0)) + 1
    assert 2 < stop < 40
    assert np.all(v_t.numpy()[stop:] == v_t.numpy()[stop - 1])
    assert v_t.numpy()[stop - 1] != v_t.numpy()[stop - 2]
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=1e-8)


def test_elbo_loop_tol_none_runs_every_sweep():
    carry, trace = _elbo_loop(lambda c, i: (c + 1, torch.tensor(1.0)), 0, 5,
                              None)
    assert carry == 5 and trace.tolist() == [1.0] * 5
    # a NaN ELBO never counts as converged
    carry, trace = _elbo_loop(
        lambda c, i: (c + 1, torch.tensor(float('nan'))), 0, 6, 1e9)
    assert carry == 6


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_log_predictive_of_fitted_state_matches_jax(setup, dist):
    jm, tm, x, init = setup
    want = jm.log_predictive(init, x, dist=dist, backend='xla')
    got = tm.log_predictive(state_from_numpy(jax.tree.map(np.asarray, init)),
                            torch.tensor(np.asarray(x)), dist=dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)


def test_gibbs_fused_recovers_clusters():
    gen = torch.Generator().manual_seed(0)
    lm = torch.eye(2).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(
        gen, GaussParams(torch.as_tensor(TRUE_MU, dtype=torch.float32), lm),
        [.3, .4, .3], 4096)
    tm = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                          psi_scale=0.5, device='cpu')
    gs = tm.fit_gibbs_fused(x, key=2, maxiter=20, block_size=1024)
    for leaf in (gs.components.mu, gs.components.psi, gs.log_pi,
                 gs.params.lmbda):
        assert bool(torch.isfinite(leaf).all())
    assert gs.labels.shape == (4096,) and gs.labels.dtype == torch.int32
    counts = np.bincount(gs.labels.numpy(), minlength=8)
    big = np.nonzero(counts >= 0.2 * 4096)[0]
    assert len(big) == 3, counts
    mus = gs.components.mu.numpy()[big]
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(mus - t, axis=-1)) < 0.5
    # the same seed gives the same chain
    again = tm.fit_gibbs_fused(x, key=2, maxiter=20, block_size=4096)
    np.testing.assert_array_equal(again.labels.numpy(), gs.labels.numpy())


def test_vi_random_init_is_seeded_and_finite():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((500, 2)))
    tm = BayesianGMM.make(size=4, dim=2, gating='dirichlet',
                          dtype=torch.float64, device='cpu')
    _, v1 = tm.fit_vi_fused(x, key=3, maxiter=5)
    _, v2 = tm.fit_vi_fused(x, key=torch.Generator().manual_seed(3),
                            maxiter=5)
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    assert bool(torch.isfinite(v1).all())


def test_finite_report_raises_when_asked(monkeypatch, setup):
    _, tm, _, init = setup
    st = state_from_numpy(jax.tree.map(np.asarray, init))
    bad = st._replace(components=st.components._replace(
        mu=st.components.mu * float('nan')))
    trace = torch.tensor([1.0, float('nan')])
    monkeypatch.delenv('MIMO_TPU_CHECK_FINITE', raising=False)
    assert finite_report((bad, trace), 'fit_vi_fused')[0] is bad
    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', 'raise')
    with pytest.raises(FloatingPointError, match='sweep 1'):
        finite_report((bad, trace), 'fit_vi_fused')
    assert finite_report((st, trace[:1]), 'fit_vi_fused')[0] is st
