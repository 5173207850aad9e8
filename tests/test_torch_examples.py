"""The port's example drivers (mimo_tpu_torch/examples/) on the CPU,
in-process through main([... '--cpu', small sizes]).

The deterministic drivers are held to the JAX package at float64 on the
same numpy-drawn inputs: gauss's NIW posterior, MAP covariance,
predictive log-density and log marginal likelihood; lingauss's MNW, MNG
and tied-affine posteriors and predictive (rtol 1e-8); dp_sticks's
analytic expected weights. The stochastic drivers draw their data from a
torch.Generator where JAX's draw from jax.random, so they are held by
recovery checks and their own checks. Also: the --cpu / card rule, --x64,
--plot without matplotlib, `python -m`, and that no driver imports jax.
"""

import builtins
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu_torch.examples import (
    DRIVERS, chains_smc, dp_sticks, dpgmm, gauss, gmm_toy, hgmm, hilr,
    ilr_sinc_study, ilr_sine, lingauss, stream_svi)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEED = 1337
X64 = ['--cpu', '--x64']


def close(got, want, rtol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def within(found, true, tol):
    """Every true centre within `tol` of a found one."""
    found, true = np.asarray(found), np.asarray(true)
    dist = np.linalg.norm(true[:, None] - found[None], axis=-1).min(1)
    assert dist.max() < tol, (dist, found)


def all_finite(res):
    for v in res.values():
        assert np.isfinite(np.asarray(v, np.float64)).all(), res


# -- deterministic drivers, against JAX at float64 ------------------------

def test_gauss_matches_jax():
    from mimo_tpu.distributions import niw
    from mimo_tpu.distributions.niw import NIW
    res = gauss.main(X64)
    rng = np.random.default_rng(SEED)
    x = jnp.asarray(rng.multivariate_normal(
        [1.0, -2.0], [[1.0, 0.6], [0.6, 2.0]], 5000))
    prior = NIW.standard(1, 2, kappa=1e-2, psi_scale=1.0, dtype=jnp.float64)
    post = niw.posterior_update(prior, niw.suff_stats(
        x, jnp.ones((x.shape[0], 1), x.dtype)))
    close(res['posterior_mean'], post.mu[0])
    close(res['map_cov'], np.linalg.inv(np.asarray(
        niw.mode_params(post).lmbda[0])))
    close(res['logpdf'], niw.log_predictive_studentt(post, x[:5])[:, 0])
    close(res['log_marginal_likelihood'],
          niw.log_marginal_likelihood(prior, post, x.shape[0])[0])
    all_finite(res)


def test_lingauss_matches_jax():
    from mimo_tpu.distributions import affine, mng, mnw
    from mimo_tpu.distributions.affine import TiedAffine
    from mimo_tpu.distributions.mng import MNG
    from mimo_tpu.distributions.mnw import MNW, augment
    res = lingauss.main(X64)
    rng = np.random.default_rng(SEED)
    n, q, p = 2000, 3, 2
    true_a = rng.standard_normal((p, q))
    true_c = np.array([0.5, -1.0])
    x = jnp.asarray(rng.standard_normal((n, q)))
    y = jnp.asarray(np.asarray(x) @ true_a.T + true_c
                    + 0.1 * rng.standard_normal((n, p)))
    ones = jnp.ones((n, 1), x.dtype)
    xa = augment(x, True)
    stats = mnw.suff_stats(xa, y, ones)
    post = mnw.posterior_update(
        MNW.standard(1, p, q + 1, K_scale=1e-2, dtype=x.dtype), stats)
    est = np.asarray(post.M[0])
    close(res['mnw_M'], est)
    close(res['mnw_slope_error'], np.abs(est[:, :q] - true_a).max())
    close(res['mnw_offset_error'], np.abs(est[:, q] - true_c).max())
    close(res['mnw_logpdf'],
          mnw.log_predictive_studentt(post, xa[:3], y[:3])[:, 0])
    post_d = mng.posterior_update(
        MNG.standard(1, p, q + 1, K_scale=1e-2, dtype=x.dtype), stats)
    close(res['mng_noise_precisions'], post_d.alpha[0] / post_d.beta[0])
    post_a = affine.posterior_update(
        TiedAffine.standard(1, p, q, K_scale=1e-2, kappa=1e-2,
                            dtype=x.dtype),
        affine.suff_stats(x, y, ones), nb_iter=25)
    close(res['tied_M'], post_a.M)
    close(res['tied_offset'], post_a.mus[0])
    close(res['tied_slope_error'], np.abs(np.asarray(post_a.M)
                                          - true_a).max())
    assert res['mnw_slope_error'] < 0.01 and res['mnw_offset_error'] < 0.01


def test_dp_sticks_expected_weights_match_the_closed_form():
    """The analytic weights equal JAX's closed form at float64, and the
    Monte-Carlo mean of a run passes the driver's own check."""
    k, alpha = 200, 10.0
    rate = alpha / (1.0 + alpha)
    want = (1.0 / (1.0 + alpha)) * rate ** jnp.arange(k)
    close(dp_sticks.expected_weights(k, alpha), want, rtol=1e-12)
    res = dp_sticks.main(X64 + ['--k', str(k), '--draws', '2000'])
    close(res['theory'], want[:50], rtol=1e-12)
    assert res['max_abs_err'] < 5e-3
    all_finite(res)


# -- stochastic drivers: finite numbers, recovery, their own checks -------

@pytest.mark.parametrize('variant', ['full', 'diag', 'tied'])
def test_dpgmm_recovers_the_clusters(variant):
    extra = [] if variant == 'full' else [f'--{variant}']
    res = dpgmm.main(['--cpu', '--n', '3000'] + extra)
    all_finite(res)
    # the clusters' standard deviation is 0.71 and the means sit 4-5
    # apart; at N=3000 a DP fit may split a cluster in two, whose halves
    # then sit up to ~0.6 off its centre
    within(res['means'], res['true_means'], 0.75)
    assert 4 <= res['used'] <= 8
    assert res['gibbs_occupancy'].sum() == 3000


def test_gmm_toy_recovers_the_means():
    res = gmm_toy.main(['--cpu'])
    all_finite(res)
    within(res['em_means'], res['true_means'], 0.3)
    within(res['vi_means'], res['true_means'], 0.3)
    assert len(res['vi_means']) == 3


def test_ilr_sine_fits_the_sine():
    res = ilr_sine.main(['--cpu', '--svi_iters', '150'])
    all_finite(res)
    assert res['rmse'] < 0.22 and res['nlpd'] < -0.25, res


def test_ilr_sinc_study_passes_its_own_check():
    res = ilr_sinc_study.main(['--cpu', '--seeds', '2', '--svi_iters',
                               '150'])
    all_finite(res)
    assert res['rmse'].shape == (2,) and res['rmse_mean'] < 0.2


def test_hgmm_recovers_means_and_super_clusters():
    res = hgmm.main(['--cpu'])
    all_finite(res)
    within(res['means'], res['true_means'], 0.3)
    # every left-blob point in one super-cluster, as in the JAX driver's
    # run; the right blobs take the other one's majority
    left, right = res['left_labels'], res['right_labels']
    assert left.min() == 0 and left.sum() == 1600
    assert right[int(np.argmin(left))] > right[int(np.argmax(left))]


def test_hilr_fits_the_triangle_wave():
    res = hilr.main(['--cpu'])
    all_finite(res)
    # the wave's own standard deviation is 0.29; the tied-activation model
    # mixes slowly from its symmetric start (the JAX driver's run at these
    # settings reaches 0.23 on the CPU), the nested one fits it closely
    assert res['rmse'] < 0.25 and res['nested_rmse'] < 0.1, res


def test_chains_smc_runs_its_chains():
    res = chains_smc.main(['--cpu', '--chains', '4'])
    all_finite(res)
    assert res['vi_elbos'].shape == (4,)
    assert res['best_chain'] == int(np.argmax(res['vi_elbos']))
    assert res['smc_loglik'][-1] >= res['smc_loglik'][0]


def test_stream_svi_passes_its_own_checks():
    res = stream_svi.main(['--cpu', '--n', '50000', '--steps', '150'])
    all_finite(res)
    assert res['recovery_error'] < 0.5
    assert res['polish_recovery_error'] < 0.5


# -- the command line -----------------------------------------------------

def test_without_cpu_and_without_a_card_the_drivers_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gauss.main([])


def test_x64_selects_float64():
    a = gauss.main(['--cpu'])['posterior_mean']
    b = gauss.main(X64)['posterior_mean']
    assert a.dtype == np.float32 and b.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_plot_without_matplotlib_names_the_flag(monkeypatch):
    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name == 'matplotlib' or name.startswith('matplotlib.'):
            raise ImportError(f'No module named {name!r}')
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', no_matplotlib)
    with pytest.raises(ImportError, match='--plot'):
        gauss.main(['--cpu', '--plot'])


def test_every_driver_runs_as_a_module_and_imports_no_jax():
    """`python -m` runs a driver; importing all of them loads neither jax,
    mimo_tpu, the JAX package's examples/ nor the plotting helpers, and
    importing those loads no matplotlib."""
    proc = subprocess.run(
        [sys.executable, '-m', 'mimo_tpu_torch.examples.gauss', '--cpu'],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert 'log marginal likelihood' in proc.stdout
    mods = ', '.join(f'mimo_tpu_torch.examples.{d}' for d in DRIVERS)
    # the drivers import the plotting helpers only under --plot, and those
    # import matplotlib only when called
    code = (f'import sys, {mods}; '
            'plot = "mimo_tpu_torch.utils.plot" in sys.modules; '
            'import mimo_tpu_torch.utils.plot; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "mimo_tpu", "matplotlib", "_common")); '
            'print(plot, bad); sys.exit(1 if bad or plot else 0)')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_drivers_are_the_jax_drivers():
    """One port driver a JAX driver of examples/, by name."""
    jax_drivers = {p.stem for p in (REPO / 'examples').glob('*.py')
                   if not p.stem.startswith('_')}
    assert set(DRIVERS) == jax_drivers
    for d in DRIVERS:
        assert (REPO / 'mimo_tpu_torch' / 'examples' / f'{d}.py').is_file()
