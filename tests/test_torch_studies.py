"""The port's study scripts (mimo_tpu_torch/scripts/smc_study.py,
precision_study.py) on the CPU: smc_study's chain scores against the JAX
repository's scripts/smc_study.py (loaded from its path, not edited) on
the same chain states, and tiny runs of both studies."""

import importlib.util
import json
import math
from pathlib import Path

import jax
import numpy as np
import torch

from mimo_tpu_torch.bridge import state_from_numpy
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.scripts import precision_study, smc_study

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def jax_smc_study():
    spec = importlib.util.spec_from_file_location(
        'jax_smc_study', REPO / 'scripts' / 'smc_study.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_score_chains_matches_jax():
    """The same stacked GibbsStates (JAX's fit_chains output, carried
    across) score the same held-out log predictive per chain."""
    js = jax_smc_study()
    k_d, k_t, k_i = jax.random.split(jax.random.PRNGKey(0), 3)
    x = js.make_data(k_d, 400).astype(jax.numpy.float64)
    x_test = js.make_data(k_t, 200).astype(jax.numpy.float64)
    jm = js.BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, dtype=x.dtype)
    states = js.fit_chains(jm, 'fit_gibbs', x, jax.random.split(k_i, 4),
                           maxiter=6)
    want = js.score_chains(jm, states, x_test)
    m = BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=torch.float64,
                         device='cpu')
    got = smc_study.score_chains(
        m, state_from_numpy(jax.tree.map(np.asarray, states)),
        torch.as_tensor(np.array(x_test)))
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_tiny_smc_study_prints_finite_lines(capsys):
    rows, agg = smc_study.main(['--cpu', '--seeds', '1', '--n', '300',
                                '--chains', '4', '--rounds', '2',
                                '--sweeps', '2'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith('seed 0: ind best')
    final = json.loads(lines[-1])
    assert final['budget_sweeps'] == 4 and final['chains'] == 4
    for arm in ('independent', 'smc'):
        assert all(math.isfinite(v) for v in final['aggregate'][arm].values())
        assert 0.0 < final['aggregate'][arm]['frac_good'] <= 1.0


def test_tiny_precision_study_plain_leg_is_finite():
    lines = []
    res = precision_study.run(n=20_000, vi_iters=5, gibbs_iters=5,
                              n_test=2_000, backends=('plain',),
                              device='cpu', out=lines.append)
    assert [s.split(':')[0] for s in lines] == ['VI plain ', 'Gibbs plain ']
    r = res['plain']
    assert r['nonfinite'] == 0
    assert all(math.isfinite(r[k]) for k in ('elbo', 'logpred', 'vi_rate',
                                             'gibbs_logpred', 'gibbs_rate'))


def test_the_slice_modules_are_among_the_port_modules():
    """The no-jax import check (test_torch_import.py) imports every module
    of the port by path: the certification scripts, the checkpoint and
    logging utilities and the extra densities are among them."""
    from test_torch_import import PORT_MODULES
    for mod in ('scripts', 'scripts.geweke_gibbs', 'scripts.smc_study',
                'scripts.precision_study', 'utils.checkpoint',
                'utils.logging', 'distributions.extra'):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES
