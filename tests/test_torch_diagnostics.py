"""The port's chain diagnostics (mimo_tpu_torch/parallel/diagnostics.py,
its own copy of the NumPy module) against mimo_tpu.parallel.diagnostics
on the same inputs, rtol 1e-12: the cases of tests/test_diagnostics.py
(iid chains, a disagreeing and a trending chain, the constant-chain
edges, AR(1), stat axes and the summary), and tensors read as their
numpy values."""

import importlib

import numpy as np
import pytest
import torch

# the packages' __init__ files export the function `diagnostics` under the
# module's name, so the modules are taken from the import system
jdiag = importlib.import_module('mimo_tpu.parallel.diagnostics')
tdiag = importlib.import_module('mimo_tpu_torch.parallel.diagnostics')


def _ar1(rho=0.9, c=8, t=5000, seed=3):
    rng = np.random.default_rng(seed)
    x = np.zeros((c, t))
    e = rng.standard_normal((c, t)) * np.sqrt(1 - rho ** 2)
    for i in range(1, t):
        x[:, i] = rho * x[:, i - 1] + e[:, i]
    return x


def _disagreeing():
    x = np.random.default_rng(1).standard_normal((8, 1000))
    x[0] += 3.0
    return x


def _trending():
    return (np.random.default_rng(1).standard_normal((4, 1000))
            + np.linspace(0, 4, 1000))


def _constant(disagree):
    x = np.zeros((4, 100))
    if disagree:
        x[0] += 1.0
    return x


CASES = {
    'iid': lambda: np.random.default_rng(0).standard_normal((8, 2000)),
    'disagreeing': _disagreeing,
    'trending': _trending,
    'constant-equal': lambda: _constant(False),
    'constant-disagreeing': lambda: _constant(True),
    'ar1': _ar1,
    'stat-axes': lambda: np.random.default_rng(4).standard_normal(
        (4, 500, 3, 2)),
    'odd-draws': lambda: np.random.default_rng(5).standard_normal((3, 37)),
}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-12,
                               atol=0.0)


@pytest.mark.parametrize('rank', [False, True], ids=['plain', 'rank'])
@pytest.mark.parametrize('case', list(CASES))
def test_split_rhat_matches_jax(case, rank):
    x = CASES[case]()
    _close(tdiag.split_rhat(x, rank_normalized=rank),
           jdiag.split_rhat(x, rank_normalized=rank))


@pytest.mark.parametrize('case', list(CASES))
def test_ess_matches_jax(case):
    x = CASES[case]()
    _close(tdiag.ess(x), jdiag.ess(x))


@pytest.mark.parametrize('case', ['iid', 'ar1', 'stat-axes',
                                  'constant-disagreeing'])
def test_rank_normalize_matches_jax(case):
    x = CASES[case]()
    _close(tdiag.rank_normalize(x), jdiag.rank_normalize(x))


@pytest.mark.parametrize('rank', [False, True], ids=['plain', 'rank'])
@pytest.mark.parametrize('case', ['iid', 'disagreeing', 'ar1',
                                  'odd-draws'])
def test_summary_matches_jax(case, rank):
    x = CASES[case]()
    got = tdiag.diagnostics(x, rank_normalized=rank)
    want = jdiag.diagnostics(x, rank_normalized=rank)
    assert set(got) == set(want) == {'rhat', 'rhat_rank', 'ess', 'n'}
    assert got['n'] == want['n']
    for key in ('rhat', 'ess') + (('rhat_rank',) if rank else ()):
        _close(got[key], want[key])
    if not rank:
        assert got['rhat_rank'] is None


def test_known_values_hold():
    """The oracles of tests/test_diagnostics.py hold for the port's copy:
    R-hat near 1 for iid chains, above 1.2 for a stuck or trending
    chain, 1 and inf at the constant edges, ESS near n for iid draws and
    near n (1 - rho) / (1 + rho) for AR(1)."""
    assert 0.99 < tdiag.split_rhat(CASES['iid']()) < 1.01
    assert tdiag.split_rhat(_disagreeing()) > 1.2
    assert tdiag.split_rhat(_trending()) > 1.2
    assert tdiag.split_rhat(_constant(False)) == 1.0
    assert np.isinf(tdiag.split_rhat(_constant(True)))
    x = CASES['iid']()
    assert 0.7 * x.size < tdiag.ess(x) < 1.4 * x.size
    ratio = 0.1 / 1.9
    assert 0.5 * ratio * 40000 < tdiag.ess(_ar1()) < 2.0 * ratio * 40000
    assert tdiag.ess(CASES['stat-axes']()).shape == (3, 2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tensor_traces_read_as_numpy(dtype):
    """A (chains, draws) trace tensor, as fit_chains returns it, gives the
    numbers of its numpy values."""
    x = torch.as_tensor(_ar1(c=4, t=400), dtype=dtype)
    ref = x.numpy().astype(np.float64)
    _close(tdiag.split_rhat(x), jdiag.split_rhat(ref))
    _close(tdiag.ess(x), jdiag.ess(ref))
    assert tdiag.diagnostics(x) == jdiag.diagnostics(ref)


def test_short_traces_refused_as_in_jax():
    x = np.zeros((2, 3))
    for mod in (tdiag, jdiag):
        with pytest.raises(ValueError, match='>= 4 draws'):
            mod.split_rhat(x)
        with pytest.raises(ValueError, match='chains, draws'):
            mod.ess(np.zeros(5))
