"""The port's ilr_eval driver (mimo_tpu_torch/examples/ilr_eval.py) on
the CPU: its datasets and features are bitwise those of the JAX driver
(examples/ilr_eval.py, loaded from its path and not edited) for the six
synthetic datasets at seeds 0-2, its presets are JAX's, and its fit of
each dataset at seeds 0, 1 and 2 stays under the frozen accuracy
thresholds of tests/test_examples.py (the JAX gate runs seed 0), read
from the line the driver prints by that test's regex."""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mimo_tpu_torch.examples import ilr_eval

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DATASETS = ['sine', 'sinc', 'step', 'step_poly', 'chirp', 'inverse']
SEEDS = [0, 1, 2]


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_ilr_eval():
    """examples/ilr_eval.py, which imports its sibling _common."""
    sys.path.insert(0, str(REPO / 'examples'))
    try:
        return load('jax_ilr_eval', REPO / 'examples' / 'ilr_eval.py')
    finally:
        sys.path.remove(str(REPO / 'examples'))


@pytest.fixture(scope='module')
def thresholds():
    return load('jax_test_examples',
                REPO / 'tests' / 'test_examples.py').ILR_EVAL_THRESHOLDS


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', DATASETS)
def test_make_dataset_is_bitwise_jax(jax_ilr_eval, name, seed):
    n = ilr_eval.PRESETS[name]['n']
    got = ilr_eval.make_dataset(name, n, np.random.default_rng(seed))
    want = jax_ilr_eval.make_dataset(name, n, np.random.default_rng(seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_poly_features_and_presets_are_jax(jax_ilr_eval):
    x = np.random.default_rng(0).uniform(-2, 2, (37, 1))
    for degree in (1, 2, 3, 5):
        assert np.array_equal(ilr_eval.poly_features(x, degree),
                              jax_ilr_eval.poly_features(x, degree))
    assert ilr_eval.PRESETS == jax_ilr_eval.PRESETS


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', DATASETS)
def test_accuracy_under_the_frozen_thresholds(thresholds, capsys, name,
                                              seed):
    res = ilr_eval.main(['--cpu', '--dataset', name, '--seed', str(seed)])
    out = capsys.readouterr().out
    # tests/test_examples.py's regex reads the printed line
    m = re.search(r'RMSE\s+([-\d.]+)\s+\|\s+mean NLPD\s+([-\d.]+)', out)
    assert m, out
    rmse, nlpd = float(m.group(1)), float(m.group(2))
    assert abs(rmse - res[name]['rmse']) < 1e-4
    assert abs(nlpd - res[name]['nlpd']) < 1e-4
    max_rmse, max_nlpd = thresholds[name]
    assert rmse < max_rmse, f'{name} seed {seed}: RMSE {rmse} > {max_rmse}'
    assert nlpd < max_nlpd, f'{name} seed {seed}: NLPD {nlpd} > {max_nlpd}'
    assert 1 <= res[name]['used'] <= res[name]['k']


def test_cmb_is_skipped_without_its_table(tmp_path, capsys):
    res = ilr_eval.main(['--cpu', '--dataset', 'cmb', '--cmb_path',
                         str(tmp_path / 'absent.csv')])
    assert res == {}
    assert 'cmb: skipped' in capsys.readouterr().out


def test_cmb_reads_a_given_table(tmp_path, capsys):
    """A two-column table with a header, as the reference's CMB csv."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 700, 120))
    table = np.stack([x, 1000 * np.sin(x / 100)
                      + 50 * rng.standard_normal(120)], -1)
    path = tmp_path / 'cmb.csv'
    np.savetxt(path, table, delimiter=',', header='ell,power')
    res = ilr_eval.main(['--cpu', '--dataset', 'cmb', '--cmb_path',
                         str(path), '--n', '120', '--gibbs_iters', '5',
                         '--svi_iters', '50'])
    assert res['cmb']['n'] == 120 and np.isfinite(res['cmb']['rmse'])
