"""mimo_tpu_torch/utils/checkpoint.py: save / load round trips of every
state an engine returns, chunked fits against mimo_tpu's
fit_with_checkpoints, resumed fits against uninterrupted ones, and a
process killed mid-run and resumed."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JaxGaussParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.utils import checkpoint as jckpt

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.utils.checkpoint import (
    exists, fit_with_checkpoints, load_state, save_state)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
F64 = dict(dtype=torch.float64, device='cpu')


@pytest.fixture(scope='module')
def x():
    rng = np.random.default_rng(7)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return torch.as_tensor(c[rng.integers(0, 3, 600)]
                           + 0.7 * rng.standard_normal((600, 2)))


def _ilr_data(x):
    return x[:, :1], torch.sin(x[:, :1]) + 0.1 * x[:, 1:]


def engine_states(x):
    """name -> a state an engine returns, covering every NamedTuple class
    of bridge._CLASSES that a fit returns (flat, product and nested
    posteriors; Gibbs, EM; float32 and float64)."""
    gmm = BayesianGMM.make(size=4, dim=2, gating='dp', **F64)
    diag = BayesianGMM.make(size=4, dim=2, diag=True, **F64)
    hier = BayesianGMM.make(size=4, dim=2, hierarchical=True, maxsubiter=3,
                            **F64)
    f32 = BayesianGMM.make(size=4, dim=2, gating='dp', device='cpu')
    ilr = BayesianILR.make(size=4, input_dim=1, output_dim=1, **F64)
    hilr = BayesianILR.make(size=4, input_dim=1, output_dim=1,
                            tied_affine=True, hier_basis=True, maxsubiter=3,
                            **F64)
    nest = BayesianMixtureOfMixtures.make_gmm(2, 3, 2, **F64)
    nest_ml = BayesianMixtureOfMixtures.make_gmm(2, 3, 2,
                                                 hierarchical=False, **F64)
    xy = _ilr_data(x)
    return {
        'MFState': gmm.fit_vi_fused(x, key=1, maxiter=3)[0],
        'MFState-f32': f32.fit_vi_fused(x.float(), key=1, maxiter=3)[0],
        'MFState-NG': diag.fit_vi_fused(x, key=1, maxiter=3)[0],
        'MFState-HierTied': hier.fit_vi_fused(x, key=1, maxiter=3)[0],
        'MFState-ILR': ilr.fit_vi_fused(xy, key=1, maxiter=3)[0],
        'MFState-TiedAffine': hilr.fit_vi_fused(xy, key=1, maxiter=3)[0],
        'GibbsState': gmm.fit_gibbs_fused(x, key=2, maxiter=3),
        'GibbsState-chains': gmm.fit_gibbs_fused(x, key=[1, 2], maxiter=2,
                                                 chains=True),
        'EMState': gmm.fit_em_fused(x, key=0, maxiter=3)[0],
        'HMixState': nest.fit_vi_fused(x, key=1, maxiter=3)[0],
        'HMixGibbsState': nest.fit_gibbs_fused(x, key=2, maxiter=3),
        'HMixEMState': nest_ml.fit_em_fused(x, key=0, maxiter=3)[0],
    }


def assert_same_tree(a, b, bitwise=True):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape \
            and a.device == b.device
        if bitwise:
            assert torch.equal(a, b)
        return
    if hasattr(a, '_fields'):
        assert a._fields == b._fields
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert_same_tree(u, v, bitwise)


@pytest.fixture(scope='module')
def states(x):
    return engine_states(x)


@pytest.mark.parametrize('name', [
    'MFState', 'MFState-f32', 'MFState-NG', 'MFState-HierTied',
    'MFState-ILR', 'MFState-TiedAffine', 'GibbsState', 'GibbsState-chains',
    'EMState', 'HMixState', 'HMixGibbsState', 'HMixEMState'])
def test_save_load_round_trips(states, name, tmp_path):
    st = states[name]
    p = str(tmp_path / 'state')
    assert save_state(p, st) == p and exists(p)
    assert_same_tree(load_state(p, st), st)


def test_load_refuses_a_state_of_another_shape(states, tmp_path):
    p = str(tmp_path / 'state')
    save_state(p, states['MFState'])
    with pytest.raises(ValueError, match='do not fit'):
        load_state(p, states['HMixState'])
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / 'missing'), states['MFState'])


def test_chunked_fit_vi_matches_jax(tmp_path):
    """fit_with_checkpoints('fit_vi', 4 chunks of 5) from a state JAX
    made, against mimo_tpu's chunked run from the same state."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    xj, _ = JaxGMM.generate(
        jax.random.PRNGKey(7),
        JaxGaussParams(jnp.asarray([[-4., 0.], [4., 0.], [0., 5.]]), lm),
        jnp.asarray([.3, .4, .3]), 2000)
    xj = xj.astype(jnp.float64)
    jm = JaxGMM.make(size=4, dim=2, dtype=jnp.float64)
    st0, _ = jm.fit_vi(xj, key=0, maxiter=3)
    want, ran_j = jckpt.fit_with_checkpoints(
        jm, 'fit_vi', xj, str(tmp_path / 'jax'), total_iters=20,
        chunk_iters=5, key=0, init_state=st0, randomize=False)
    m = BayesianGMM.make(size=4, dim=2, **F64)
    got, ran = fit_with_checkpoints(
        m, 'fit_vi', torch.as_tensor(np.array(xj)), str(tmp_path / 'port'),
        total_iters=20, chunk_iters=5, key=0,
        init_state=state_from_numpy(jax.tree.map(np.asarray, st0)),
        randomize=False)
    assert ran == ran_j == 20
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    jax.tree.leaves(state_to_numpy(got))):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)
    with open(tmp_path / 'port.meta.json') as f:
        assert json.load(f) == {'iters': 20, 'fit': 'fit_vi'}


def _engine(name, x):
    """(model, data, fit name, fit kwargs) of a resumable engine."""
    gmm = BayesianGMM.make(size=4, dim=2, gating='dp', **F64)
    if name == 'nested-fit_svi':
        return (BayesianMixtureOfMixtures.make_gmm(2, 3, 2, **F64), x,
                'fit_svi', dict(batch_size=64, step_size=0.3))
    kw = {'fit_svi': dict(batch_size=64, step_size=0.3),
          'fit_gibbs': dict(init_labels='random')}.get(name, {})
    return gmm, x, name, kw


@pytest.mark.parametrize('name', ['fit_vi_fused', 'fit_vi', 'fit_svi',
                                  'fit_gibbs', 'nested-fit_svi'])
def test_resumed_run_equals_the_uninterrupted_one(x, name, tmp_path):
    """A run stopped after 10 of 20 iterations and resumed by a fresh
    call returns the uninterrupted chunked run's state bitwise, having run
    the other 10; each chunk's key depends only on (key, iterations
    done)."""
    model, data, fit, kw = _engine(name, x)
    whole, ran = fit_with_checkpoints(model, fit, data, str(tmp_path / 'a'),
                                      total_iters=20, chunk_iters=5, key=3,
                                      **kw)
    assert ran == 20
    p = str(tmp_path / 'b')
    _, ran1 = fit_with_checkpoints(model, fit, data, p, total_iters=10,
                                   chunk_iters=5, key=3, **kw)
    again, ran2 = fit_with_checkpoints(model, fit, data, p, total_iters=20,
                                       chunk_iters=5, key=3, **kw)
    assert (ran1, ran2) == (10, 10)
    assert_same_tree(again, whole)
    # finished: a further call loads the state and runs nothing
    done, ran3 = fit_with_checkpoints(model, fit, data, p, total_iters=20,
                                      chunk_iters=5, key=3, **kw)
    assert ran3 == 0
    assert_same_tree(done, whole)


def test_resume_false_starts_afresh(x, tmp_path):
    model, data, fit, kw = _engine('fit_gibbs', x)
    p = str(tmp_path / 'c')
    a, _ = fit_with_checkpoints(model, fit, data, p, total_iters=6,
                                chunk_iters=3, key=1, **kw)
    b, ran = fit_with_checkpoints(model, fit, data, p, total_iters=6,
                                  chunk_iters=3, key=1, resume=False, **kw)
    assert ran == 6
    assert_same_tree(a, b)


def test_a_damaged_checkpoint_raises_and_does_not_restart(x, tmp_path):
    model, data, fit, kw = _engine('fit_gibbs', x)
    p = str(tmp_path / 'd')
    fit_with_checkpoints(model, fit, data, p, total_iters=4, chunk_iters=2,
                         key=1, **kw)
    with open(p, 'r+b') as f:
        f.truncate(100)
    with pytest.raises(Exception):
        fit_with_checkpoints(model, fit, data, p, total_iters=8,
                             chunk_iters=2, key=1, **kw)


KILL_RUN = '''
import sys, torch
torch.set_num_threads(1)
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.utils.checkpoint import fit_with_checkpoints
x = torch.load(sys.argv[1], weights_only=True)
m = BayesianGMM.make(size=4, dim=2, gating='dp', dtype=torch.float64,
                     device='cpu')
fit_with_checkpoints(m, 'fit_gibbs', x, sys.argv[2], total_iters={total},
                     chunk_iters=1, key=5, init_labels='random')
'''


def test_killed_process_resumes_to_the_uninterrupted_state(x, tmp_path):
    """A process running a chunked Gibbs fit is sent SIGKILL once its meta
    file records at least 10 iterations; a rerun with resume=True returns
    the uninterrupted run's state bitwise and runs the iterations left."""
    total = 400
    xp, p = str(tmp_path / 'x.pt'), str(tmp_path / 'kill')
    torch.save(x, xp)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, '-c', KILL_RUN.format(total=total), xp, p],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with open(p + '.meta.json') as f:
                    if json.load(f)['iters'] >= 10:
                        break
            except (FileNotFoundError, json.JSONDecodeError):
                pass
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL, err.decode()
    done = torch.load(p, weights_only=True)['iters']
    assert 10 <= done < total

    m = BayesianGMM.make(size=4, dim=2, gating='dp', **F64)
    kw = dict(chunk_iters=1, key=5, init_labels='random')
    resumed, ran = fit_with_checkpoints(m, 'fit_gibbs', x, p,
                                        total_iters=total, **kw)
    assert ran == total - done
    whole, _ = fit_with_checkpoints(m, 'fit_gibbs', x, str(tmp_path / 'w'),
                                    total_iters=total, **kw)
    assert_same_tree(resumed, whole)
