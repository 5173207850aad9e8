"""The port's Geweke harness (mimo_tpu_torch/scripts/geweke_gibbs.py)
against the JAX repository's scripts/geweke_gibbs.py, for the flat
families with plain draws (gmm, ilr, diag); the exact-draw and nested
families are in test_torch_geweke_exact.py. The JAX script is loaded from
its path and not edited.

Per family: `stats_of` on JAX's parameters and data equals JAX's at
float64 rtol 1e-10, its names JAX's followed by the data moments' (which
JAX's flat families leave unnamed and so unscored), one a statistic;
`summarize` z-scores the moments; the port's prior side against JAX's, 1,000
iid draws each, max |z| < 5; the port's harness on the plain twin at
float64 (1,500 draws, burn 150, thin 1, n=128) max |z| < 6.0 with no draw
dropped and JAX's JSON keys. A transition that counts every point four
times must fail (max |z| > 8), and the cuda backend without a card
raises."""

import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu_torch.bridge import state_from_numpy
from mimo_tpu_torch.scripts import geweke_gibbs as port

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
N, K, DIM, M = 128, 3, 2, 2
# the keys of the JAX script's final JSON line (scripts/geweke_gibbs.py)
JAX_KEYS = {'backend', 'family', 'draws', 'dropped_prior', 'dropped_succ',
            'thin', 'max_abs_z', 'n', 'k', 'd', 'dtype'}
PRIOR_DRAWS = 1000
HARNESS = ['--draws', '1500', '--burn', '150', '--thin', '1', '--n',
           str(N)]


def jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_geweke_gibbs', REPO / 'scripts' / 'geweke_gibbs.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def args_for(family, backend):
    return types.SimpleNamespace(family=family, backend=backend, n=N, k=K,
                                 dim=DIM, m=M)


def configs(family):
    """(JAX's config at float64, the port's plain config at float64 on the
    CPU) of one family."""
    js = jax_script()
    build = (js.build_nested_config if family == 'nested'
             else js.build_mixture_config)
    jcfg = build(args_for(family, 'xla'), jnp.float64)
    pcfg = port.build_config(args_for(family, 'plain'), torch.float64,
                             torch.device('cpu'))
    return jcfg, pcfg


def to_port(tree):
    return state_from_numpy(jax.tree.map(np.asarray, tree))


def check_stats_of(family):
    """The port's stats_of on JAX's draw (params, weights, data) equals
    JAX's, vector and names."""
    jcfg, pcfg = configs(family)
    key = jax.random.PRNGKey(3)
    params, pi = jcfg['init'](jax.random.fold_in(key, 0))
    data = jcfg['generate'](jax.random.fold_in(key, 1), params, pi)
    want, want_names = jcfg['stats_of'](params, pi, data)
    got, got_names = pcfg['stats_of'](to_port(params), to_port(pi),
                                      to_port(data))
    # the port names the data moments that end the vector, which JAX's
    # flat families leave unnamed (and so unscored); its nested family
    # names them already
    moments = (port.ILR_MOMENTS if family in ('ilr', 'tied-affine')
               else port.GMM_MOMENTS)
    assert got_names == (want_names if family == 'nested'
                         else want_names + moments)
    assert got_names[-len(moments):] == moments
    assert len(got_names) == got.numel() == np.asarray(want).size
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def check_prior_side(family):
    """Two-sample z per column of the stats vector between the port's
    prior side and JAX's, 1,000 iid draws each."""
    jcfg, pcfg = configs(family)

    def prior_draw(k):
        k1, k3 = jax.random.split(k)
        params, pi = jcfg['init'](k1)
        return jcfg['stats_of'](params, pi,
                                jcfg['generate'](k3, params, pi))[0]

    a = np.asarray(jax.jit(jax.vmap(prior_draw))(
        jax.random.split(jax.random.PRNGKey(11), PRIOR_DRAWS)))
    b, _ = port.prior_side(pcfg, torch.Generator().manual_seed(11),
                           PRIOR_DRAWS)
    b = b.numpy()
    assert a.shape == b.shape and np.isfinite(a).all() \
        and np.isfinite(b).all()
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    z = np.abs(a.mean(0) - b.mean(0)) / se
    assert z.max() < 5.0, (z.max(), int(z.argmax()))


def check_summary_scores_moments(family):
    """`summarize` over both sides of a short run reports one finite z
    for every named statistic, the data moments included."""
    _, pcfg = configs(family)
    prior, names = port.prior_side(pcfg, torch.Generator().manual_seed(5),
                                   100)
    succ = port.successive_side(pcfg, torch.Generator().manual_seed(6),
                                100, 0, 1)
    _, recs, bad_p, bad_s = port.summarize(prior.numpy(), succ.numpy(),
                                           names, out=lambda s: None)
    scored = [r['stat'] for r in recs]
    assert scored == names and len(names) == prior.shape[1]
    assert set(port.ILR_MOMENTS if family in ('ilr', 'tied-affine')
               else port.GMM_MOMENTS) <= set(scored)
    assert all(np.isfinite(r['z']) for r in recs)
    assert bad_p == 0 and bad_s == 0


def run_harness(family, capsys, extra=()):
    """The port's harness through main(); returns its final JSON line."""
    port.main(['--family', family] + HARNESS + list(extra))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def check_harness(family, capsys):
    result = run_harness(family, capsys)
    assert set(result) == JAX_KEYS
    assert result['backend'] == 'plain' and result['dtype'] == 'float64'
    assert result['dropped_prior'] == 0 and result['dropped_succ'] == 0
    assert result['max_abs_z'] < 6.0, result


FLAT = ['gmm', 'ilr', 'diag']


@pytest.mark.parametrize('family', FLAT)
def test_stats_of_matches_jax(family):
    check_stats_of(family)


@pytest.mark.parametrize('family', FLAT)
def test_prior_side_matches_jax(family):
    check_prior_side(family)


@pytest.mark.parametrize('family', FLAT)
def test_summary_scores_the_data_moments(family):
    check_summary_scores_moments(family)


@pytest.mark.parametrize('family', FLAT)
def test_plain_harness_passes(family, capsys):
    check_harness(family, capsys)


def test_overcounted_statistics_fail_the_test(monkeypatch, capsys):
    """Power: the gmm transition fed its statistics four times over (a
    posterior that counts every point four times) leaves a stationary law
    that is not the prior, and the harness must say so at the size of the
    passing runs (max |z| 12.4-17.4 over seeds 0-2; twice over gives
    6.3-8.0 at 1,500 draws, too close to the pass bound to gate on)."""
    build = port.build_config

    def overcounted(args, dtype, device):
        cfg = build(args, dtype, device)
        model = cfg['model']
        update = model.family.update
        model.family = model.family._replace(
            update=lambda prior, s: update(
                prior, type(s)(*(4.0 * t for t in s))))
        return cfg

    monkeypatch.setattr(port, 'build_config', overcounted)
    result = run_harness('gmm', capsys)
    assert result['max_abs_z'] > 8.0, result


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.main(['--backend', 'cuda', '--draws', '10', '--burn', '0'])
