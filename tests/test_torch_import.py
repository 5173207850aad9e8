"""The PyTorch port's package boundary: it imports neither jax nor
mimo_tpu, the backend rule refuses the kernel for CPU data, and the
bridge converts JAX states leaf by leaf."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import ILRConfig, MixtureConfig
from mimo_tpu_torch.distributions.gating import StickBreaking
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, GibbsState, MFState)

torch.set_num_threads(1)
PKG = Path(__file__).resolve().parent.parent / 'mimo_tpu_torch'


def _module_name(path):
    parts = path.relative_to(PKG.parent).with_suffix('').parts
    return '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


# every module of the port, imported by name (the package's __init__
# files import most of them, but not all: config, bridge)
PORT_MODULES = sorted(_module_name(p) for p in PKG.rglob('*.py'))


def test_import_leaves_jax_out():
    mods = ', '.join(PORT_MODULES)
    code = (f'import sys, {mods}; '
            'bad = sorted(m for m in sys.modules if m == "jax" '
            'or m.startswith(("jax.", "jaxlib")) or m == "mimo_tpu" '
            'or m.startswith("mimo_tpu.")); '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the layers below the models, each importing only from those before it:
# utils -> distributions / conjugate, parallel.mesh, io -> ops -> models
LOWER = ('utils', 'distributions', 'conjugate', 'ops', 'io',
         'parallel/mesh.py')
# what the lower layers never import: the models and what drives them
UPPER = ('mimo_tpu_torch.models', 'mimo_tpu_torch.parallel.chains',
         'mimo_tpu_torch.config')


def _imported(tree):
    """Every module an AST imports, function-local imports included: for
    `from a import b` both a and a.b (b may be a submodule)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f'{node.module}.{a.name}' for a in node.names)


@pytest.mark.parametrize('layer', LOWER)
def test_lower_layers_import_no_models(layer):
    """No module under utils/, distributions/, conjugate/, ops/ or io/,
    nor parallel/mesh.py, imports the models, the chains or the
    configs, at module level or inside a function."""
    root = PKG / layer
    files = [root] if root.suffix == '.py' else sorted(root.rglob('*.py'))
    assert files
    bad = [f'{path.relative_to(PKG)}: {name}' for path in files
           for name in _imported(ast.parse(path.read_text()))
           if any(name == up or name.startswith(up + '.') for up in UPPER)]
    assert not bad, bad


def test_models_leave_the_launch_protocol_to_ops():
    """B1/B2's launch protocol (the padded theta, the feature-map code,
    the packed partials and their reduction, the m8 arithmetic) lives in
    ops/ only; models/ goes through ops' wrappers and accumulator."""
    protocol = {'pad_theta', 'feature_kind', 'estep_packed', 'stack_rows',
                'y_rows', 'pack_estep', 'accumulate_shards', 'reduce_estep'}
    bad = []
    for path in sorted((PKG / 'models').glob('*.py')):
        text = path.read_text()
        names = {n.id for n in ast.walk(ast.parse(text))
                 if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(ast.parse(text))
            if isinstance(n, ast.Attribute)} | {
            a.name for n in ast.walk(ast.parse(text))
            if isinstance(n, ast.ImportFrom) for a in n.names}
        bad += [f'{path.name}: {n}' for n in sorted(names & protocol)]
        if re.search(r'//\s*8\)\s*\*\s*8', text):
            bad.append(f'{path.name}: m8 arithmetic')
    assert not bad, bad


def test_tree_walks_are_defined_once():
    """The tree map, its paired form and the leaf walk are defined in
    utils/tree.py and nowhere else in the package."""
    walks = {'tree_map', 'tree_map2', 'tree_where', 'tree_leaves',
             '_tree_map', '_tree_map2', '_tree_where', '_leaves',
             '_map_leaves', 'cast_floats', '_cast', 'on_device', '_on',
             'first_leaf', '_first_leaf'}
    where = {}
    for path in PKG.rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name in walks:
                where.setdefault(node.name, []).append(
                    str(path.relative_to(PKG)))
    assert where == {name: ['utils/tree.py'] for name in where}, where
    assert {'tree_map', 'tree_map2', 'tree_leaves'} <= set(where)


def test_import_covers_the_ilr_slice():
    for mod in ('config', 'models.ilr', 'distributions.mnw', 'utils.data',
                'ops.cuda_ilr_predict', 'ops.cuda_hello'):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES


def test_import_covers_the_diagonal_slice():
    """The diagonal families' modules are among those the no-jax check
    imports, and their kernel sources sit beside the others."""
    for mod in ('distributions.ng', 'distributions.mng',
                'ops.cuda_diag_predict'):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES
    assert (PKG / 'csrc' / 'diag_predict.cu').is_file()


def test_import_covers_the_tied_and_hierarchical_slice():
    """The tied, hierarchical and tied-affine modules and the B1 probes
    are among those the no-jax check imports."""
    for mod in ('distributions.hierarchical', 'distributions.tied_gibbs',
                'distributions.affine', 'ops.cuda_probes'):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES
    from mimo_tpu_torch.ops import _build
    assert {'mimo_regf', 'mimo_estep_count'} <= set(_build._SIGNATURES)


def test_import_covers_the_chains_slice():
    """The chains, their diagnostics and the two-sample check are among
    the modules the no-jax check imports, and the package exports JAX's
    names."""
    for mod in ('parallel', 'parallel.chains', 'parallel.diagnostics',
                'ops.precision'):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES
    import mimo_tpu_torch.parallel as par
    for name in ('fit_chains', 'best_of', 'systematic_resample',
                 'smc_gibbs', 'split_rhat', 'ess', 'rank_normalize',
                 'diagnostics'):
        assert callable(getattr(par, name))


def test_import_covers_the_examples_slice():
    """The example drivers, their shared plumbing and the plotting
    helpers are among the modules the no-jax check imports."""
    from mimo_tpu_torch.examples import DRIVERS
    assert len(DRIVERS) == 12
    for mod in ('utils.plot', 'examples', 'examples._common') + tuple(
            f'examples.{d}' for d in DRIVERS):
        assert f'mimo_tpu_torch.{mod}' in PORT_MODULES


@pytest.mark.parametrize('entry', ['gmm', 'ilr', 'mixture_config',
                                   'ilr_config'])
def test_entry_points_build_on_the_card_by_default(entry):
    """Without a device the entry points build on the CUDA card, and
    without a card they raise (naming device='cpu') rather than fall back
    to the CPU."""
    build = {
        'gmm': lambda **kw: BayesianGMM.make(size=3, dim=2, **kw),
        'ilr': lambda **kw: BayesianILR.make(size=3, input_dim=1,
                                             output_dim=1, **kw),
        'mixture_config': lambda **kw: MixtureConfig(size=3).build(**kw),
        'ilr_config': lambda **kw: ILRConfig(size=3).build(**kw),
    }[entry]
    if torch.cuda.is_available():
        assert build().gating_prior[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert build(device='cpu').gating_prior[0].device.type == 'cpu'


@pytest.fixture(scope='module')
def small():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((64, 2)), dtype=torch.float32)
    model = BayesianGMM.make(size=4, dim=2, gating='dp', device='cpu')
    return model, x


@pytest.mark.parametrize('engine', ['vi', 'gibbs', 'predict'])
def test_kernel_backend_refuses_cpu_data(small, engine):
    model, x = small
    with pytest.raises(ValueError, match='CUDA'):
        if engine == 'vi':
            model.fit_vi_fused(x, maxiter=1, backend='kernel')
        elif engine == 'gibbs':
            model.fit_gibbs_fused(x, maxiter=1, backend='kernel')
        else:
            st, _ = model.fit_vi_fused(x, maxiter=1)
            model.log_predictive(st, x, backend='kernel')
    with pytest.raises(ValueError, match='unknown backend'):
        model.fit_vi_fused(x, maxiter=1, backend='xla')


@pytest.fixture(scope='module')
def jax_states():
    mu = jnp.asarray([[-3., 0.], [3., 0.], [0., 4.]])
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0), GaussParams(mu, lm),
                           jnp.asarray([.3, .4, .3]), 512)
    m = JaxGMM.make(size=5, dim=2, gating='dp', kappa=0.05, psi_scale=0.5,
                    dtype=jnp.float64)
    st, _ = m.fit_vi_fused(x, key=1, maxiter=2, backend='xla')
    gs = m.fit_gibbs_fused(x, key=2, maxiter=2, backend='xla')
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, gs)


def _assert_same_tree(a, b):
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, '_fields'):
        assert a._fields == b._fields
        for f in a._fields:
            _assert_same_tree(getattr(a, f), getattr(b, f))
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('which', ['MFState', 'GibbsState'])
def test_bridge_round_trips_jax_states(jax_states, which):
    src = jax_states[0] if which == 'MFState' else jax_states[1]
    port = state_from_numpy(src)
    assert isinstance(port, MFState if which == 'MFState' else GibbsState)
    assert isinstance(port.components, NIW)
    assert isinstance(port.gating, StickBreaking)
    assert port.components.mu.dtype == torch.float64
    if which == 'GibbsState':
        assert port.labels.dtype == torch.int32
    _assert_same_tree(state_to_numpy(port), src)


def test_bridge_casts_floats_only(jax_states):
    port = state_from_numpy(jax_states[1], dtype=torch.float32)
    assert port.components.psi.dtype == torch.float32
    assert port.labels.dtype == torch.int32
