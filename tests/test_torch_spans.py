"""The port's layer spans (utils/logging.span) and the serving layout
counter (ops/cuda_predict.layouts), on the CPU: off, a span is the one
shared null context and a profiled fit records no `mimo.` range; on,
each engine call, sweep, K-sized algebra step and kernel wrapper is a
range nested where its layer puts it, and the results are bitwise those
of the run with spans off."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.ops import cuda_predict
from mimo_tpu_torch.ops.cuda_estep import fused_estep_cuda_sharded
from mimo_tpu_torch.ops.cuda_gibbs import fused_gibbs_cuda_sharded
from mimo_tpu_torch.parallel import fit_chains
from mimo_tpu_torch.parallel.mesh import local_mesh
from mimo_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)

N, K, D, SWEEPS = 2000, 5, 2, 3


@pytest.fixture(scope='module')
def problem():
    g = torch.Generator().manual_seed(3)
    means = torch.tensor([[-3., 0.], [3., 0.], [0., 4.]], dtype=torch.float64)
    x = means[torch.randint(0, 3, (N,), generator=g)] + torch.randn(
        (N, D), generator=g, dtype=torch.float64)
    model = BayesianGMM.make(size=K, dim=D, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, dtype=torch.float64,
                             device='cpu')
    return model, x


def ranges(fn, tmp_path):
    """(fn's result, the `mimo.` ranges (start, end, name) of its chrome
    trace, sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                    e['name']) for e in events
                   if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                   and e.get('name', '').startswith('mimo.'))
    return out, spans


def named(spans, name):
    return [s for s in spans if s[2] == name]


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def children(spans, parent, prefix):
    return sorted({s[2] for s in spans if s[2].startswith(prefix)
                   and inside(s, parent) and s is not parent})


def fit_vi(model, x):
    return model.fit_vi_fused(x, key=7, maxiter=SWEEPS, backend='torch')


def fit_gibbs(model, x):
    return model.fit_gibbs_fused(x, key=7, maxiter=SWEEPS, backend='torch')


def flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in flat(t)]


def assert_bitwise(a, b):
    la, lb = flat(a), flat(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert torch.equal(u, v)


def test_span_is_the_shared_null_context_while_off(problem, tmp_path):
    model, x = problem
    assert tlog.span('engines', 'sweep') is tlog.span('algebra', 'kl', 3)
    _, spans = ranges(lambda: fit_vi(model, x), tmp_path)
    assert spans == []


def test_vi_sweeps_nest_their_algebra(problem, tmp_path):
    model, x = problem
    with tlog.spans():
        assert tlog.span('engines', 'sweep') is not tlog.span('engines',
                                                              'sweep')
        _, spans = ranges(lambda: fit_vi(model, x), tmp_path)
    engine = named(spans, 'mimo.engines.fit_vi_fused')
    sweeps = named(spans, 'mimo.engines.sweep')
    assert len(engine) == 1 and len(sweeps) == SWEEPS
    for sweep in sweeps:
        assert inside(sweep, engine[0])
        assert children(spans, sweep, 'mimo.algebra.') == [
            'mimo.algebra.kl', 'mimo.algebra.log_pi',
            'mimo.algebra.posterior']
    algebra = [s for s in spans if s[2].startswith('mimo.algebra.')]
    assert all(any(inside(a, s) for s in sweeps) for a in algebra)


def test_gibbs_sweeps_nest_their_draws(problem, tmp_path):
    model, x = problem
    with tlog.spans():
        _, spans = ranges(lambda: fit_gibbs(model, x), tmp_path)
    engine = named(spans, 'mimo.engines.fit_gibbs_fused')
    sweeps = named(spans, 'mimo.engines.sweep')
    assert len(engine) == 1 and len(sweeps) == SWEEPS
    for sweep in sweeps:
        assert inside(sweep, engine[0])
        assert children(spans, sweep, 'mimo.algebra.') == [
            'mimo.algebra.draws', 'mimo.algebra.posterior']


def test_log_predictive_nests_its_coefficients(problem, tmp_path):
    model, x = problem
    state, _ = fit_vi(model, x)
    with tlog.spans():
        _, spans = ranges(lambda: model.log_predictive(
            state, x[:300], backend='torch'), tmp_path)
    engine = named(spans, 'mimo.engines.log_predictive')
    parts = named(spans, 'mimo.models.predictive_parts')
    assert len(engine) == 1 and len(parts) == 1
    assert inside(parts[0], engine[0])
    assert children(spans, parts[0], 'mimo.') == [
        'mimo.algebra.coefficients']


def test_fit_chains_is_a_models_span(problem, tmp_path):
    model, x = problem
    with tlog.spans():
        _, spans = ranges(lambda: fit_chains(
            model, 'fit_vi_fused', x, [1, 2], maxiter=2, backend='torch'),
            tmp_path)
    top = named(spans, 'mimo.models.fit_chains')
    assert len(top) == 1
    assert children(spans, top[0], 'mimo.engines.') == [
        'mimo.engines.fit_vi_fused', 'mimo.engines.sweep']
    assert len(named(spans, 'mimo.engines.sweep')) == 2


@pytest.mark.parametrize('engine', ['vi', 'gibbs', 'predict'])
def test_results_bitwise_with_spans_on_and_off(problem, engine):
    model, x = problem

    def run():
        if engine == 'vi':
            return fit_vi(model, x)
        if engine == 'gibbs':
            return fit_gibbs(model, x)
        state, _ = model.fit_vi_fused(x, key=2, maxiter=2, backend='torch')
        return model.log_predictive(state, x[:500], backend='torch')
    off = run()
    with tlog.spans():
        on = run()
    assert_bitwise(on, off)


def test_wrappers_nest_their_theta_and_coefficients(problem, tmp_path):
    """The host side of B1, B2 and B3 (their CPU tensors run the plain
    versions) is each a wrapper span around its algebra."""
    model, x = problem
    state, _ = fit_vi(model, x)
    spec = model._estep_spec()
    mesh = local_mesh(x.device)
    xts = [[x.T.contiguous()]]
    log_pi = state.gating.expected_log_pi()
    params = model.family.mode_params(state.components)

    def calls():
        fused_estep_cuda_sharded(spec, state.components, log_pi, xts, mesh)
        fused_gibbs_cuda_sharded(spec, torch.tensor(5), params, log_pi, xts,
                                 mesh)
        cuda_predict.gauss_predictive_cuda_sharded(
            state.components, model.predictive_log_weights(state), [x[:64]])
    with tlog.spans():
        _, spans = ranges(calls, tmp_path)
    want = {'mimo.wrappers.b1': ['mimo.algebra.theta'],
            'mimo.wrappers.b2': ['mimo.algebra.theta'],
            'mimo.wrappers.b3': ['mimo.algebra.coefficients']}
    for name, inner in want.items():
        outer = named(spans, name)
        assert len(outer) == 1, name
        assert children(spans, outer[0], 'mimo.') == inner


def test_profile_writes_mimo_spans(problem, tmp_path):
    model, x = problem
    with tlog.profile(str(tmp_path / 'prof')):
        fit_vi(model, x)
    events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())[
        'traceEvents']
    names = [e.get('name') for e in events if e.get('ph') == 'X']
    assert names.count('mimo.engines.fit_vi_fused') == 1
    assert names.count('mimo.engines.sweep') == SWEEPS
    assert tlog.span('engines', 'sweep') is tlog.span('models', 'x')


def test_cached_layout_counts_builds_and_reuses():
    before = dict(cuda_predict.layouts)
    coef, dep = torch.ones(4, 3), torch.zeros(4, 8)

    def build():
        return coef * 2.0

    first = cuda_predict.cached_layout(coef, (dep,), 32, build)
    again = cuda_predict.cached_layout(coef, (dep,), 32, build)
    assert again is first
    assert cuda_predict.layouts == {'built': before['built'] + 1,
                                    'reused': before['reused'] + 1}
    fresh = torch.ones(4, 3)
    cuda_predict.cached_layout(fresh, (dep,), 32, lambda: fresh * 2.0)
    assert cuda_predict.layouts == {'built': before['built'] + 2,
                                    'reused': before['reused'] + 1}
