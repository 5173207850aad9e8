"""harness/spans.py: device idle and device ops attributed to the port's
layer spans. On synthetic chrome-trace events: a gap split across two
spans, a gap under no span, a kernel matched to its launch by
correlation, and the closure (attributed idle = 1 - busy / wall). On the
CPU: one more segment of a small cell's real calls, with device events
made from its host ops, read by every span metric; a port without spans
gives every reader None."""

import pytest
import torch

import pb_support
from harness import cells, main, spans, trace, traffic

SPAN_METRICS = ('algebra_idle_ms.fit', 'engines_idle_ms.fit',
                'wrappers_idle_ms.fit', 'algebra_ops.fit',
                'algebra_idle_ms.serve', 'models_idle_ms.serve',
                'wrappers_idle_ms.serve', 'layout_builds.serve')


def note(name, ts, dur):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts,
            'dur': dur}


def kernel(ts, dur, corr, name='k'):
    return {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur,
            'args': {'correlation': corr}}


def launch(ts, corr):
    return {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
            'ts': ts, 'dur': 1, 'args': {'correlation': corr}}


def sweep_events():
    """A 100 us window: a sweep 10-90 holding the posterior 20-40 and B1's
    wrapper 50-80, which holds theta 50-60; kernels 0-15, 45-55, 85-100,
    launched at 1 (no span), 52 (theta) and 70 (the wrapper)."""
    return [note('portbench.fit_call', 0, 100),
            note('mimo.engines.sweep', 10, 80),
            note('mimo.algebra.posterior', 20, 20),
            note('mimo.wrappers.b1', 50, 30),
            note('mimo.algebra.theta', 50, 10),
            kernel(0, 15, 1), kernel(45, 10, 2), kernel(85, 15, 3),
            launch(1, 1), launch(52, 2), launch(70, 3)]


def approx(d):
    return {k: pytest.approx(v, abs=1e-12) for k, v in d.items()}


def test_gap_split_where_spans_open_and_close():
    s = spans.attribute(sweep_events())
    assert s.wall_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.idle == approx({'mimo.engines.sweep': 15e-6,
                             'mimo.algebra.posterior': 20e-6,
                             'mimo.algebra.theta': 5e-6,
                             'mimo.wrappers.b1': 20e-6})
    assert s.layer_idle_s('algebra') == pytest.approx(25e-6)
    assert s.layer_idle_s('engines') == pytest.approx(15e-6)
    assert s.layer_idle_s('wrappers') == pytest.approx(20e-6)
    assert s.closure() == pytest.approx(0.0, abs=1e-12)


def test_gap_under_no_span_goes_to_the_remainder():
    s = spans.attribute([note('portbench.serve_request', 0, 100),
                         note('mimo.engines.log_predictive', 30, 30),
                         kernel(0, 10, 1), kernel(40, 10, 2)])
    assert s.idle == approx({spans.REMAINDER: 60e-6,
                             'mimo.engines.log_predictive': 20e-6})
    assert s.closure() == pytest.approx(0.0, abs=1e-12)


def test_kernel_goes_to_the_span_open_at_its_launch():
    s = spans.attribute(sweep_events())
    assert s.ops == {spans.REMAINDER: 1, 'mimo.algebra.theta': 1,
                     'mimo.wrappers.b1': 1}
    assert s.layer_ops('algebra') == 1
    # a kernel that runs long after its launch, under another span
    late = spans.attribute([note('portbench.fit_call', 0, 100),
                            note('mimo.algebra.kl', 0, 10),
                            note('mimo.algebra.posterior', 50, 50),
                            kernel(60, 5, 9), launch(5, 9)])
    assert late.ops == {'mimo.algebra.kl': 1}


def test_no_device_event_or_no_window_is_none():
    assert spans.attribute([note('portbench.fit_call', 0, 10)]) is None
    assert spans.attribute([kernel(0, 5, 1)]) is None


def test_innermost_prefers_the_latest_start():
    pieces = spans.innermost([(0, 10, 'a'), (2, 8, 'b'), (2, 4, 'c')], 0, 10)
    assert pieces == [(0, 2, 'a'), (2, 4, 'c'), (4, 8, 'b'), (8, 10, 'a')]


def with_device(profile):
    """trace.profile whose events gain a device event for each of the
    host's aten ops (the first half of its time) and its launch."""
    def fake(fn):
        result, events = profile(fn)
        extra = []
        for i, e in enumerate(events):
            if (e.get('ph') == 'X' and e.get('cat') == 'cpu_op'
                    and e.get('name', '').startswith('aten::')
                    and float(e.get('dur', 0)) > 0):
                ts, dur = float(e['ts']), float(e['dur'])
                extra += [kernel(ts, dur / 2, 10 ** 6 + i, e['name']),
                          launch(ts, 10 ** 6 + i)]
        return result, events + extra
    return fake


def context(bench, workload, seed=2 ** 33 + 5):
    """A Context after a short window and an untraced segment on the CPU,
    with a stand-in for the harness's trace."""
    cell = cells.find_cell(workload, pb_support.spec(), bench)
    dev = torch.device('cpu')
    drv = main.set_up(cell, seed, dev)
    drv.warm()
    sync = traffic.synchronizer(dev)
    window = traffic.run(drv, 0.01, sync)
    seg = traffic.run(drv, 0.01, sync, first=window.calls, keep=False)
    own = trace.Trace(window_s=1.0, busy_s=0.5, device_s=0.5, ops=1,
                      by_name={}, gaps={})
    return main.Context(cell, drv, window, 0.0, seg, own,
                        cells.peaks(bench))


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    return pb_support.small_bench(tmp_path_factory.mktemp('pb'))


def read(ctx, bench):
    return {name: cells.metric_reader(name, bench)(ctx)
            for name in SPAN_METRICS}


@pytest.mark.parametrize('workload', ['gmm_d2_k50.chains8_vi',
                                      'gmm_d2_k50.chains8_gibbs',
                                      'gmm_d32_k256.serve'])
def test_segment_of_a_small_cell(bench, workload, monkeypatch):
    monkeypatch.setattr(trace, 'profile', with_device(trace.profile))
    ctx = context(bench, workload)
    got = read(ctx, bench)
    s = spans.segment(ctx)
    assert s is not None and spans.segment(ctx) is s
    assert s.units >= spans.CALLS and s.spans > 0
    assert abs(s.closure()) < 1e-9
    fit = ctx.kind == 'fit'
    for name, value in got.items():
        assert (value is not None) == (name.endswith('.fit') == fit), name
    if fit:
        assert got['algebra_ops.fit'] > 0
        assert got['algebra_idle_ms.fit'] > 0
        assert got['engines_idle_ms.fit'] > 0
        assert got['wrappers_idle_ms.fit'] == 0.0     # no kernel on the CPU
    else:
        assert got['models_idle_ms.serve'] >= 0
        assert got['algebra_idle_ms.serve'] > 0
        assert got['layout_builds.serve'] == 0.0      # B3 lays out on cards


def test_a_port_without_spans_reads_none(bench, monkeypatch):
    from mimo_tpu_torch.utils import logging
    monkeypatch.setattr(trace, 'profile', with_device(trace.profile))
    monkeypatch.delattr(logging, 'spans')
    ctx = context(bench, 'gmm_d2_k50.chains8_vi')
    assert all(v is None for v in read(ctx, bench).values())


def test_no_traced_device_event_reads_none(bench):
    ctx = context(bench, 'gmm_d32_k256.vi')
    ctx.trace = None
    assert all(v is None for v in read(ctx, bench).values())


@pytest.mark.parametrize('workload', ['gmm_d2_k50.chains8_vi',
                                      'gmm_d32_k256.serve'])
def test_traced_cpu_run_stays_correct(bench, workload):
    result = pb_support.run_small(bench, workload, trace=True)
    assert result['correct'], result['checks']
    assert not set(SPAN_METRICS) & set(result['metrics'])
