"""The hierarchical GMM's cell, hgmm_d2_k50.vi, on the CPU at a test size
(N=20,000, K=8, d=2, float64): a sound run is correct; the adapter's
faults on the port's plain path (a sweep that returns its state, half of
the points left out with the statistics doubled, an answer altered) come
out not correct; the update cut to 12 of its 25 inner rounds
(`few_rounds`) reads what the sound run reads, because the rounds reach
their fixed point first, and only the port's round counter sees it; the
two span metrics of the inner rounds read the span `mimo.algebra.hyper`
and give None where the port has no such span."""

from contextlib import nullcontext

import pytest

import pb_support
from harness import cells, spans, trace
from test_portbench_spans import context, with_device

WORKLOAD = 'hgmm_d2_k50.vi'
SIZES = {**pb_support.SMALL, 'hgmm_d2_k50': dict(n=20000, size=8, dim=2)}
HYPER = ('hyper_idle_ms.fit', 'hyper_ops.fit')
HGMM = cells.adapter('HierarchicalGMM', pb_support.BENCH)


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    return pb_support.small_bench(tmp_path_factory.mktemp('pb'), sizes=SIZES)


def values(result):
    return {k: v['value'] for k, v in result['checks'].items()}


def test_sound_run_is_correct(bench):
    result = pb_support.run_small(bench, WORKLOAD)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert set(result['checks']) == {'elbo_gap', 'post_gap', 'count_chi2'}


@pytest.mark.parametrize('fault', ['stuck', 'half_batch', 'altered'])
def test_fault_is_not_correct(bench, fault, monkeypatch):
    HGMM.FAULTS[fault](monkeypatch.setattr)
    result = pb_support.run_small(bench, WORKLOAD)
    assert not result['correct'], result['checks']


def test_control_is_not_correct(bench):
    result = pb_support.run_small(bench, WORKLOAD, control=True)
    assert not result['correct'], result['checks']


def test_few_rounds_reads_as_the_sound_run(bench, monkeypatch):
    """Cut to 12 rounds, the update reaches the fixed point it reaches in
    25 (the q(mu_k) means of components that hold points hardly move
    with the hyper mean), so the check reads the sound run's numbers; the
    port's counter shows the cut."""
    from mimo_tpu_torch.distributions import hierarchical
    sound = values(pb_support.run_small(bench, WORKLOAD))
    HGMM.FAULTS['few_rounds'](monkeypatch.setattr)
    hierarchical.counts.update(rounds=0, updates=0)
    result = pb_support.run_small(bench, WORKLOAD)
    assert values(result) == pytest.approx(sound, rel=1e-6, abs=1e-12)
    assert hierarchical.counts['updates'] > 0
    assert hierarchical.counts['rounds'] == 12 * hierarchical.counts['updates']


def read(ctx, bench, names):
    return {name: cells.metric_reader(name, bench)(ctx) for name in names}


def test_hyper_metrics_read_the_inner_rounds(bench, monkeypatch):
    monkeypatch.setattr(trace, 'profile', with_device(trace.profile))
    ctx = context(bench, WORKLOAD)
    got = read(ctx, bench, HYPER + ('algebra_ops.fit',))
    s = spans.segment(ctx)
    assert s.ops['mimo.algebra.hyper'] > 0
    assert got['hyper_ops.fit'] == s.ops['mimo.algebra.hyper'] / s.units
    assert 0 < got['hyper_ops.fit'] < got['algebra_ops.fit']
    assert got['hyper_idle_ms.fit'] > 0


def test_hyper_metrics_are_none_without_the_span(bench, monkeypatch):
    """A port whose hierarchical family has no span (as before it had
    one), and a cell whose model has no inner rounds, read None."""
    from mimo_tpu_torch.distributions import hierarchical
    monkeypatch.setattr(trace, 'profile', with_device(trace.profile))
    monkeypatch.setattr(hierarchical, 'span', lambda *a: nullcontext())
    for workload in (WORKLOAD, 'gmm_d2_k50.vi'):
        ctx = context(bench, workload)
        assert spans.segment(ctx) is not None
        assert read(ctx, bench, HYPER) == {name: None for name in HYPER}


def test_traced_cpu_run_stays_correct(bench):
    result = pb_support.run_small(bench, WORKLOAD, trace=True)
    assert result['correct'], result['checks']
    assert not set(HYPER) & set(result['metrics'])
