"""On the card: a fit cell and the serve cell with --trace 1 report the
span metrics their BENCHMARK.json entries list, the spans segment's
closure holds, and the wrappers of B1, B2 and B3 are ranges of the same
chrome trace as the kernels they launch. Marked cuda: without a card
they skip."""

import json
import subprocess
import sys

import pytest

import pb_support
from harness import spans

NEW = {'algebra_idle_ms.fit', 'engines_idle_ms.fit', 'wrappers_idle_ms.fit',
       'algebra_ops.fit', 'algebra_idle_ms.serve', 'models_idle_ms.serve',
       'wrappers_idle_ms.serve', 'layout_builds.serve'}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def span_report(stderr):
    """The spans segment's report line of a run's standard error."""
    head = 'portbench: spans: {'
    lines = [ln for ln in stderr.splitlines() if ln.startswith(head)]
    assert len(lines) == 1, stderr[-3000:]
    return json.loads(lines[0][len(head) - 1:])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['gmm_d2_k50.chains8_vi',
                                      'gmm_d32_k256.serve'])
def test_span_metrics_on_card(card, workload):
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', workload,
         '--seed', str(2 ** 31 + 203), '--seconds', '3', '--trace', '1'],
        capture_output=True, text=True, timeout=1500,
        cwd=str(pb_support.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    want = {m['name'] for m in pb_support.spec()['per_layer']
            if m['name'] in NEW and workload in m['workloads']}
    assert want and want <= set(result['metrics'])
    assert not (NEW - want) & set(result['metrics'])
    for name in want:
        assert result['metrics'][name]['value'] >= 0, name
    report = span_report(out.stderr)
    assert abs(report['closure']) < 0.01
    wrapper = ('mimo.wrappers.b3' if workload.endswith('serve')
               else 'mimo.wrappers.b1')
    assert report['ops_by_span'].get(wrapper, 0) > 0, report


@pytest.mark.cuda
def test_wrapper_spans_share_the_kernels_trace(card):
    import torch
    from mimo_tpu_torch.models import BayesianGMM
    from mimo_tpu_torch.utils import logging
    from harness import trace
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((200_000, 2), generator=g, device=dev)
    model = BayesianGMM.make(size=8, dim=2, gating='dp', device=dev)

    def calls():
        with torch.profiler.record_function('portbench.fit_call'):
            state, _ = model.fit_vi_fused(x, key=3, maxiter=2)
            model.fit_gibbs_fused(x, key=3, maxiter=2)
            model.log_predictive(state, x)
            torch.cuda.synchronize(dev)
    with logging.spans():
        _, events = trace.profile(calls)
    s = spans.attribute(events)
    assert s is not None and abs(s.closure()) < 1e-9
    for b in ('b1', 'b2', 'b3'):
        assert s.ops.get(f'mimo.wrappers.{b}', 0) > 0, s.ops
