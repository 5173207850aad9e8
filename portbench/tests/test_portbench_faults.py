"""A run whose timed path is broken underneath must come out not
correct. The harness runs every cell on the CPU at test sizes in
float64 (the committed limits), past its look for a card; the port's
plain path is broken in the way each fault says, where it produces its
result: a sweep that returns its state unchanged, half of the points
left out with the statistics doubled (the mean over the rest), an
answer altered. (No cell spans chips, so no exchange can be left out.)
"""

import pytest
import torch

import pb_support
from harness import faults
from mimo_tpu_torch.models import mixture
from mimo_tpu_torch.ops import family_estep

CELLS = [w['name'] for w in pb_support.spec()['workloads']]


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    return pb_support.small_bench(tmp_path_factory.mktemp('pb'))


def doubled(res):
    scale = lambda t: 2.0 * t  # noqa: E731
    return res._replace(stats=type(res.stats)(*map(scale, res.stats)),
                        lse=scale(res.lse), counts=scale(res.counts))


def halves(parts):
    return [tuple(a[:a.shape[0] // 2] for a in p) for p in parts]


def stuck(monkeypatch):
    """Every fit sweep returns the state it was given; Gibbs labels stay
    at their start."""
    loop = mixture._elbo_loop

    def frozen(step, carry, maxiter, tol, lead=()):
        return loop(lambda c, i: (c, step(c, i)[1]), carry, maxiter, tol,
                    lead)
    monkeypatch.setattr(mixture, '_elbo_loop', frozen)
    gibbs = family_estep.fused_gibbs_sharded

    def same_labels(*args):
        labels, res = gibbs(*args)
        return [torch.zeros_like(z) for z in labels], res
    monkeypatch.setattr(family_estep, 'fused_gibbs_sharded', same_labels)


def half_batch(monkeypatch):
    estep = family_estep.fused_estep_sharded
    gibbs = family_estep.fused_gibbs_sharded
    monkeypatch.setattr(
        family_estep, 'fused_estep_sharded',
        lambda spec, post, log_pi, shards, *a: doubled(
            estep(spec, post, log_pi, halves(shards), *a)))

    def half_gibbs(spec, seed, params, log_pi, shards, *a):
        labels, _ = gibbs(spec, seed, params, log_pi, shards, *a)
        _, res = gibbs(spec, seed, params, log_pi, halves(shards), *a)
        return labels, doubled(res)
    monkeypatch.setattr(family_estep, 'fused_gibbs_sharded', half_gibbs)


def altered(monkeypatch):
    """An answer altered where it is produced: the statistics of the
    largest component off by 10%, one label in a hundred moved to the
    next component, one density in a hundred off by 0.1 nats."""
    estep = family_estep.fused_estep_sharded
    gibbs = family_estep.fused_gibbs_sharded
    parts = mixture.BayesianMixture._log_predictive_parts

    def bad_estep(*args):
        res = estep(*args)
        k = res.counts.shape[-1]
        scale = 1.0 + 0.1 * torch.nn.functional.one_hot(
            torch.argmax(res.counts, -1), k).to(res.counts.dtype)

        def off(t):
            return t * scale.reshape(scale.shape + (1,) * (t.dim()
                                                           - scale.dim()))
        return res._replace(stats=type(res.stats)(*map(off, res.stats)),
                            counts=off(res.counts))

    def bad_gibbs(spec, seed, params, log_pi, *a):
        labels, res = gibbs(spec, seed, params, log_pi, *a)
        k = log_pi.shape[-1]
        out = []
        for z in labels:
            z = z.clone()
            z[..., ::100] = (z[..., ::100] + 1) % k
            out.append(z)
        return out, res

    def bad_parts(self, *args):
        out = parts(self, *args)
        for o in out:
            o[::100] += 0.1
        return out
    monkeypatch.setattr(family_estep, 'fused_estep_sharded', bad_estep)
    monkeypatch.setattr(family_estep, 'fused_gibbs_sharded', bad_gibbs)
    monkeypatch.setattr(mixture.BayesianMixture, '_log_predictive_parts',
                        bad_parts)


@pytest.mark.parametrize('workload', CELLS)
def test_sound_run_is_correct(bench, workload):
    result = pb_support.run_small(bench, workload)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0


@pytest.mark.parametrize('fault', [stuck, half_batch, altered])
@pytest.mark.parametrize('workload', CELLS)
def test_fault_is_not_correct(bench, workload, fault, monkeypatch):
    fault(monkeypatch)
    result = pb_support.run_small(bench, workload)
    assert not result['correct'], result['checks']


def test_mode_draws_are_not_correct(bench, monkeypatch):
    """Gibbs taking the posterior's mode where it should draw fails the
    draws' number, which the control does not move."""
    faults.mode_draws(monkeypatch.setattr)
    result = pb_support.run_small(bench, 'gmm_d2_k50.chains8_gibbs')
    assert not result['correct'], result['checks']
    draws = result['checks']['draw_z2_dev']
    assert draws['value'] > draws['limit']
