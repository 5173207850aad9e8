"""A run whose timed path is broken underneath must come out not
correct. The harness runs every cell on the CPU at test sizes in
float64 (the committed limits), past its look for a card; the port's
plain path is broken in the way each fault says, where it produces its
result (the model adapter's FAULTS, which calibrate.py plants on the
card): a sweep that returns its state unchanged, half of the points
left out with the statistics doubled (the mean over the rest), an
answer altered. (No cell spans chips, so no exchange can be left out.)
"""

import pytest

import pb_support
from harness import cells

CELLS = [w['name'] for w in pb_support.spec()['workloads']]
GMM = cells.adapter('BayesianGMM', pb_support.BENCH)


@pytest.fixture(scope='module')
def bench(tmp_path_factory):
    return pb_support.small_bench(tmp_path_factory.mktemp('pb'))


def stuck(monkeypatch):
    GMM.FAULTS['stuck'](monkeypatch.setattr)


def half_batch(monkeypatch):
    GMM.FAULTS['half_batch'](monkeypatch.setattr)


def altered(monkeypatch):
    GMM.FAULTS['altered'](monkeypatch.setattr)


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


def test_half_batch_fails_the_counts(bench, monkeypatch):
    """A fit over half the points, doubled, is a resample: Pearson's
    statistic of its counts reads about 1, over the single fit's limit,
    as it does on the card at N=1e7, where the ELBO and the posterior's
    statistics move too little to fail theirs."""
    half_batch(monkeypatch)
    result = pb_support.run_small(bench, 'gmm_d2_k50.vi')
    chi2 = result['checks']['count_chi2']
    assert chi2['value'] > chi2['limit'], result['checks']


def test_mode_draws_are_not_correct(bench, monkeypatch):
    """Gibbs taking the posterior's mode where it should draw (the model
    adapter's fault) fails the draws' number, which the control does not
    move."""
    workload = 'gmm_d2_k50.chains8_gibbs'
    GMM.FAULTS['mode_draws'](monkeypatch.setattr)
    result = pb_support.run_small(bench, workload)
    assert not result['correct'], result['checks']
    draws = result['checks']['draw_z2_dev']
    assert draws['value'] > draws['limit']
