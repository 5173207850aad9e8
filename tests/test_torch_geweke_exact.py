"""The port's Geweke harness against the JAX repository's
scripts/geweke_gibbs.py for the families with exact one-shot draws (tied,
tied-diag, hier, tied-affine) and the nested two-level sweep, as
test_torch_geweke.py holds the flat families: `stats_of` on JAX's draw at
float64 rtol 1e-10 (names with the data moments), the summary scoring
the moments, the prior sides at max |z| < 5 over 1,000 draws each,
and the plain harness at float64 (1,500 draws, burn 150, thin 1, n=128)
at max |z| < 6.0 with no draw dropped."""

import pytest
import torch

from test_torch_geweke import (
    check_harness, check_prior_side, check_stats_of,
    check_summary_scores_moments)

torch.set_num_threads(1)
EXACT = ['tied', 'tied-diag', 'hier', 'tied-affine', 'nested']


@pytest.mark.parametrize('family', EXACT)
def test_stats_of_matches_jax(family):
    check_stats_of(family)


@pytest.mark.parametrize('family', EXACT)
def test_prior_side_matches_jax(family):
    check_prior_side(family)


@pytest.mark.parametrize('family', EXACT)
def test_summary_scores_the_data_moments(family):
    check_summary_scores_moments(family)


@pytest.mark.parametrize('family', EXACT)
def test_plain_harness_passes(family, capsys):
    check_harness(family, capsys)
