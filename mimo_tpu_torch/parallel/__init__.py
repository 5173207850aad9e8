"""Chains and their diagnostics (port of mimo_tpu/parallel without its
mesh module, ROADMAP A21)."""

from mimo_tpu_torch.parallel.chains import (  # noqa: F401
    best_of, fit_chains, smc_gibbs, systematic_indices, systematic_resample)
from mimo_tpu_torch.parallel.diagnostics import (  # noqa: F401
    diagnostics, ess, rank_normalize, split_rhat)
