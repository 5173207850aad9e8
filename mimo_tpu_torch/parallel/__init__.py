"""Device mesh, chains and their diagnostics (port of
mimo_tpu/parallel)."""

from mimo_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharded, data_parallel_fit, init_distributed, make_mesh,
    pad_to_multiple, replicate, shard_data)
from mimo_tpu_torch.parallel.chains import (  # noqa: F401
    best_of, fit_chains, smc_gibbs, systematic_indices, systematic_resample)
from mimo_tpu_torch.parallel.diagnostics import (  # noqa: F401
    diagnostics, ess, rank_normalize, split_rhat)
