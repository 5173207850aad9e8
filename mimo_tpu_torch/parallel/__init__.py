"""Device mesh, chains and their diagnostics (port of
mimo_tpu/parallel).

`mesh` sits below the ops and the models, which import it; `chains`
drives the models, so its names are imported on first use: importing
parallel.mesh never imports the models."""

import importlib

from mimo_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharded, data_parallel_fit, init_distributed, make_mesh,
    pad_to_multiple, replicate, shard_data)
from mimo_tpu_torch.parallel.diagnostics import (  # noqa: F401
    diagnostics, ess, rank_normalize, split_rhat)

_CHAINS = ('best_of', 'fit_chains', 'smc_gibbs', 'systematic_indices',
           'systematic_resample')


def __getattr__(name):
    if name in _CHAINS:
        return getattr(importlib.import_module(f'{__name__}.chains'), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
