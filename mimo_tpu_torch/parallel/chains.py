"""Chain / restart parallelism: many independent inference runs as one
batched program (port of mimo_tpu/parallel/chains.py).

The JAX package vmaps a whole fit over a batch of PRNG keys; every
`pallas_call` inside then takes a chain grid axis. Here the same is
written out:

  * `fit_chains`  — C restarts of one engine, stacked on a leading chain
                    axis. Every engine runs its C chains as one program
                    (its `chains=True` in models.mixture and models.hmix:
                    the K-sized algebra under torch.func.vmap over C). The
                    fused engines (`fit_vi_fused`, `fit_gibbs_fused`,
                    `fit_map_fused`, `fit_em_fused`) launch kernel B1 or
                    B2 once a sweep for all chains; the dense ones
                    (`fit_vi`, `fit_map`, `fit_em`, `fit_svi`,
                    `fit_gibbs`) form the chains' (C, N, K)
                    responsibilities with one flat call over C K
                    components where the family allows it, and the
                    nested mixtures (models.hmix) batch all nine engines
                    the same way around their M-vmapped algebra. Chain c
                    of VI, MAP, ML-EM and SVI equals the fit with key c;
                    the Gibbs chains draw from one generator seeded by
                    the chains' keys. With `mesh` (a ('chain', 'data')
                    mesh) the keys split into one contiguous group a
                    chain row, and each group runs batched over its
                    row's data shards, one reduction a sweep (a fused
                    engine: one kernel launch per shard per sweep for all
                    of the group's chains).
  * `best_of`     — the chain with the best final ELBO.
  * `smc_gibbs`   — Gibbs chains interleaved with systematic resampling of
                    chain states by data log-likelihood.
"""

import torch

from mimo_tpu_torch.models.mixture import (
    BayesianMixture, _as_generator, _as_tuple)
from mimo_tpu_torch.parallel.mesh import Sharded
from mimo_tpu_torch.utils.logging import spanned
from mimo_tpu_torch.utils.tree import tree_map, tree_map2

# every engine runs C chains as one batched program (its chains=True), for
# flat and nested models alike
BATCHED = ('fit_vi_fused', 'fit_gibbs_fused', 'fit_map_fused',
           'fit_em_fused', 'fit_gibbs', 'fit_vi', 'fit_map', 'fit_em',
           'fit_svi')


@spanned('models')
def fit_chains(model, fit_name, data, keys, mesh=None, **kw):
    """Run `model.<fit_name>` once per key, as one program, and return its
    results stacked on a leading chain axis. `keys`: an int64 tensor (C,)
    or a sequence of int seeds or torch.Generators. Every engine in
    BATCHED, of a flat or a nested (BayesianMixtureOfMixtures) model,
    runs its C chains batched (on CUDA data a fused engine launches its
    kernel once a sweep for all chains). JAX's cache of traced programs
    has no counterpart: nothing is traced.

    With `mesh`, a ('chain', 'data') mesh (parallel.make_mesh(n_chain=c)),
    the C keys split into c contiguous groups of C / c, group g running
    over chain row g (`mesh.row(g)`; the data sharded over its 'data'
    positions, as shard_data places it) as one program with one
    reduction a sweep over the row (for a fused engine one kernel launch
    per shard per sweep for all of the group's chains). JAX carries the
    layout in the sharding of its keys; PyTorch has none, so `mesh` is
    explicit. The result stacks the groups of this process's rows on the
    chain axis (every row, within one process); a Gibbs fit's labels stay
    on their shards, each position's (C / c, n_j) of its row's group."""
    if fit_name not in BATCHED:
        raise ValueError(f'unknown engine {fit_name!r}; one of '
                         f'{list(BATCHED)}')
    if mesh is None:
        return getattr(model, fit_name)(_as_tuple(data), key=keys,
                                        chains=True, **kw)
    if isinstance(keys, torch.Tensor):
        keys = keys.reshape(-1).tolist()
    keys = list(keys)
    rows = mesh.shape['chain']
    if len(keys) % rows:
        raise ValueError(f'{len(keys)} chain keys do not split over the '
                         f"mesh's {rows} chain rows")
    per = len(keys) // rows
    fit = getattr(model, fit_name)
    return _cat_groups([fit(data, key=keys[g * per:(g + 1) * per],
                            chains=True, mesh=mesh.row(g), **kw)
                        for g in mesh.rows()])


def _cat_groups(trees):
    """The chain groups' results on one chain axis, on the first group's
    devices; Sharded labels keep each group's shards."""
    first = trees[0]
    if len(trees) == 1:
        return first
    if isinstance(first, Sharded):
        return Sharded(sum((t.shards for t in trees), ()),
                       sum((t.positions for t in trees), ()), first.n)
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(first.device) for t in trees])
    items = [_cat_groups([t[i] for t in trees]) for i in range(len(first))]
    return type(first)(*items) if hasattr(first, '_fields') else tuple(items)


def best_of(states, vlb_traces):
    """The chain with the highest final ELBO: (its state, its index)."""
    best = torch.argmax(vlb_traces[:, -1])
    return tree_map(lambda a: a[best], states), best


def systematic_indices(u, log_w):
    """The chains systematic resampling keeps, for one uniform u in
    [0, 1) and log-weights (C,): chain searchsorted(cumsum(w), (u + i) /
    C) for slot i, clipped to [0, C - 1]."""
    c = log_w.shape[0]
    w = torch.softmax(log_w, 0)
    positions = (u + torch.arange(c, dtype=log_w.dtype,
                                  device=log_w.device)) / c
    idx = torch.searchsorted(torch.cumsum(w, 0), positions)
    return torch.clamp(idx, 0, c - 1)


def systematic_resample(key, log_w, tree):
    """Systematic resampling of a chain-stacked tree by log-weights (C,),
    the uniform drawn from `key` (an int seed or a torch.Generator).
    Returns (the resampled tree, the indices)."""
    gen = _as_generator(key, log_w.device)
    u = torch.rand((), generator=gen, dtype=log_w.dtype, device=log_w.device)
    idx = systematic_indices(u, log_w)
    return tree_map(lambda a: a[idx], tree), idx


def smc_gibbs(model, data, key, n_chains=8, n_rounds=10,
              sweeps_per_round=10, ess_threshold=0.5):
    """Population Gibbs with systematic chain resampling.

    Each round runs `sweeps_per_round` blocked-Gibbs sweeps of every chain
    (batched: the dense sweep under torch.func.vmap), scores chains by the
    data log-likelihood of their last sweep, and resamples chains when
    the effective sample size drops below `ess_threshold * n_chains`.
    Returns the final stacked GibbsStates and the per-round mean
    log-likelihoods (n_rounds,)."""
    if not isinstance(model, BayesianMixture):
        raise NotImplementedError(
            'smc_gibbs drives flat BayesianMixture models (GMM/ILR); '
            'nested mixtures have a different Gibbs state')
    data = _as_tuple(data)
    # standardize ONCE here: the sweeps and the scoring below call the
    # base-class engine and _gibbs_sweep on the data as given, so
    # going through the ILR wrappers (which transform internally) for the
    # init only would mix two data scales in one chain
    if hasattr(model, '_tx') and len(data) == 2:
        data = (model._tx(data[0]), model._ty(data[1]))
    dev = data[0].device
    gen = _as_generator(key, dev)
    keys = torch.randint(0, 2 ** 62, (n_chains,), generator=gen,
                         dtype=torch.int64, device=dev)
    # base-class engine: data is already transformed
    states = BayesianMixture.fit_gibbs(model, data, key=keys, maxiter=1,
                                       chains=True)
    logliks = []
    for _ in range(n_rounds):
        for _ in range(sweeps_per_round):
            states, log_w = model._gibbs_sweep(states, data, gen)
        w = torch.softmax(log_w, 0)
        ess = 1.0 / torch.sum(w * w)
        resampled, _ = systematic_resample(gen, log_w, states)
        states = tree_map2(
            lambda a, b: torch.where(ess < ess_threshold * n_chains, a, b),
            resampled, states)
        logliks.append(torch.mean(log_w))
    return states, torch.stack(logliks)
