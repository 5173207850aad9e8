"""Bayesian mixture engine over a conjugate Family (port of
mimo_tpu/models/mixture.py): EM/MAP, blocked Gibbs, mean-field VI and
stochastic VI, dense, fused and out-of-core, and the posterior
predictive.

Update-rule contract:
  MAP    : post = prior (+) stats;            params <- mode(post)
  Gibbs  : post = prior (+) stats(one-hot);   params ~  post
  VI     : post = prior (+) stats(resp)
  SVI    : nat(post) <- (1-rho) nat(post) + rho (nat(prior) + stats/scale)
  ML-EM  : params <- ml_update(stats(resp)), no priors

The fused engines (`fit_vi_fused`, `fit_gibbs_fused`, `fit_map_fused`,
`fit_em_fused`) run their per-point pass through kernel B1 (the E-step,
fed the posterior-expected theta for VI and the plug-in theta of the
current params for MAP and EM) or B2 (the Gibbs label sweep) and never
form the N x K responsibilities; the dense engines (`fit_vi`, `fit_gibbs`,
`fit_map`, `fit_em`, `fit_svi`) are plain PyTorch wherever the data lies,
as they are plain JAX in the reference.

Chains. With `chains=True` every engine takes C chain keys in `key` and
runs C restarts as one batched program (the counterpart of jax.vmap over
the JAX engines, parallel/chains.py): the state's leaves carry a leading
C axis and the K-sized algebra runs under torch.func.vmap over C
(`_over_chains`, `_Chains.over`; a single fit runs the same code
unbatched). The fused engines launch B1 / B2 once a sweep for every
chain; the dense ones form the chains' (C, n, K) responsibilities with
one flat ell and one flat statistics call over C K components where the
family allows it (`_chain_points`, `_chain_stats`). Each chain's start
(and SVI's minibatches) is drawn from its own generator, so chain c of
the VI, MAP, EM and SVI engines equals the single-chain fit with key c;
the Gibbs chains draw from one generator seeded by theirs. The dense
fit_vi, fit_map, fit_svi and fit_gibbs also take each chain's own data,
(C, N, ...) arrays, and a model whose priors carry a leading chain axis
(`with_priors` of a C-stacked state), as jax.vmap over the data and the
re-anchored priors gives them.

Mesh. The fused engines, `fit_svi` and `log_predictive` take `mesh=`, a
one-row mesh from parallel.make_mesh, and data as parallel.shard_data
gives it (or whole, which they shard): each sweep launches B1 or B2 once
per non-empty shard on its device and makes the mesh's one reduction of
the packed (K m8 + 1) statistics (parallel.mesh.Mesh.reduce), so a
sharded sweep is the unsharded sweep up to the order of its sums. Without
`mesh` a fused engine runs over the one position of the data's device:
the unsharded fit is the one-shard case of the same code (`_Shards`).
Each shard draws only its own rows of the random start, keyed by the
global point index (`_random_resp`, in fixed chunks of points), so the
sharded start is the unsharded one; the starts' statistics take one
reduction each ('start' in the mesh counters); Gibbs labels stay on their
shards (parallel.mesh.Sharded); serving runs once per shard with no
collective; SVI draws a stratified minibatch a shard. The dense engines
(`fit_vi`, `fit_map`, `fit_em`, `fit_gibbs`) take `mesh=` too, and run
unsharded as its one-position case: each shard's (n_j, K)
responsibilities or labels stay on its device, and a sweep makes one
reduction of their statistics, counts and data term. The stream engines
take `mesh=` with a reader of this process's rows (see Out-of-core).

Out-of-core. `fit_svi_stream` takes host minibatches and
`fit_{vi,map,em}_stream_full` a dataset read a block at a time each sweep
(e.g. io.MmapDataset over a file larger than the card's memory). A reader
thread (io.Prefetcher) reads ahead; on the card the rows go through
pinned, double-buffered copies on a copy stream (io.stage) and every
block of a full-data sweep is one launch of kernel B1 on a fixed device
buffer with the block's row count at run time. The statistics add across
blocks, so a streamed sweep is the in-memory fused sweep. Over a mesh
every process streams its own rows, each block's rows split over its
positions, B1 runs once per non-empty shard on a column view of the
staged buffer, and a sweep (or an SVI step) makes one reduction, however
many blocks it reads; unsharded, a sweep is the one-position case.

Backends. Each fused engine and `log_predictive` takes `backend`:
  'auto'   — the CUDA kernel when the data lies on a CUDA device, the plain
             PyTorch version when it lies on the CPU;
  'kernel' — the CUDA kernel; raises for CPU data;
  'torch'  — the plain PyTorch version wherever the data lies.
No path runs the plain version for CUDA data unless 'torch' asks for it:
if a kernel cannot build or launch, the call raises.
"""

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from mimo_tpu_torch.conjugate.families import Family
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.io.stage import Stager, host_arrays
from mimo_tpu_torch.io.stream import Prefetcher
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs, family_estep
from mimo_tpu_torch.ops.cuda_diag_predict import diag_predictive_cuda_sharded
from mimo_tpu_torch.ops.cuda_estep import BlockEStep, kernel_xts
from mimo_tpu_torch.ops.cuda_predict import gauss_predictive_cuda_sharded
from mimo_tpu_torch.ops.family_estep import chain_spec
from mimo_tpu_torch.parallel.mesh import (
    Sharded, local_mesh, shard_bounds, shard_data)
from mimo_tpu_torch.utils.data import one_hot, sample_batch_indices
from mimo_tpu_torch.utils.logging import span, spanned
from mimo_tpu_torch.utils.sanitize import finite_report
from mimo_tpu_torch.utils.stats import (
    entropy_categorical, normalize_log, sample_categorical_from_log)
from mimo_tpu_torch.utils.tree import (
    cast_floats, first_leaf, on_device, tree_leaves, tree_map, tree_map2,
    tree_where)

BACKENDS = ('auto', 'kernel', 'torch')
_CHUNK = 1 << 20      # points per step of the anchor init's distances
_RESP_ROWS = 1 << 16  # points a chunk of the random start's draw


class MFState(NamedTuple):
    """Mean-field state: the variational posterior."""
    components: Any          # family posterior struct (K-batched)
    gating: Any              # Dirichlet or StickBreaking posterior


class GibbsState(NamedTuple):
    """Blocked-Gibbs state: current conditionals + sampled likelihood params."""
    components: Any          # component posterior (conditional on labels)
    gating: Any              # gating posterior (conditional on labels)
    params: Any              # sampled likelihood params
    log_pi: torch.Tensor     # log of sampled mixture weights (K,)
    labels: torch.Tensor     # (N,) int32


class EMState(NamedTuple):
    """Maximum-likelihood EM state (non-Bayesian)."""
    params: Any              # likelihood params
    log_pi: torch.Tensor     # (K,)


def _elbo_loop(step, carry, maxiter, tol, lead=()):
    """Run `carry, vlb = step(carry, i)` for up to `maxiter` sweeps and
    return (carry, (maxiter,) trace); for C chains batched in one step
    (carry's leaves C-stacked, vlb (C,), `lead` (C,)) the trace is
    (C, maxiter).

    With tol=None every sweep runs and the loop never waits for the
    device. With `tol` (the reference's stopping rule: |vlb_t - vlb_{t-1}|
    < tol after at least two sweeps) the host compares each sweep's ELBO
    and stops early; the trace is constant-extended past the stop. A NaN
    ELBO never satisfies the rule, so divergence keeps iterating. Each
    chain stops on its own rule: a stopped chain keeps its carry and its
    last ELBO while the others run on, and the loop ends when every chain
    has stopped, as jax.vmap of the JAX package's while_loop runs."""
    trace, done, some = [], None, False
    for i in range(maxiter):
        if tol is not None and i >= 2:
            stop = torch.abs(trace[-1] - trace[-2]) < tol
            done = stop if done is None else done | stop
            flags = done.reshape(-1).tolist()
            if all(flags):
                break
            some = any(flags)
        with span('engines', 'sweep', i):
            new, vlb = step(carry, i)
        if some:
            carry = tree_where(done, carry, new)
            vlb = torch.where(done, trace[-1], vlb)
        else:
            carry = new
        trace.append(vlb)
    if not trace:
        return carry, torch.zeros(lead + (0,))
    trace = torch.stack(trace, -1)
    if trace.shape[-1] < maxiter:
        trace = torch.cat([trace, trace[..., -1:].expand(
            lead + (maxiter - trace.shape[-1],))], -1)
    return carry, trace


def resolve_backend(backend, x):
    """True -> run the CUDA kernel; False -> the plain PyTorch version
    (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend: {backend!r}; one of {BACKENDS}')
    if backend == 'kernel' and not x.is_cuda:
        raise ValueError("backend='kernel' needs the data on a CUDA device")
    return backend != 'torch' and x.is_cuda


def model_device(device):
    """The device a model's priors are built on: `device` when given,
    else the current CUDA device. Without a card that raises: pass
    device='cpu' to build on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: models are built on the card "
                           "by default; pass device='cpu' to build on the "
                           "CPU")
    return torch.device('cuda', torch.cuda.current_device())


def _stack(trace, like):
    """The (maxiter,) trace of a fit loop's per-sweep scalars; (C,
    maxiter) for the chains' (C,) scalars."""
    if not trace:
        return torch.zeros((0,), dtype=like.dtype, device=like.device)
    return torch.stack(trace, -1)


def stack_trees(trees):
    """A list of C trees of one structure -> one tree with C-stacked
    leaves (a parallel.mesh.Sharded's shards stacked shard by shard)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, Sharded):
        return first._replace(shards=tuple(
            torch.stack(s) for s in zip(*(t.shards for t in trees))))
    items = [stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return type(first)(*items) if hasattr(first, '_fields') else tuple(items)


def _stack_lead(tree, c):
    """Replicate every leaf over a leading axis of size c (the chains, or
    a nested model's clusters)."""
    return tree_map(lambda a: a.expand((c,) + a.shape).contiguous(), tree)


def _generators(key, device, chains):
    """The fit's generators on `device`: one from `key`, or with `chains`
    one a chain from the keys in `key` (an int64 tensor (C,) or a sequence
    of int seeds or generators)."""
    if not chains:
        return [_as_generator(key, device)]
    if isinstance(key, torch.Tensor):
        key = key.reshape(-1).tolist()
    if key is None or not len(key):
        raise ValueError('chains=True needs a sequence of chain keys')
    return [_as_generator(k, device) for k in key]


def _over_chains(chains):
    """torch.func.vmap over the chains' leading axis, or for one unbatched
    fit the function itself: the engines' K-sized algebra is written once
    and runs either way."""
    if chains:
        return vmap
    return lambda fn, **_: fn


def batch_generator(gens):
    """The generator of the chains' batched draws (torch.func.vmap with
    randomness='different' draws every chain's from one generator): seeded
    from one draw of each chain's own generator, so the same keys give the
    same chains. Reads the C draws to the host once."""
    dev = gens[0].device
    draws = torch.cat([torch.randint(0, 2 ** 62, (1,), generator=g,
                                     dtype=torch.int64, device=dev)
                       for g in gens]).tolist()
    seed = 0
    for v in draws:
        seed = (seed * 1_000_003 + v) % (2 ** 63)
    return torch.Generator(device=dev).manual_seed(seed)


class _Chains(NamedTuple):
    """The layout of a dense engine's chains (`BayesianMixture._dense_setup`):
    `size` C, or None for one fit (every map below is then the identity,
    so a single fit runs the same code unbatched); `data` the chain axis
    of the data tuples, 1 where each chain has its own data (held
    (N, C, ...), the point axis first, as the mesh splits it), None where
    the chains share the data; `priors` 0 where the model's priors carry
    a leading chain axis (`with_priors` of a C-stacked state), else None.
    The priors then enter the vmapped algebra as arguments."""
    size: Any = None
    data: Any = None
    priors: Any = None

    def over(self, fn, in_dims=0, randomness='error'):
        """torch.func.vmap of fn over the chains, or fn for one fit."""
        if self.size is None:
            return fn
        return vmap(fn, in_dims=in_dims, randomness=randomness)

    def stack(self, trees):
        """The chains' trees, one a chain, stacked on a leading axis (the
        one tree of a single fit)."""
        return trees[0] if self.size is None else stack_trees(trees)

    @property
    def lead(self):
        """The chains' leading shape: () for one fit, else (C,)."""
        return () if self.size is None else (self.size,)


def _gather(data, idx, ch):
    """The minibatch rows idx (B,) of a data tuple, or the chains' own
    rows idx (C, B) in one gather a tensor: (C, B, ...) from the shared
    (N, ...) data or from the chains' own (N, C, ...)."""
    if ch.data is None:
        return tuple(a[idx] for a in data)
    col = torch.arange(ch.size, device=idx.device)[:, None]
    return tuple(a[idx, col] for a in data)


class BayesianMixture:
    """A Bayesian mixture of `K` conjugate-family components with a
    Dirichlet or stick-breaking (DP) gating prior. `self` holds the
    Family's functions and the prior tensors; every fit is a function of
    (priors, data, generator)."""

    def __init__(self, gating_prior, components_prior, family: Family):
        self.gating_prior = gating_prior
        self.components_prior = components_prior
        self.family = family
        self.size = gating_prior.dim

    # -- functional pieces ----------------------------------------------------

    def expected_log_complete(self, state: MFState, data):
        """E_q[log p(x, z=k)] -> (N, K)."""
        return (self.family.ell(state.components, data)
                + state.gating.expected_log_pi()[None, :])

    def expected_responsibilities(self, state: MFState, data):
        resp, _ = normalize_log(self.expected_log_complete(state, data))
        return resp

    def log_complete_likelihood(self, params, log_pi, data):
        """log p(x, z=k) under plug-in params -> (N, K)."""
        return self.family.loglik(params, data) + log_pi[None, :]

    def _mf_update(self, data, resp, point_weights=None) -> MFState:
        """Posterior from responsibilities resp (N, K); optional per-point
        weights (N,) scale each point's statistics (nested-mixture cluster
        weights, or zero-weight padding)."""
        if point_weights is not None:
            resp = resp * point_weights[:, None]
        stats = self.family.suff_stats(data, resp)
        return MFState(
            components=self.family.update(self.components_prior, stats),
            gating=self.gating_prior.update(torch.sum(resp, 0)))

    def elbo(self, state: MFState, data, resp):
        """Variational lower bound: data term + label terms - sum_k
        KL(comp_k) - KL(gating)."""
        return self._elbo_under(self.components_prior, self.gating_prior,
                                state, data, resp)

    def _elbo_under(self, cp, gp, state, data, resp):
        """`elbo` against the priors (cp, gp)."""
        data_term = torch.sum(resp * self.family.ell(state.components, data))
        label_term = (state.gating.label_elbo_terms(resp)
                      + torch.sum(entropy_categorical(resp, dim=-1)))
        kl_comp = torch.sum(self.family.kl(state.components, cp))
        kl_gating = torch.sum(state.gating.kl_divergence(gp))
        return data_term + label_term - kl_comp - kl_gating

    # -- the dense engines' chains -------------------------------------------

    def _dense_setup(self, data, key, chains, mesh):
        """(the data's `_Shards`, the generators, the `_Chains`) of a dense
        engine: one generator from `key`, or with `chains` one a chain
        from the C keys in `key`. With `chains`, data whose arrays are
        (C, N, ...) is each chain's own (the JAX package's vmap over the
        data), and priors with a leading chain axis are each chain's
        own."""
        data = as_data(data)
        own = (chains and isinstance(data[0], torch.Tensor)
               and data[0].dim() == 3)
        if own:
            data = tuple(a.movedim(0, 1) for a in data)
        sh = _Shards(mesh, data, 'torch')
        gens = _generators(key, sh.device, chains)
        own_priors = self.gating_prior[0].dim() == 2
        if own_priors and not chains:
            raise ValueError('priors with a chain axis need chains=True')
        for size, what in ((sh.parts[0][0].shape[1] if own else None,
                            'data'),
                           (self.gating_prior[0].shape[0] if own_priors
                            else None, 'priors')):
            if chains and size is not None and size != len(gens):
                raise ValueError(f'{len(gens)} chain keys, {size} chains '
                                 f'of {what}')
        return sh, gens, self._model_chains(len(gens) if chains else None,
                                            1 if own else None)

    def _model_chains(self, size, data=None):
        """The `_Chains` of `size` chains (None: one fit) with the data's
        chain axis `data`, under this model's priors."""
        return _Chains(size, data,
                       0 if self.gating_prior[0].dim() == 2 else None)

    def _chain_posterior(self, ch, stats, counts):
        """The posterior of each chain from its statistics and counts,
        under its priors."""
        fam = self.family

        def post(cp, gp, s, c):
            return MFState(components=fam.update(cp, s), gating=gp.update(c))
        return ch.over(post, (ch.priors, ch.priors, 0, 0))(
            self.components_prior, self.gating_prior, stats, counts)

    def _chain_points(self, fn, tree, part, ch):
        """fn(tree, part) -> (N, K), the family's ell of a posterior or
        loglik of plug-in params; the chains' (C, N, K) from their
        C-stacked tree: one call over the flat C K components where the
        chains share the data and every leaf of the tree has the
        component axis (a part shared within a chain, as a tied slope or
        a hierarchical hyper-posterior, has none), else vmapped over the
        chains."""
        if ch.size is None:
            return fn(tree, part)
        lead = (ch.size, self.size)
        if ch.data is None and all(a.dim() >= 2 and a.shape[:2] == lead
                                   for a in tree_leaves(tree)):
            return fn(tree_map(lambda a: a.flatten(0, 1), tree),
                      part).unflatten(-1, lead).movedim(1, 0)
        return ch.over(fn, (0, ch.data))(tree, part)

    def _chain_stats(self, part, resp, ch, point_weights=None):
        """(stats, counts) of the responsibilities resp (N, K), each
        point's scaled by point_weights (N,) where given; the chains'
        C-stacked ones from their (C, N, K): one call over the flat
        (N, C K) weights where the chains share the data (a vmapped
        suff_stats would run its products as a batched matmul), else
        vmapped over the chains."""
        if point_weights is not None:
            resp = resp * point_weights[:, None]
        if ch.size is None:
            return self.family.suff_stats(part, resp), torch.sum(resp, 0)
        counts = torch.sum(resp, -2)
        if ch.data is None:
            c, n, k = resp.shape
            stats = self.family.suff_stats(
                part, resp.movedim(0, 1).reshape(n, c * k))
            return tree_map(lambda a: a.unflatten(0, (c, k)), stats), counts
        return ch.over(self.family.suff_stats, (ch.data, 0))(part,
                                                             resp), counts

    def _chain_resp(self, state, part, ch):
        """Each chain's expected responsibilities of the points `part`."""
        ell = self._chain_points(self.family.ell, state.components, part, ch)
        return normalize_log(ell + ch.over(lambda g: g.expected_log_pi())(
            state.gating)[..., None, :])[0]

    def _random_stats(self, sh, gens, ch):
        """(stats, counts) of each chain's random-responsibility start
        over the `_Shards` sh: one seed drawn from each chain's
        generator, each shard drawing only its own rows of the draw over
        the global N (`_random_resp`); one reduction for every chain."""
        seeds = [_resp_seed(g) for g in gens]
        return sh.reduce_stats(lambda part, lo, hi: self._chain_stats(
            part, ch.stack([_random_resp(s, hi - lo, self.size, sh.dtype,
                                         part[0].device, lo)
                            for s in seeds]), ch))

    def _estep_spec(self):
        """EStepSpec for the fused engines; None when the family has none.
        Overridden by concrete models."""
        return None

    @staticmethod
    def _fused_setup(data, key, chains, backend, spec, mesh, block_size):
        """(data, generators, spec) of a fused engine: the data as its
        `_Shards` over `mesh` (without one, over the one position of the
        data's device: an unsharded fit is the one-shard case), one
        generator from `key` on the first shard's device, or with `chains`
        one a chain from the keys in `key`, and then the chains' spec
        (family_estep.chain_spec)."""
        data = _Shards(mesh, data, backend, block_size)
        return (data, _generators(key, data.device, chains),
                chain_spec(spec) if chains else spec)

    def _random_start(self, data, gens, chains):
        """The random-responsibility start of each chain over the
        `_Shards` `data`, drawn and reduced one chain at a time from its
        own generator (the (C, N, K) responsibilities never exist)."""
        starts = [self._posterior(*self._random_stats(data, [g], _Chains()))
                  for g in gens]
        return stack_trees(starts) if chains else starts[0]

    def _posterior(self, stats, counts):
        return MFState(components=self.family.update(self.components_prior,
                                                     stats),
                       gating=self.gating_prior.update(counts))

    @spanned('engines')
    def fit_vi_fused(self, data, key=None, maxiter=250, tol=None,
                     block_size=131072, init_state=None, randomize=True,
                     backend='auto', chains=False, mesh=None):
        """Mean-field VI with the fused E-step (kernel B1 on CUDA, over
        the family's feature map): the N x K responsibilities never
        exist. The ELBO trace reports
        ELBO(state_t) exactly (lse identity). `tol` stops early once
        |dELBO| < tol. `key`: an int seed or a torch.Generator on the
        data's device. The kernel runs in float32; its statistics are cast
        back to the data's dtype. Returns (MFState, vlb trace).

        With `chains`, `key` holds C chain keys and the fit runs C chains
        as one program (see the module docstring): a C-stacked
        `init_state` and MFState, (C, maxiter) traces, each chain
        stopping on its own `tol`; chain c equals the fit with key c.

        With `mesh` (a one-row mesh, see the module docstring) B1 runs
        once per non-empty shard a sweep, then one reduction.

        A family with prior constants (`Family.prior_consts`, NIW) builds
        them once a call, and each sweep's update hands its posterior's
        inverse scale (the aux) to the next sweep's KL beside the state:
        the KL then factors nothing (the call's first sweep builds the aux
        of its start)."""
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError('no fused E-step spec for this family')
        data, gens, spec = self._fused_setup(data, key, chains, backend,
                                             spec, mesh, block_size)
        over = _over_chains(chains)
        if randomize or init_state is None:
            state = self._random_start(data, gens, chains)
        else:
            state = init_state
        fam, cp = self.family, self.components_prior
        consts = None if fam.prior_consts is None else fam.prior_consts(cp)

        def kl(comp, gating, aux):
            kl_comp = (fam.kl(comp, cp) if consts is None
                       else fam.kl(comp, cp, consts, aux))
            return (torch.sum(kl_comp),
                    torch.sum(gating.kl_divergence(self.gating_prior)))

        def posterior(stats, counts):
            if consts is None:
                return self._posterior(stats, counts), ()
            comp, aux = fam.update(cp, stats, consts, with_aux=True)
            return MFState(comp, self.gating_prior.update(counts)), aux

        def step(carry, _):
            state, aux = carry
            with span('algebra', 'log_pi'):
                log_pi = over(lambda g: g.expected_log_pi())(state.gating)
            res = data.estep(spec, state.components, log_pi)
            with span('algebra', 'kl'):
                if aux is None:
                    aux = over(fam.psi_aux)(state.components)
                kl_comp, kl_gating = over(kl)(state.components, state.gating,
                                              aux)
            with span('algebra', 'posterior'):
                post, aux = over(posterior)(res.stats, res.counts)
            return (post, aux), res.lse - kl_comp - kl_gating

        # the plain path carries no aux; None: the first sweep builds it
        aux = () if consts is None else None
        (state, _), trace = _elbo_loop(step, (state, aux), maxiter, tol,
                                       (len(gens),) if chains else ())
        return finite_report((state, trace), 'fit_vi_fused')

    @spanned('engines')
    def fit_gibbs_fused(self, data, key=None, maxiter=100, block_size=131072,
                        backend='auto', chains=False, mesh=None):
        """Blocked Gibbs with the fused label sweep (kernel B2 on CUDA):
        plug-in log-densities, Gumbel-max labels from Philox keyed by
        (sweep seed, point index), and one-hot statistics; the N x K
        log-probs never exist. Per-sweep seeds come from the engine's
        generator and stay on the device. A family with a `gibbs_update`
        hook draws its posterior and params after the label sweep, from
        the statistics (the sweep then uses the previous params). Returns
        the final GibbsState.

        With `chains`, `key` holds C chain keys and the C chains run as
        one program: each chain's per-sweep seeds come from its own
        generator; the parameter and weight draws run under
        torch.func.vmap with randomness='different' from one generator
        seeded by the chains' (`batch_generator`), so the same keys give
        the same chains but a chain does not repeat the single-chain fit
        draw for draw. Returns the C-stacked GibbsState (labels (C, N)).

        With `mesh`, B2 runs once per non-empty shard a sweep with the
        shard's seed (shard 0 draws as the unsharded sweep), then one
        reduction of the one-hot statistics; the labels come back as a
        parallel.mesh.Sharded, one (n_j,) or (C, n_j) tensor a shard."""
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError('no fused Gibbs spec for this family')
        data, gens, spec = self._fused_setup(data, key, chains, backend,
                                             spec, mesh, block_size)
        dev = data.device
        over = _over_chains(chains)
        fam, cp = self.family, self.components_prior
        consts = None if fam.prior_consts is None else fam.prior_consts(cp)

        def update(stats):
            if consts is None:
                return fam.update(cp, stats)
            return fam.update(cp, stats, consts)

        lead = (len(gens),) if chains else ()
        comp, gating = cp, self.gating_prior
        if chains:
            comp, gating = _stack_lead(comp, lead[0]), _stack_lead(gating,
                                                                   lead[0])
        params = over(fam.mode_params)(comp)
        log_pi = torch.log(torch.full(lead + (self.size,), 1.0 / self.size,
                                      dtype=data.dtype, device=dev))
        labels = data.zero_labels(lead)
        seeds = torch.stack([torch.randint(0, 2 ** 62, (maxiter,),
                                           generator=g, dtype=torch.int64,
                                           device=dev) for g in gens], -1)
        seeds = seeds if chains else seeds[:, 0]
        gen = batch_generator(gens) if chains else gens[0]
        for i in range(maxiter):
            with span('engines', 'sweep', i):
                with span('algebra', 'draws'):
                    if fam.gibbs_update is None:
                        params = over(lambda q: fam.sample_params(gen, q),
                                      randomness='different')(comp)
                    log_pi = over(lambda g: torch.log(torch.clamp(
                        g.sample(gen), min=1e-37)),
                        randomness='different')(gating)
                labels, res = data.gibbs(spec, seeds[i], params, log_pi)
                with span('algebra', 'posterior'):
                    if fam.gibbs_update is None:
                        comp = over(update)(res.stats)
                    else:
                        comp, params = over(
                            lambda s: fam.gibbs_update(gen, cp, s),
                            randomness='different')(res.stats)
                    gating = over(self.gating_prior.update)(res.counts)
        return finite_report(
            GibbsState(components=comp, gating=gating, params=params,
                       log_pi=log_pi,
                       labels=(labels.shards[0] if mesh is None
                               else labels)),
            'fit_gibbs_fused')

    def _ml_log_pi(self, counts, n):
        # clip: an empty component (count 0 after f32 underflow) must not
        # poison the fit with log(0) = -inf
        return torch.log(torch.clamp(counts, min=1e-37) / n)

    def fit_em(self, data, key=None, maxiter=250, mesh=None, chains=False):
        """Likelihood-only EM: plug-in E-step and the closed-form weighted
        ML M-step, no priors, from the random-anchor init. Returns
        (EMState(params, log_pi), loglik trace). Needs the family's
        ml_update (the hierarchical families have none). With `mesh` (see
        fit_vi) the anchors and their scale come from the global N (three
        reductions, `_Shards.anchor_stats`) and a sweep makes one
        reduction of its statistics, counts and log-likelihood. With
        `chains`, `key` holds C chain keys: each chain's anchors come
        from its own generator, one chain at a time, and the sweeps run
        the C chains as one program (see fit_vi); C-stacked EMState,
        (C, maxiter) traces, chain c equal to the fit with key c."""
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; use fit_map')
        sh, gens, ch = self._dense_setup(data, key, chains, mesh)
        if ch.data is not None:
            raise ValueError('fit_em draws its anchors from shared data; '
                             'chains with their own data: fit_vi, fit_map, '
                             'fit_svi or fit_gibbs')
        stats, counts = ch.stack([sh.anchor_stats(
            self.family.suff_stats,
            _anchor_indices(g, sh.n, self.size, sh.device)) for g in gens])

        def plugin(stats, counts):
            params = ch.over(self.family.ml_update)(stats)
            log_pi = self._ml_log_pi(counts, sh.n)
            return params, log_pi, EMState(params, log_pi)

        state, _, trace = self._plugin_sweeps(sh, stats, counts, maxiter,
                                              plugin, ch)
        return finite_report((state, trace), 'fit_em')

    def _plugin_spec(self, alt_engine):
        """The plug-in (EM / MAP) E-step's spec: the family's, with the
        log-density from spec.theta_plugin(params) in place of the
        posterior-expected spec.theta(post) (EM and MAP E-steps are
        plug-in softmaxes, so they run on the same kernel B1)."""
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError(
                f'no fused plug-in spec for this family; use {alt_engine}')
        return spec._replace(theta=spec.theta_plugin)

    def fit_em_fused(self, data, key=None, maxiter=250, block_size=131072,
                     backend='auto', chains=False, mesh=None):
        """fit_em through the fused E-step: each sweep is kernel B1 (on
        CUDA data) fed spec.theta_plugin(ml params), so the N x K
        responsibilities never exist in the sweeps; the anchor init still
        forms each shard's (n_j, K) matrix and dense statistics once, and
        frees them before the first sweep. Returns (EMState(params, log_pi), loglik
        trace). With `chains`, `key` holds C chain keys: the anchor inits
        are formed and reduced one chain at a time and the sweeps run the
        C chains as one program; C-stacked EMState, (C, maxiter) traces,
        chain c equal to the fit with key c. `mesh` as in fit_vi_fused;
        the anchors and their distance scale come from the global N."""
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; use '
                'fit_map_fused')
        data, gens, spec = self._fused_setup(
            data, key, chains, backend, self._plugin_spec('fit_em'), mesh,
            block_size)
        n = data.n
        over = _over_chains(chains)
        starts = []
        for g in gens:
            stats, counts = data.anchor_stats(
                self.family.suff_stats,
                _anchor_indices(g, n, self.size, data.device))
            starts.append((self.family.ml_update(stats),
                           self._ml_log_pi(counts, n)))
        params, log_pi = stack_trees(starts) if chains else starts[0]
        trace = []
        for _ in range(maxiter):
            res = data.estep(spec, params, log_pi)
            params = over(self.family.ml_update)(res.stats)
            log_pi = self._ml_log_pi(res.counts, n)
            trace.append(res.lse)
        return finite_report((EMState(params, log_pi), _stack(trace, data)),
                             'fit_em_fused')

    def fit_map_fused(self, data, key=None, maxiter=250, block_size=131072,
                      randomize=True, backend='auto', chains=False,
                      mesh=None):
        """fit_map through the fused E-step: each sweep is kernel B1 (on
        CUDA data) fed spec.theta_plugin(mode params) with the gating
        mode's log weights. Starts from random responsibilities
        (`randomize` is accepted and unused, as in the JAX package).
        Returns (MFState, loglik trace): the data log-likelihood at each
        sweep's posterior mode. With `chains`, `key` holds C chain keys
        and the C chains run as one program: C-stacked MFState,
        (C, maxiter) traces, chain c equal to the fit with key c. `mesh`
        as in fit_vi_fused."""
        data, gens, spec = self._fused_setup(
            data, key, chains, backend, self._plugin_spec('fit_map'), mesh,
            block_size)
        over = _over_chains(chains)
        state = self._random_start(data, gens, chains)
        trace = []
        for _ in range(maxiter):
            params = over(self.family.mode_params)(state.components)
            log_pi = over(lambda g: torch.log(torch.clamp(
                g.mode(), min=1e-37)).to(data.dtype))(state.gating)
            res = data.estep(spec, params, log_pi)
            state = over(self._posterior)(res.stats, res.counts)
            trace.append(res.lse)
        return finite_report((state, _stack(trace, data)), 'fit_map_fused')

    @spanned('engines')
    def fit_vi(self, data, key=None, maxiter=250, tol=None, init_state=None,
               randomize=True, point_weights=None, mesh=None, chains=False):
        """Dense mean-field coordinate ascent. Returns (MFState, vlb
        trace). `randomize=True` starts from random responsibilities;
        pass `init_state` (e.g. from Gibbs) with randomize=False to warm
        start. `tol` stops once |dELBO| < tol (the trace is constant-
        extended to maxiter). `point_weights` (N,) scales each point's
        statistics.

        With `mesh` (a one-row mesh; the dense engines over a mesh): each
        shard's (n_j, K) responsibilities stay on its device and a sweep
        makes one reduction of their statistics, counts and ELBO point
        sums; the start makes two (the random responsibilities'
        statistics, then those of the start state's). The random start is
        keyed by the point index, so the fit is the unsharded one up to
        the order of its sums. Without `mesh` the same code runs over the
        one position of the data's device.

        With `chains`, `key` holds C chain keys and the C chains run as
        one program (the counterpart of jax.vmap over the JAX engine):
        each chain's random start from its own generator, the (C, n_j, K)
        responsibilities of a shard from one flat ell and one flat
        statistics call over C K components where the family allows it
        (`_chain_points`, `_chain_stats`), the K-sized algebra under
        torch.func.vmap over C, one reduction a sweep for every chain, and
        each chain stopping on its own `tol`. Chain c equals the fit with
        key c. Data (C, N, ...) is each chain's own, and priors with a
        leading chain axis (`with_priors` of a C-stacked state) each
        chain's own. A C-stacked `init_state`, MFState and (C, maxiter)
        traces."""
        sh, gens, ch = self._dense_setup(data, key, chains, mesh)
        pws = _weight_parts(sh.mesh, point_weights, len(sh.parts))
        fam, cp, gp = self.family, self.components_prior, self.gating_prior

        def sweep_tree(part, pw, st):
            st = on_device(st, part[0].device)
            ell = self._chain_points(fam.ell, st.components, part, ch)
            resp, _ = normalize_log(ell + ch.over(
                lambda g: g.expected_log_pi())(st.gating)[..., None, :])
            counts = () if pw is None else (torch.sum(resp, -2),)
            return self._chain_stats(part, resp, ch, pw) + counts + (
                torch.sum(resp * ell, (-2, -1)),
                torch.sum(entropy_categorical(resp, dim=-1), -1))

        def reduce_sweep(st, kind):
            return sh.reduce_each(
                lambda j: sweep_tree(sh.parts[j], pws[j], st),
                lambda: sweep_tree(sh.zero_part(), _zero_weight(pws), st),
                kind)

        if randomize or init_state is None:
            seeds = [_resp_seed(g) for g in gens]

            def resp_of(j):
                return ch.stack([_random_resp(
                    s, sh.rows(j), self.size, sh.dtype,
                    sh.parts[j][0].device, sh.bounds[j][0]) for s in seeds])
        else:
            def resp_of(j):
                part = sh.parts[j]
                return self._chain_resp(
                    on_device(init_state, part[0].device), part, ch)
        state = self._chain_posterior(ch, *sh.reduce_each(
            lambda j: self._chain_stats(sh.parts[j], resp_of(j), ch, pws[j]),
            lambda: self._chain_stats(
                sh.zero_part(), torch.zeros(ch.lead + (1, self.size),
                                            dtype=sh.dtype, device=sh.device),
                ch, _zero_weight(pws)), 'start'))

        def bound(cp, gp, st, counts, data_term, entropy):
            return (data_term + (st.gating.label_elbo_terms(counts[None, :])
                                 + entropy)
                    - torch.sum(fam.kl(st.components, cp))
                    - torch.sum(st.gating.kl_divergence(gp)))

        def step(carry, _):
            state = self._chain_posterior(ch, *carry[1][:2])
            out = reduce_sweep(state, 'sweep')
            counts = out[1] if pws[0] is None else out[2]
            return (state, out), ch.over(
                bound, (ch.priors, ch.priors, 0, 0, 0, 0))(
                    cp, gp, state, counts, out[-2], out[-1])

        (state, _), vlb = _elbo_loop(
            step, (state, reduce_sweep(state, 'start')), maxiter, tol,
            ch.lead)
        return finite_report((state, vlb), 'fit_vi')

    def fit_svi(self, data, key=None, maxiter=500, step_size=1e-2,
                batch_size=128, init_state=None, randomize=True,
                track_elbo=False, forgetting=None, delay=1.0, mesh=None,
                chains=False):
        """Stochastic natural-gradient VI: one random minibatch per step
        (`utils.data.sample_batch_indices`), blended in natural space.
        The step size is fixed (the reference's rule) unless `forgetting`
        in (0.5, 1] asks for the Robbins-Monro schedule rho_t = step_size
        (t + 1 + delay)^-forgetting. Starts from random responsibilities
        unless `init_state` is given (`randomize` is accepted and unused,
        as in the JAX package). Returns (MFState, vlb trace): the
        full-data ELBO after each step with track_elbo, else zeros.

        With `mesh` (a one-row mesh over d data shards) every step draws
        batch_size // d points from each shard, from a generator a shard
        seeded from one draw of the key's and the shard index (a
        stratified minibatch: the gather never leaves the shard), takes
        their statistics through the fused E-step (B1 once per shard on
        CUDA shards) and makes one reduction; the natural-
        space blend is K-sized. track_elbo and a batch_size that d does
        not divide raise, as in the JAX package.

        With `chains`, `key` holds C chain keys and the C chains run as
        one program: each chain draws its start and its minibatch indices
        from its own generator, one gather serves every chain, and the
        step's algebra runs under torch.func.vmap over C, so chain c
        equals the fit with key c. Data (C, N, ...) and priors with a
        leading chain axis are each chain's own (as fit_vi). Over a
        mesh each chain's E-step runs on its own minibatch (B1 once a
        chain and shard) and one reduction serves every chain."""
        if mesh is not None:
            return self._fit_svi_mesh(data, key, maxiter, step_size,
                                      batch_size, init_state, track_elbo,
                                      forgetting, delay, mesh, chains)
        sh, gens, ch = self._dense_setup(data, key, chains, None)
        data, n, dtype, dev = sh.parts[0], sh.n, sh.dtype, sh.device
        fam, cp, gp = self.family, self.components_prior, self.gating_prior
        scale = batch_size / n
        if init_state is None:
            state = self._chain_posterior(ch, *self._chain_stats(
                data, ch.stack([_random_resp(g, n, self.size, dtype, dev)
                                for g in gens]), ch))
        else:
            state = init_state

        def full_elbo(cp, gp, st, x):
            resp, _ = normalize_log(fam.ell(st.components, x)
                                    + st.gating.expected_log_pi()[None, :])
            return self._elbo_under(cp, gp, st, x, resp)

        pin = ch.priors
        trace = torch.zeros(ch.lead + (maxiter,), dtype=dtype, device=dev)
        for t in range(maxiter):
            rho = (step_size if forgetting is None
                   else step_size * (t + 1.0 + delay) ** -forgetting)
            idx = ch.stack([sample_batch_indices(g, n, batch_size)
                            for g in gens])
            state = ch.over(self._svi_step, (pin, pin, 0, 0, None, None))(
                cp, gp, state, _gather(data, idx, ch), scale, rho)
            if track_elbo:
                trace[..., t] = ch.over(full_elbo, (pin, pin, 0, ch.data))(
                    cp, gp, state, data)
        return finite_report((state, trace), 'fit_svi')

    def _fit_svi_mesh(self, data, key, maxiter, step_size, batch_size,
                      init_state, track_elbo, forgetting, delay, mesh,
                      chains):
        """fit_svi over a mesh (see fit_svi)."""
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError(
                'fit_svi(mesh=) takes the minibatch statistics through the '
                'fused E-step; this family has no spec')
        n_dev = mesh.shape['data']
        if track_elbo:
            raise ValueError('track_elbo with mesh= is unsupported')
        if batch_size % n_dev:
            raise ValueError(f'batch_size={batch_size} must be a multiple '
                             f'of the data-mesh size {n_dev}')
        data = as_data(data)
        if chains and isinstance(data[0], torch.Tensor) and data[0].dim() == 3:
            raise ValueError('fit_svi(mesh=) takes data the chains share')
        shards = _Shards(mesh, data, 'auto', 131072)
        if shards.any_empty:
            raise ValueError(f'N={shards.n} leaves a shard of the '
                             f'{n_dev}-shard mesh empty: SVI draws from '
                             'every shard')
        gens = _generators(key, shards.device, chains)
        ch = self._model_chains(len(gens) if chains else None)
        if chains:
            spec = chain_spec(spec)
        scale = batch_size / shards.n
        if init_state is None:
            state = self._chain_posterior(
                ch, *self._random_stats(shards, gens, ch))
        else:
            state = init_state
        gens = [shards.generators(g) for g in gens]
        local_b = batch_size // n_dev
        pin = ch.priors
        for t in range(maxiter):
            rho = (step_size if forgetting is None
                   else step_size * (t + 1.0 + delay) ** -forgetting)
            batches = []
            for j, part in enumerate(shards.parts):
                idx = ch.stack([sample_batch_indices(g[j], part[0].shape[0],
                                                     local_b) for g in gens])
                batches.append(_gather(part, idx, ch))
            log_pi = ch.over(lambda g: g.expected_log_pi())(state.gating)
            res = (shards.estep(spec, state.components, log_pi, batches)
                   if ch.size is None else
                   shards.estep_own(spec, state.components, log_pi, batches))
            state = ch.over(self._svi_blend, (pin, pin, 0, 0, 0, None, None))(
                self.components_prior, self.gating_prior, state, res.stats,
                res.counts, scale, rho)
        return finite_report(
            (state, torch.zeros(ch.lead + (maxiter,), dtype=shards.dtype,
                                device=shards.device)), 'fit_svi')

    def _svi_step(self, cp, gp, state, batch, scale, rho):
        """One natural-gradient step on a minibatch at stochastic scale
        B/N and step size rho, against the priors (cp, gp)."""
        resp = self.expected_responsibilities(state, batch)
        return self._svi_blend(cp, gp, state,
                               self.family.suff_stats(batch, resp),
                               torch.sum(resp, 0), scale, rho)

    def _svi_blend(self, cp, gp, state, stats, counts, scale, rho):
        """The natural-space blend of an SVI step from a minibatch's
        statistics and counts, against the priors (cp, gp)."""
        return MFState(
            components=self.family.svi_blend(state.components, cp, stats,
                                             scale, rho),
            gating=gp.svi_blend(state.gating, counts, scale, rho))

    # -- out-of-core ---------------------------------------------------------

    def _stream_setup(self, backend, transfer_dtype):
        """(device, dtype, stage on the card?, kernel?) of a stream engine:
        the data lands where the model's priors lie, in their dtype."""
        leaf = first_leaf(self.components_prior)
        if transfer_dtype not in (None, torch.bfloat16, torch.float16):
            raise ValueError('transfer_dtype: None, torch.bfloat16 or '
                             f'torch.float16, got {transfer_dtype!r}')
        return (leaf.device, leaf.dtype, leaf.is_cuda,
                resolve_backend(backend, leaf))

    def fit_svi_stream(self, next_batch, total_size, key=None, maxiter=500,
                       step_size=1e-2, batch_size=128, init_state=None,
                       forgetting=None, delay=1.0, group=16, prefetch=2,
                       transfer_dtype=None, mesh=None):
        """Out-of-core SVI: the host supplies minibatches (e.g. from an
        io.MmapDataset over a file larger than host or device memory) and
        natural-gradient steps run one per batch on the model's device.

        `next_batch(i)` -> an array or a tuple of arrays (numpy or CPU
        tensors) with leading dim batch_size; `total_size` is N for the
        stochastic scale B/N. `forgetting` / `delay` give the
        Robbins-Monro schedule (see fit_svi), computed in float32 as the
        JAX package computes it. Without `init_state` the start is one
        update from random responsibilities on batch 0. Returns the final
        MFState.

        `group` host batches are read and stacked per reader item (on
        the card: one pinned stack and one host-to-device copy a group);
        a ragged last group repeats its last batch with step size 0, as
        the reference pads it. `prefetch` is the reader queue's depth;
        the batch order, and so the result, does not depend on it.

        `transfer_dtype` (torch.bfloat16 or torch.float16) casts batches
        on the host, halving the bytes over the bus; the card upcasts them
        to the state's dtype. The JAX docstring's premise that the E-step
        rounds its operands to bf16 anyway does not hold here: the steps
        run in the state's dtype, so the cast is error the fit would not
        otherwise make. Off by default.

        With `mesh` (a one-row mesh, see the module docstring) every
        process streams its own rows: `next_batch(i)` returns this
        process's rows of global batch i, which split contiguously over
        its positions (parallel.mesh.shard_bounds); `batch_size` and
        `total_size` stay global. A group is staged once in the kernels'
        layout (on the card: one pinned fill and one copy a device), and
        each step's minibatch statistics go through the fused E-step, B1
        once per non-empty shard on the card, with one reduction a step;
        the blend is K-sized. The random start over batch 0 is keyed by
        the global point index, as fit_svi's; the ragged last group is not
        padded."""
        if mesh is not None:
            return self._fit_svi_stream_mesh(
                next_batch, total_size, key, maxiter, step_size, batch_size,
                init_state, forgetting, delay, group, prefetch,
                transfer_dtype, mesh)
        dev, dtype, staged, _ = self._stream_setup('auto', transfer_dtype)
        wire = transfer_dtype or torch.float32
        gen = _as_generator(key, dev)
        scale = batch_size / total_size
        group = max(1, min(group, maxiter))
        if init_state is None:
            batch0 = _to_device(host_arrays(next_batch(0)), None, dtype, dev)
            state = self._mf_update(batch0, _random_resp(
                gen, batch0[0].shape[0], self.size, dtype, dev))
        else:
            state = init_state
        stager = (Stager(dev, wire, transpose=False, dtype=dtype)
                  if staged else None)

        def make_group(gi):
            """Read and stack one group of host batches (reader thread)."""
            g0 = gi * group
            g = min(group, maxiter - g0)
            bs = [host_arrays(next_batch(g0 + j)) for j in range(g)]
            bs = bs + [bs[-1]] * (group - g)
            rhos = _svi_rhos(g0, group, step_size, forgetting, delay)
            rhos[g:] = 0.0
            if stager is not None:
                return stager.fill(bs), rhos
            stacks = tuple(np.stack([b[a] for b in bs])
                           for a in range(len(bs[0])))
            return _to_device(stacks, transfer_dtype, dtype, dev), rhos

        with Prefetcher(make_group, -(-maxiter // group),
                        depth=prefetch) as pf:
            try:
                for item, rhos in pf:
                    if stager is not None:
                        slot, cols, _ = stager.put(item)
                        item = tuple(c.reshape(group, -1, c.shape[1])
                                     for c in cols)
                    rhos = torch.from_numpy(rhos)
                    for j in range(group):
                        state = self._svi_step(
                            self.components_prior, self.gating_prior, state,
                            tuple(b[j] for b in item), scale, rhos[j])
                    if stager is not None:
                        stager.release(slot)
            except BaseException:
                if stager is not None:
                    stager.close()
                raise
        return finite_report(state, 'fit_svi_stream')

    def _fit_svi_stream_mesh(self, next_batch, total_size, key, maxiter,
                             step_size, batch_size, init_state, forgetting,
                             delay, group, prefetch, transfer_dtype, mesh):
        """fit_svi_stream over a mesh (see fit_svi_stream)."""
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError(
                'fit_svi_stream(mesh=) takes the minibatch statistics '
                'through the fused E-step; this family has no spec')
        dev, dtype, _, use_kernel = self._stream_setup('auto',
                                                       transfer_dtype)
        mesh = mesh.one_row()
        devices = mesh.devices
        npos, (_, rank) = len(devices), _row_share(mesh)
        gen = _as_generator(key, dev)
        scale = batch_size / total_size
        group = max(1, min(group, maxiter))
        estep = BlockEStep(spec, use_kernel, 131072, dtype, mesh)
        if init_state is None:
            batch0 = host_arrays(next_batch(0))
            nb0 = batch0[0].shape[0]
            seed = _resp_seed(gen)
            trees = []
            for j, d in enumerate(devices):
                lo, hi = shard_bounds(nb0, npos, j)
                part = _to_device(tuple(a[lo:hi] for a in batch0), None,
                                  dtype, d)
                trees.append(_resp_stats(
                    self.family.suff_stats, part, _random_resp(
                        seed, hi - lo, self.size, dtype, d,
                        rank * nb0 + lo)) if hi > lo else None)
            state = self._posterior(*_reduce_trees(mesh, trees, lambda: (
                _resp_stats(self.family.suff_stats, tuple(
                    torch.zeros((1, a.shape[1]), dtype=dtype, device=dev)
                    for a in batch0),
                    torch.zeros((1, self.size), dtype=dtype, device=dev)))))
        else:
            state = init_state
        stagers = _stagers(devices, transfer_dtype or torch.float32)

        def make_group(gi):
            """Read one group of this process's batches and stage them
            (reader thread): each device's rows, step after step."""
            g0 = gi * group
            g = min(group, maxiter - g0)
            bs = [host_arrays(next_batch(g0 + j)) for j in range(g)]
            bounds = [[shard_bounds(b[0].shape[0], npos, j)
                       for j in range(npos)] for b in bs]
            rhos = _svi_rhos(g0, g, step_size, forgetting, delay)
            if stagers is None:
                return bounds, [_to_device(b, transfer_dtype, dtype,
                                           devices[0]) for b in bs], rhos
            return bounds, {d: _fill(st, [(b, [bd[j] for j in js])
                                          for b, bd in zip(bs, bounds)])
                            for d, (st, js) in stagers.items()}, rhos

        with Prefetcher(make_group, -(-maxiter // group),
                        depth=prefetch) as pf:
            try:
                for bounds, item, rhos in pf:
                    steps, slots = _group_shards(bounds, item, stagers,
                                                 devices, dtype,
                                                 not use_kernel)
                    rhos = torch.from_numpy(rhos)
                    for shards, rho in zip(steps, rhos):
                        estep.begin(state.components,
                                    state.gating.expected_log_pi())
                        estep.add(shards)
                        res = estep.end()
                        state = self._svi_blend(
                            self.components_prior, self.gating_prior, state,
                            res.stats, res.counts, scale, rho)
                    for st, slot in slots:
                        st.release(slot)
            except BaseException:
                for st, _ in (stagers or {}).values():
                    st.close()
                raise
        return finite_report(state, 'fit_svi_stream')

    def _fit_epoch_stream(self, read_block, n_blocks, kind, key, maxiter,
                          init_state, prefetch, backend, block_size,
                          transfer_dtype, mesh):
        """The engine of fit_{vi,map,em}_stream_full: each sweep is one
        pass over the dataset in host blocks, each block through the fused
        E-step (kernel B1 on the card, the blockwise twin on the CPU) with
        the sweep's theta formed once; the (K, m) statistics and the lse
        add across blocks on the device in the state's dtype, with no host
        read a block, so the streamed sweep is the in-memory fused sweep.
        Without `mesh` the sweep runs over the one position of the model's
        device; with one, each block's rows split over this process's
        positions and each shard's sums add across the blocks on its
        device. Either way a sweep makes the mesh's one reduction at its
        end. The trace stays on the device until the end."""
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError('no fused E-step spec for this family')
        if kind in ('map', 'em') and spec.theta_plugin is None:
            raise NotImplementedError('no fused plug-in spec for this family')
        if kind == 'em' and self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update')
        if n_blocks < 1:
            raise ValueError(f'n_blocks={n_blocks}: nothing to stream')
        if kind == 'em' and init_state is None and mesh is not None:
            raise NotImplementedError(
                'em anchor init is process-local; pass init_state with '
                'mesh= (e.g. from a probe-subset fit)')
        dev, dtype, _, use_kernel = self._stream_setup(backend,
                                                       transfer_dtype)
        sharded = mesh is not None
        mesh = mesh.one_row() if sharded else local_mesh(dev)
        world, rank = _row_share(mesh)
        gen = _as_generator(key, dev)
        estep = BlockEStep(spec if kind == 'vi' else spec._replace(
            theta=spec.theta_plugin), use_kernel, block_size, dtype, mesh)
        stagers = _stagers(mesh.devices, transfer_dtype or torch.float32)

        def blocks(need_data=True):
            return _stream_pass(read_block, n_blocks, prefetch, stagers,
                                transfer_dtype, dtype, mesh.devices,
                                need_data)

        def init_pass(resp_of):
            """Statistics and counts of one pass, each non-empty shard of
            each block weighted by resp_of(its data, its rows, the global
            index of its first row), added across the blocks on its
            device, then one reduction; and this process's row count."""
            trees, total, off = [None] * len(mesh.devices), 0, 0
            for blk in blocks():
                for j, ((data, _, n), (lo, _)) in enumerate(
                        zip(blk.shards, blk.bounds)):
                    if n:
                        t = _resp_stats(self.family.suff_stats, data,
                                        resp_of(data, n,
                                                off + rank * blk.n + lo))
                        trees[j] = (t if trees[j] is None
                                    else tree_map2(torch.add, trees[j], t))
                total += blk.n
                off += world * blk.n
            return _reduce_trees(mesh, trees, lambda: _resp_stats(
                self.family.suff_stats,
                tuple(torch.zeros((1, w), dtype=dtype, device=dev)
                      for w in blk.widths),
                torch.zeros((1, self.size), dtype=dtype, device=dev))), total

        if init_state is not None:
            state = init_state
        elif kind in ('vi', 'map') and not sharded:
            # one generator, drawn block by block: the layout differs from
            # the in-memory random start (pass init_state for equality)
            (stats, counts), _ = init_pass(lambda part, n, _: _random_resp(
                gen, n, self.size, dtype, dev))
            state = self._posterior(stats, counts)
        elif kind in ('vi', 'map'):
            # keyed by the global point index: the start over the mesh's
            # positions is the start over one position
            seed = _resp_seed(gen)
            (stats, counts), _ = init_pass(
                lambda part, n, start: _random_resp(
                    seed, n, self.size, dtype, part[0].device, start))
            state = self._posterior(stats, counts)
        else:   # em: anchors and their scale from block 0
            x0 = _to_device(host_arrays(read_block(0)), None, dtype, dev)[0]
            anchors = x0[_anchor_indices(gen, x0.shape[0], self.size, dev)]
            scale2 = anchor_scale(x0)
            (stats, counts), total = init_pass(
                lambda part, n, _: anchor_resp(part[0], anchors, scale2))
            state = EMState(self.family.ml_update(stats),
                            self._ml_log_pi(counts, total))

        def sweep(theta_src, log_pi):
            estep.begin(theta_src, log_pi)
            for blk in blocks(not use_kernel):
                estep.add(blk.shards)
            return estep.end()

        trace = []
        for _ in range(maxiter):
            if kind == 'vi':
                res = sweep(state.components,
                            state.gating.expected_log_pi())
                t = (res.lse
                     - torch.sum(self.family.kl(state.components,
                                                self.components_prior))
                     - torch.sum(state.gating.kl_divergence(
                         self.gating_prior)))
                state = self._posterior(res.stats, res.counts)
            elif kind == 'map':
                res = sweep(self.family.mode_params(state.components),
                            torch.log(torch.clamp(state.gating.mode(),
                                                  min=1e-37)).to(dtype))
                t = res.lse
                state = self._posterior(res.stats, res.counts)
            else:
                res = sweep(state.params, state.log_pi)
                t = res.lse
                state = EMState(self.family.ml_update(res.stats),
                                self._ml_log_pi(res.counts,
                                                torch.sum(res.counts)))
            trace.append(t)
        return finite_report((state, _stack(trace, first_leaf(state))),
                             f'fit_{kind}_stream_full')

    def fit_vi_stream_full(self, read_block, n_blocks, key=None, maxiter=50,
                           init_state=None, prefetch=2, backend='auto',
                           block_size=131072, transfer_dtype=None,
                           mesh=None):
        """Out-of-core full-data VI: fit_vi_fused's sweep with the dataset
        read a block at a time each sweep instead of held in device
        memory, so N is bounded by disk (the card holds one block).

        `read_block(i)` -> an (N_i, d) array or a tuple of arrays (numpy
        or CPU tensors) for i in range(n_blocks), e.g.
        `lambda i: ds.read_block(i * B, B)` over an io.MmapDataset;
        blocks may be ragged. On the card every block is one launch of
        kernel B1 (float32, statistics cast back to the model's dtype);
        on the CPU the blockwise twin runs `block_size` points at a time,
        so from `init_state` over blocks of block_size points the result
        equals fit_vi_fused's on the same data. Without `init_state` the
        start is one update from random responsibilities drawn block by
        block. `prefetch` is the reader queue's depth. `transfer_dtype`
        (torch.bfloat16 or torch.float16) casts blocks on the host and
        upcasts them on the device: on the card to B1's float32, on the
        CPU to the model's dtype; B1 keeps float32 accuracy through its
        TF32 splits, so bf16 on the wire is error B1 would not otherwise
        make. Returns (MFState, ELBO trace).

        With `mesh` (a one-row mesh, see the module docstring) every
        process streams its own rows: `read_block(i)` returns this
        process's rows of global block i, which split contiguously over
        its positions (parallel.mesh.shard_bounds; a ragged block gives
        ragged shards). On the card each device's rows are staged once a
        block and B1 runs once per non-empty shard on a column view of
        the staged buffer; each shard's partials add across the blocks of
        a sweep on its device and the sweep makes one reduction of
        K m8 + 1 floats, whatever the number of blocks. The random start
        is keyed by the global point index (across processes every process
        is taken to read as many rows of each block as this one), so it is
        the start over one position."""
        return self._fit_epoch_stream(read_block, n_blocks, 'vi', key,
                                      maxiter, init_state, prefetch, backend,
                                      block_size, transfer_dtype, mesh)

    def fit_map_stream_full(self, read_block, n_blocks, key=None, maxiter=50,
                            init_state=None, prefetch=2, backend='auto',
                            block_size=131072, transfer_dtype=None,
                            mesh=None):
        """Out-of-core full-data MAP-EM (fit_map_fused streamed; see
        fit_vi_stream_full). Returns (MFState, loglik trace)."""
        return self._fit_epoch_stream(read_block, n_blocks, 'map', key,
                                      maxiter, init_state, prefetch, backend,
                                      block_size, transfer_dtype, mesh)

    def fit_em_stream_full(self, read_block, n_blocks, key=None, maxiter=50,
                           init_state=None, prefetch=2, backend='auto',
                           block_size=131072, transfer_dtype=None,
                           mesh=None):
        """Out-of-core full-data likelihood EM (fit_em_fused streamed; the
        anchor start draws the K anchors, and the distance scale, from
        block 0). With `mesh` the anchor start raises, as the JAX
        package's does: pass `init_state`. Returns (EMState, loglik
        trace)."""
        return self._fit_epoch_stream(read_block, n_blocks, 'em', key,
                                      maxiter, init_state, prefetch, backend,
                                      block_size, transfer_dtype, mesh)

    # -- blocked Gibbs -------------------------------------------------------

    def _gibbs_sweep(self, state: GibbsState, data, gen, point_weights=None):
        """components | labels -> gating | labels -> labels | params.
        Returns (GibbsState, the data log-likelihood under the sweep's
        sampled params). For C chains (the state's leaves C-stacked,
        labels (C, N)) the statistics of every chain come from one call
        over the flat (N, C K) one-hot weights (`_gibbs_label_stats`), the
        draws run under torch.func.vmap with randomness='different' from
        `gen`, and the log-likelihoods are (C,)."""
        ch = self._model_chains(state.labels.shape[0]
                                if state.labels.dim() == 2 else None)
        comp_post, gating_post, params, log_pi = self._gibbs_draws(
            gen, *self._gibbs_label_stats(state.labels, data, point_weights,
                                          ch), ch)
        log_p = self._gibbs_log_p(params, log_pi, data, ch)
        labels = sample_categorical_from_log(gen, log_p).to(torch.int32)
        new = GibbsState(components=comp_post, gating=gating_post,
                         params=params, log_pi=log_pi, labels=labels)
        return new, torch.sum(torch.logsumexp(log_p, -1), -1)

    def _gibbs_label_stats(self, labels, data, point_weights, ch):
        """(stats, counts) of the one-hot labels (N,), or of the chains'
        (C, N) (`_chain_stats`: one call over the flat (N, C K) one-hot
        weights where the chains share the data), C-stacked."""
        resp = one_hot(labels.movedim(-1, 0), self.size,
                       dtype=data[0].dtype).movedim(0, -2)
        return self._chain_stats(data, resp, ch, point_weights)

    def _gibbs_draws(self, gen, stats, counts, ch):
        """components | labels -> gating | labels: the sweep's (component
        posterior, gating posterior, sampled params, log of the sampled
        weights) from `gen`, under the chains' priors, vmapped over the
        chains with randomness='different'."""
        fam = self.family

        def draw(cp, gp, s, c):
            if fam.gibbs_update is not None:
                comp_post, params = fam.gibbs_update(gen, cp, s)
            else:
                comp_post = fam.update(cp, s)
                params = fam.sample_params(gen, comp_post)
            gating_post = gp.update(c)
            return comp_post, gating_post, params, torch.log(
                torch.clamp(gating_post.sample(gen), min=1e-37))
        return ch.over(draw, (ch.priors, ch.priors, 0, 0),
                       randomness='different')(
            self.components_prior, self.gating_prior, stats, counts)

    def _gibbs_log_p(self, params, log_pi, data, ch):
        """The plug-in log p(x, z=k) -> (N, K), or the chains' (C, N, K)."""
        return ch.over(self.log_complete_likelihood, (0, 0, ch.data))(
            params, log_pi, data)

    def fit_gibbs(self, data, key=None, maxiter=100, init_labels='prior',
                  point_weights=None, init_state=None, track_loglik=False,
                  chains=False, mesh=None):
        """Dense blocked Gibbs sampling. Returns the final GibbsState, or
        (GibbsState, loglik trace) with track_loglik=True: the per-sweep
        data log-likelihood under the sampled params. `init_labels`:
        'prior' (labels drawn from a gating-prior sample) or 'random';
        pass a previous GibbsState as `init_state` to continue a chain.
        With `chains`, `key` holds C chain keys: each chain starts from
        its own generator and the sweeps run the C chains as one program
        (the sweep smc_gibbs runs), their draws from `batch_generator`; a
        C-stacked `init_state` and GibbsState, (C, maxiter) traces. Data
        (C, N, ...) and priors with a leading chain axis are each chain's
        own (as fit_vi).

        With `mesh` (see fit_vi) the labels stay on their shards (a
        parallel.mesh.Sharded of (n_j,) or (C, n_j) tensors) and a sweep
        makes one reduction of their statistics, counts and
        log-likelihood. The posterior, params and weights are drawn from
        the fit's generator (the chains' batch generator), as every
        process does alike; each shard draws its labels from its own
        generator (`_label_generators`): data shard 0's is the fit's, so
        a one-position mesh is the unsharded chain draw for draw. Without
        `mesh` the same code runs over the one position of the data's
        device."""
        sh, gens, ch = self._dense_setup(data, key, chains, mesh)
        pws = _weight_parts(sh.mesh, point_weights, len(sh.parts))
        lead = ch.lead
        lead_draw = shard0_draws(sh)

        if init_state is not None:
            labels = _label_parts(sh.mesh, init_state.labels)
            state = init_state
        else:
            cp, gp = self.components_prior, self.gating_prior
            per = [start_labels(sh, g, init_labels, self.size,
                                gp if ch.priors is None
                                else tree_map(lambda a: a[c], gp),
                                lead_draw) for c, g in enumerate(gens)]
            labels = [ch.stack([p[j] for p in per])
                      for j in range(len(sh.parts))]
            if chains and ch.priors is None:
                cp, gp = _stack_lead(cp, lead[0]), _stack_lead(gp, lead[0])
            state = GibbsState(
                components=cp, gating=gp,
                params=ch.over(self.family.mode_params)(cp),
                log_pi=torch.log(torch.full(lead + (self.size,),
                                            1.0 / self.size, dtype=sh.dtype,
                                            device=sh.device)),
                labels=None)
        gen = batch_generator(gens) if chains else gens[0]
        lgens = _label_generators(gen, sh)

        def tree(j, extra=()):
            return self._gibbs_label_stats(labels[j], sh.parts[j], pws[j],
                                           ch) + extra

        def probe(extra=()):
            return self._gibbs_label_stats(
                torch.zeros(lead + (1,), dtype=torch.int32,
                            device=sh.device),
                sh.zero_part(), _zero_weight(pws), ch) + extra

        stats, counts = sh.reduce_each(tree, probe, 'start')
        trace, lls = [], [None] * len(sh.parts)
        for _ in range(maxiter):
            comp, gating, params, log_pi = self._gibbs_draws(
                gen, stats, counts, ch)
            for j, part in enumerate(sh.parts):
                if sh.rows(j):
                    log_p = self._gibbs_log_p(*on_device(
                        (params, log_pi), part[0].device), part, ch)
                    labels[j] = sample_categorical_from_log(
                        lgens[j], log_p).to(torch.int32)
                    lls[j] = torch.sum(torch.logsumexp(log_p, -1), -1)
            lead_draw(lambda n: torch.rand(lead + (n, self.size),
                                           generator=gen, dtype=sh.dtype,
                                           device=gen.device))
            stats, counts, ll = sh.reduce_each(
                lambda j: tree(j, (lls[j],)),
                lambda: probe((torch.zeros(lead, dtype=sh.dtype,
                                           device=sh.device),)), 'sweep')
            state = GibbsState(components=comp, gating=gating, params=params,
                               log_pi=log_pi, labels=None)
            trace.append(ll)
        state = state._replace(labels=labels[0] if mesh is None else Sharded(
            tuple(labels), sh.positions, sh.n))
        if track_loglik:
            return finite_report((state, _stack(trace, counts)), 'fit_gibbs')
        return finite_report(state, 'fit_gibbs')

    # -- MAP EM ----------------------------------------------------------------

    def fit_map(self, data, key=None, maxiter=250, randomize=True,
                mesh=None, chains=False):
        """Dense MAP expectation-maximization: posterior update, then the
        mode's plug-in softmax, from random responsibilities (`randomize`
        is accepted and unused, as in the JAX package). Returns (MFState,
        loglik trace). With `mesh` (see fit_vi) the start takes one
        reduction and a sweep one, of its statistics, counts and
        log-likelihood; without one, the same over one position. With
        `chains`, `key` holds C chain keys and the C chains run as one
        program (see fit_vi; data (C, N, ...) and priors with a chain
        axis each chain's own): C-stacked MFState, (C, maxiter) traces,
        chain c equal to the fit with key c."""
        sh, gens, ch = self._dense_setup(data, key, chains, mesh)
        stats, counts = self._random_stats(sh, gens, ch)

        def plugin(stats, counts):
            state = self._chain_posterior(ch, stats, counts)
            return (ch.over(self.family.mode_params)(state.components),
                    ch.over(lambda g: torch.log(torch.clamp(
                        g.mode(), min=1e-37)))(state.gating),
                    state)

        _, pending, trace = self._plugin_sweeps(sh, stats, counts, maxiter,
                                                plugin, ch)
        return finite_report((self._chain_posterior(ch, *pending), trace),
                             'fit_map')

    def _plugin_sweeps(self, sh, stats, counts, maxiter, plugin, ch):
        """The dense plug-in sweeps (fit_map, fit_em) over `_Shards` from
        the start's (stats, counts): each sweep takes (params, log_pi, the
        sweep's state) = plugin(stats, counts), forms each shard's
        plug-in responsibilities (the chains' (C, n_j, K) as in fit_vi),
        and makes one reduction of their statistics, counts and
        log-likelihood. Returns (the last sweep's state, the pending
        (stats, counts), the trace)."""
        state, trace = None, []

        def tree(part, params, log_pi):
            params, log_pi = on_device((params, log_pi), part[0].device)
            resp, lognorm = normalize_log(
                self._chain_points(self.family.loglik, params, part, ch)
                + log_pi[..., None, :])
            return self._chain_stats(part, resp, ch) + (
                torch.sum(lognorm, -1),)

        for _ in range(maxiter):
            params, log_pi, state = plugin(stats, counts)
            stats, counts, ll = sh.reduce_each(
                lambda j: tree(sh.parts[j], params, log_pi),
                lambda: tree(sh.zero_part(), params, log_pi), 'sweep')
            trace.append(ll)
        return state, (stats, counts), _stack(trace, counts)

    # -- prediction ----------------------------------------------------------

    def predictive_log_weights(self, state: MFState):
        """log E_q[pi] — posterior-mean mixture weights."""
        return torch.log(torch.clamp(state.gating.mean(), min=1e-37))

    @spanned('engines')
    def log_predictive(self, state: MFState, data, dist='studentt',
                       backend='auto', mesh=None):
        """Posterior-predictive mixture log-density of full observations:
        logsumexp_k [log E[pi_k] + log pred_k(data)] -> (N,). `dist`:
        'studentt' or the moment-matched 'gaussian'. The kernel path
        serves NIW and HierTied posteriors through B3 (a HierTied
        posterior's predictive is the same Student-t surface with the
        shared hyper scale) and NG posteriors through B4 (Student-t) or
        B3 over the diagonal map (Gaussian), in float32, and casts the
        result back to the data's dtype; the plain path is the dense
        (N, K) computation. With `mesh` each shard is served on its
        device (one kernel launch a shard on CUDA shards, no collective)
        and the result stays sharded: a parallel.mesh.Sharded of (n_j,)
        tensors."""
        if dist not in ('studentt', 'gaussian'):
            raise ValueError(f'unknown dist: {dist!r}')
        if mesh is not None:
            first, parts = _mesh_parts(mesh, data)
            return first._replace(shards=tuple(self._log_predictive_parts(
                state, parts, dist, backend)))
        return self._log_predictive_parts(state, [_as_tuple(data)], dist,
                                          backend)[0]

    @spanned('models', 'predictive_parts')
    def _log_predictive_parts(self, state, parts, dist, backend):
        """log_predictive of each data tuple in `parts` (a mesh's shards,
        or the one whole): the kernels' coefficients are built once and
        each part is one launch on its device."""
        with span('algebra', 'coefficients'):
            log_w = self.predictive_log_weights(state)
        if resolve_backend(backend, parts[0][0]):
            kernels = {NIW: gauss_predictive_cuda_sharded,
                       HierTied: gauss_predictive_cuda_sharded,
                       NG: diag_predictive_cuda_sharded}
            serve = kernels.get(type(state.components))
            if serve is None:
                raise NotImplementedError(
                    'no serving kernel for '
                    f'{type(state.components).__name__} posteriors; use '
                    "backend='torch'")
            out = serve(state.components, log_w,
                        [part[0].to(torch.float32) for part in parts], dist)
            return [o.to(part[0].dtype) for o, part in zip(out, parts)]
        fn = (self.family.log_predictive if dist == 'studentt'
              else self.family.log_predictive_gaussian)
        return [torch.logsumexp(fn(state.components, part) + log_w[None, :],
                                -1) for part in parts]

    def used_labels(self, state: MFState, data, threshold=0):
        """Which components take more than `threshold` points by argmax
        responsibility -> (K,) bool."""
        resp = self.expected_responsibilities(state, _as_tuple(data))
        usage = torch.bincount(torch.argmax(resp, -1), minlength=self.size)
        return usage > threshold

    @property
    def nb_params(self):
        """Number of free likelihood parameters, for BIC/AIC-style model
        selection: gating K - 1 plus per component d + d(d+1)/2 (full
        Gaussian), 2d (diagonal), pq + p(p+1)/2 (linear), pq + p (diagonal
        linear). Undefined (raises) for tied and hierarchical families."""
        def comp_params(prior):
            if isinstance(prior, NIW):
                k, d = prior.mu.shape
                return k * (d + d * (d + 1) // 2)
            if isinstance(prior, NG):
                k, d = prior.mu.shape
                return k * 2 * d
            if isinstance(prior, MNW):
                k, p, q = prior.M.shape
                return k * (p * q + p * (p + 1) // 2)
            if isinstance(prior, MNG):
                k, p, q = prior.M.shape
                return k * (p * q + p)
            if isinstance(prior, tuple):          # product family (ILR)
                return sum(comp_params(p) for p in prior)
            raise NotImplementedError(
                f'nb_params undefined for {type(prior).__name__} (the '
                'reference also leaves tied/hierarchical undefined)')

        return (self.size - 1) + comp_params(self.components_prior)

    def with_priors(self, state: MFState) -> 'BayesianMixture':
        """A new model whose priors are this state's posteriors (the
        prior <- posterior re-anchoring API)."""
        return type(self)._from_parts(state.gating, state.components,
                                      self.family, like=self)

    @classmethod
    def _from_parts(cls, gating_prior, components_prior, family, like=None):
        obj = cls.__new__(cls)
        BayesianMixture.__init__(obj, gating_prior, components_prior, family)
        if like is not None:
            obj.__dict__.update({k: v for k, v in like.__dict__.items()
                                 if k not in obj.__dict__})
        return obj


def _as_tuple(data):
    return data if isinstance(data, tuple) else (data,)


def _to_device(arrays, wire, dtype, device):
    """Host arrays -> tensors on `device` in `dtype`, through `wire` (the
    stream engines' transfer_dtype) first when it is given."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if wire is not None:
            t = t.to(wire)
        out.append(t.to(device=device, dtype=dtype))
    return tuple(out)


def _weight_parts(mesh, weights, count):
    """Per-point weights (N,) as one tensor a position of the mesh (as
    the data is split), or `count` Nones without weights."""
    if weights is None:
        return [None] * count
    return [part[0] for part in _mesh_parts(mesh, weights)[1]]


def _zero_weight(parts):
    """One zero point's weight where the fit has weights, else None."""
    return None if parts[0] is None else parts[0].new_zeros((1,))


def _label_parts(mesh, labels):
    """A Gibbs state's labels as one int32 tensor a position of the
    one-row mesh: a parallel.mesh.Sharded's shards there, or an (N,) or
    the chains' (C, N) tensor split on its last axis."""
    if isinstance(labels, Sharded):
        return list(labels.on(mesh).shards)
    return [part[0].movedim(0, -1)
            for part in _mesh_parts(mesh, labels.movedim(-1, 0))[1]]


def _label_generators(gen, sh):
    """One generator a position of the `_Shards` `sh` for its Gibbs
    labels: `gen` itself for data shard 0 (so one position draws as the
    unsharded fit), else a generator on the shard's device seeded by
    gen's initial seed XOR the shard index x 0x9E3779B9."""
    d = sh.mesh.shape['data']
    base = gen.initial_seed()
    return [gen if p % d == 0 else torch.Generator(
        device=part[0].device).manual_seed(base ^ ((p % d) * 0x9E3779B9))
        for p, part in zip(sh.positions, sh.parts)]


def start_labels(sh, gen, init_labels, size, gating_prior, lead_draw):
    """One Gibbs chain's start labels in [0, size) over the `_Shards` sh,
    one int32 tensor a position: 'prior' draws the weights from
    `gating_prior` with `gen` (every process alike) and each shard's
    labels from its label generator (`_label_generators`), 'random'
    uniform labels the same way. `lead_draw(draw)` makes data shard 0's
    draw of `gen` where this process does not hold that shard, so that
    `gen` stays in step on every process."""
    if init_labels == 'random':
        def draw(n, g, dev):
            return torch.randint(0, size, (n,), generator=g, device=dev)
    else:   # 'prior'
        probs = torch.clamp(gating_prior.sample(gen), min=1e-37)

        def draw(n, g, dev):
            if not n:
                return torch.zeros((0,), dtype=torch.int64, device=dev)
            return torch.multinomial(probs.to(dev), n, replacement=True,
                                     generator=g)
    lead_draw(lambda n: draw(n, gen, gen.device))
    return [draw(sh.rows(j), g, part[0].device).to(torch.int32)
            for j, (part, g) in enumerate(zip(sh.parts,
                                              _label_generators(gen, sh)))]


def shard0_draws(sh):
    """`lead_draw` of the `_Shards` sh (see start_labels): draw(n) with
    data shard 0's n where no position of this process is that shard,
    else nothing. A process that holds shard 0 draws that shard's labels
    from the fit's generator; one that does not makes the same draw and
    drops it."""
    d = sh.mesh.shape['data']
    lo, hi = shard_bounds(sh.n, d, 0)

    def lead_draw(draw):
        if not any(p % d == 0 for p in sh.positions):
            draw(hi - lo)
    return lead_draw


def _svi_rhos(t0, n, step_size, forgetting, delay):
    """Steps t0 .. t0 + n - 1 of the SVI step-size schedule, float32 as
    the JAX package computes it: fixed, or Robbins-Monro with
    `forgetting`."""
    if forgetting is None:
        return np.full(n, step_size, np.float32)
    t = np.arange(t0, t0 + n, dtype=np.float32)
    return (step_size * (t + 1.0 + delay) ** -forgetting).astype(np.float32)


def _row_share(mesh):
    """(the number of processes a one-row mesh's row spans, this process's
    place among them): the row's positions come in runs of this process's
    count, one run a process, as make_mesh lays them out."""
    d, local = mesh.shape['data'], len(mesh.positions)
    return d // local, (mesh.positions[0] % d) // local


def _reduce_trees(mesh, trees, probe, kind='start'):
    """mesh.reduce_tree of the trees of the positions that had points
    (None where one had none); probe() gives a tree of the right shapes
    when this process has no such position."""
    trees = [t for t in trees if t is not None]
    like = trees[0] if trees else tree_map(torch.zeros_like, probe())
    return mesh.reduce_tree(trees, like, kind)


def _stagers(devices, wire):
    """One io.stage.Stager (kernel layout, float32 on the card) a CUDA
    device of `devices`, a one-row mesh's positions in this process, with
    the positions it holds: {device: (stager, [position index])}. None on
    the CPU, where nothing is staged."""
    if devices[0].type != 'cuda':
        return None
    out = {}
    for j, d in enumerate(devices):
        if d not in out:
            out[d] = (Stager(d, wire), [])
        out[d][1].append(j)
    return out


def _fill(stager, pieces):
    """Fill one pinned slot of `stager` (reader thread) from `pieces`, a
    list of (host arrays, row ranges of its positions): the ranges'
    rows in order, adjacent ranges as one chunk. None when they hold no
    row."""
    chunks = []
    for arrays, ranges in pieces:
        merged = []
        for lo, hi in ranges:
            if merged and merged[-1][1] == lo:
                merged[-1][1] = hi
            else:
                merged.append([lo, hi])
        chunks += [tuple(a[lo:hi] for a in arrays) for lo, hi in merged
                   if hi > lo]
    return stager.fill(chunks) if chunks else None


def _group_shards(bounds, item, stagers, devices, dtype, need_data):
    """The shards of a read item over this process's positions: `bounds`
    one list of position row ranges a step (a block, or a minibatch of an
    SVI group), `item` the steps' device tensors (CPU) or each device's
    filled slot (card). Returns (one list of (data, kernel views, rows) a
    position a step, (stager, slot) pairs to release once the work that
    reads them is issued). On the card each device's slot is copied once
    and a position's kernel views are a column view of the staged float32
    buffer (B1 reads it through its row stride, from any column), its
    data (when `need_data`) made from that view in `dtype`; an empty
    shard is (None, None, 0)."""
    if stagers is None:
        return [[(tuple(a[lo:hi].to(d) for a in step), None, hi - lo)
                 for (lo, hi), d in zip(bd, devices)]
                for bd, step in zip(bounds, item)], []
    steps = [[(None, None, 0)] * len(devices) for _ in bounds]
    slots = []
    for d, (st, js) in stagers.items():
        if item[d] is None:
            continue
        slot, xts, _ = st.put(item[d])
        slots.append((st, slot))
        off = 0
        for s, bd in enumerate(bounds):
            for j in js:
                n = bd[j][1] - bd[j][0]
                if n:
                    views = tuple(x[:, off:off + n] for x in xts)
                    steps[s][j] = (tuple(v.T.to(dtype) for v in views)
                                   if need_data else None, views, n)
                off += n
    return steps, slots


class _Block(NamedTuple):
    """A block of one pass of a streamed engine over this process's
    positions (`_stream_pass`)."""
    n: int            # this process's rows of the block
    bounds: list      # each position's rows [lo, hi) of them
    shards: list      # each position's (data, kernel views, rows)
    widths: tuple     # the inputs' widths


def _stream_pass(read_block, n_blocks, prefetch, stagers, transfer_dtype,
                 dtype, devices, need_data):
    """Yield each block of one pass over the dataset as a `_Block`, read
    `prefetch` blocks ahead on the reader thread, its rows split
    contiguously over `devices` (this process's mesh positions;
    parallel.mesh.shard_bounds) as `_group_shards` gives them: on the
    card one pinned fill and one copy a device (`_stagers`), on the CPU
    row views of the block in `dtype`."""
    npos = len(devices)

    def produce(i):
        arrays = host_arrays(read_block(i))
        nb = arrays[0].shape[0]
        bounds = [shard_bounds(nb, npos, j) for j in range(npos)]
        widths = tuple(a.shape[1] for a in arrays)
        if stagers is None:
            return nb, bounds, widths, [_to_device(arrays, transfer_dtype,
                                                   dtype, devices[0])]
        return nb, bounds, widths, {
            d: _fill(st, [(arrays, [bounds[j] for j in js])])
            for d, (st, js) in stagers.items()}

    with Prefetcher(produce, n_blocks, depth=prefetch) as pf:
        try:
            for nb, bounds, widths, item in pf:
                (shards,), slots = _group_shards([bounds], item, stagers,
                                                 devices, dtype, need_data)
                yield _Block(nb, bounds, shards, widths)
                for st, slot in slots:
                    st.release(slot)
        except BaseException:
            for st, _ in (stagers or {}).values():
                st.close()
            raise


def _as_generator(key, device):
    """A torch.Generator on `device` from an int seed (None -> 0), or the
    given generator after checking its device."""
    if isinstance(key, torch.Generator):
        if key.device.type != torch.device(device).type:
            raise ValueError(f'generator on {key.device}, data on {device}')
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


def _resp_seed(gen):
    """One draw of `gen`, as a host int: the key of a random-responsibility
    draw."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))


def _random_resp(gen, n, k, dtype, device, start=0):
    """Random normalized responsibilities, uniform in [1e-3, 1) before
    normalizing, made on the data's device: rows start..start+n-1 of a
    draw keyed by `gen`, a torch.Generator (one draw of it, `_resp_seed`)
    or that int seed. The rows come in fixed chunks of _RESP_ROWS points,
    chunk c drawn whole from a generator seeded by seed XOR c 0x9E3779B9,
    so point i's row depends only on (seed, i) and the device type: a mesh
    shard draws only its own rows (its two edge chunks whole) and they are
    those rows of the draw over all N, whatever the sharding."""
    seed = _resp_seed(gen) if isinstance(gen, torch.Generator) else gen
    r = torch.empty((n, k), dtype=dtype, device=device)
    g = torch.Generator(device=device)
    for c in range(start // _RESP_ROWS, -(-(start + n) // _RESP_ROWS)):
        g.manual_seed(seed ^ (c * 0x9E3779B9))
        chunk = torch.rand((_RESP_ROWS, k), generator=g, dtype=dtype,
                           device=device)
        lo = max(start, c * _RESP_ROWS)
        hi = min(start + n, (c + 1) * _RESP_ROWS)
        r[lo - start:hi - start] = chunk[lo - c * _RESP_ROWS:
                                         hi - c * _RESP_ROWS]
    r.mul_(1.0 - 1e-3).add_(1e-3)
    return r.div_(torch.sum(r, -1, keepdim=True))


def anchor_scale(x0):
    """The anchor init's squared distance scale: the mean per-dim
    variance of x0, at least 1e-6."""
    return torch.clamp(torch.mean(torch.var(x0, 0, correction=0)), min=1e-6)


def anchor_resp(x0, anchors, scale2=None):
    """(N, K) soft assignment of the points x0 (N, d) by their distance
    to the anchors (K, d), on the scale `scale2` (by default
    anchor_scale(x0)). The distances are formed a chunk of points at a
    time, so the (N, K, d) differences never exist at once."""
    n, k = x0.shape[0], anchors.shape[0]
    if scale2 is None:
        scale2 = anchor_scale(x0)
    resp = torch.empty((n, k), dtype=x0.dtype, device=x0.device)
    for s in range(0, n, _CHUNK):
        d2 = torch.sum(torch.square(x0[s:s + _CHUNK, None, :]
                                    - anchors[None]), -1)
        resp[s:s + _CHUNK] = normalize_log(-0.5 * d2 / scale2)[0]
    return resp


def _anchor_indices(gen, n, k, device):
    """K distinct random point indices, the ML engines' anchors."""
    return torch.randperm(n, generator=gen, device=device)[:k]


def _mesh_parts(mesh, data):
    """`data` (an array, a Sharded, or a tuple of either) over a one-row
    mesh: (the first array's Sharded, one data tuple a position)."""
    mesh = mesh.one_row()
    sharded = [shard_data(mesh, a) for a in as_data(data)]
    return sharded[0], list(zip(*(sh.shards for sh in sharded)))


def _resp_stats(suff_stats, part, resp):
    return suff_stats(part, resp), torch.sum(resp, 0)


class _Shards:
    """A fused engine's data over a one-row mesh (parallel.mesh), or with
    mesh None over the one position of the data's device, so that an
    unsharded fit is the one-shard case: `parts` the data tuples of this
    process's positions, each on its device, `bounds` their rows [lo, hi)
    of the global N, `xts` their kernel layouts where the kernels run.
    `estep` and `gibbs` launch once per non-empty shard and make the
    mesh's one reduction; `anchor_stats` (and the engines'
    `BayesianMixture._random_stats`) give the starts' statistics, each
    shard drawing or reading only its own rows, in one reduction each."""

    def __init__(self, mesh, data, backend='auto', block_size=131072):
        if mesh is None:
            mesh = local_mesh(as_data(data)[0].device)
        first, self.parts = _mesh_parts(mesh, data)
        self.mesh = mesh.one_row()
        self.n, self.positions = first.n, first.positions
        d = self.mesh.shape['data']
        self.bounds = [shard_bounds(self.n, d, p % d)
                       for p in self.positions]
        # an empty shard anywhere in the mesh, this process's or another's
        self.any_empty = any(lo == hi for lo, hi in (
            shard_bounds(self.n, d, j) for j in range(d)))
        x0 = self.parts[0][0]
        self.dtype, self.device = x0.dtype, x0.device
        self.use_kernel = resolve_backend(backend, x0)
        self.block_size = block_size
        self.xts = ([kernel_xts(p) for p in self.parts] if self.use_kernel
                    else None)

    def rows(self, j):
        """The rows of this process's position j."""
        return self.bounds[j][1] - self.bounds[j][0]

    def zero_part(self):
        """A data tuple of one zero point, in the first part's dtype and
        device: what a tree function is probed with when this process
        holds no point."""
        return tuple(a.new_zeros((1,) + a.shape[1:]) for a in self.parts[0])

    def reduce_each(self, tree_of, probe, kind):
        """The sum over the non-empty positions j of tree_of(j), a tree,
        in one reduction of `kind`; probe() shapes the zeros a process
        without points reduces."""
        return _reduce_trees(self.mesh, [
            tree_of(j) if self.rows(j) else None
            for j in range(len(self.parts))], probe, kind)

    def estep(self, spec, theta_src, log_pi, parts=None):
        """The fused E-step over the shards, or over `parts` (per-shard
        minibatches), in the data's dtype: one reduction."""
        if self.use_kernel:
            xts = self.xts if parts is None else [kernel_xts(p)
                                                  for p in parts]
            return cast_floats(cuda_estep.fused_estep_cuda_sharded(
                spec, theta_src, log_pi, xts, self.mesh), self.dtype)
        return family_estep.fused_estep_sharded(
            spec, theta_src, log_pi, self.parts if parts is None else parts,
            self.block_size, self.mesh)

    def estep_own(self, spec, theta_src, log_pi, parts):
        """The fused E-step of C chains each over its own points, with a
        chain spec (family_estep.chain_spec): `parts` one data tuple a
        shard with a leading chain axis (C, b_j, ...) (SVI's minibatches),
        chain c's theta over its own rows only, so one launch cannot
        serve the chains: B1 once a chain and shard on CUDA shards, the
        blockwise twin elsewhere (cuda_estep.BlockEStep); then one
        reduction for every chain."""
        estep = BlockEStep(spec, self.use_kernel, self.block_size,
                           self.dtype, self.mesh, own=True)
        estep.begin(theta_src, log_pi)
        estep.add([(part, None, part[0].shape[1]) for part in parts])
        return estep.end()

    def gibbs(self, spec, seed, params, log_pi):
        """The fused Gibbs label sweep over the shards: (labels as a
        Sharded, FusedEStep in the data's dtype); one reduction."""
        if self.use_kernel:
            labels, res = cuda_gibbs.fused_gibbs_cuda_sharded(
                spec, seed, params, log_pi, self.xts, self.mesh)
            res = cast_floats(res, self.dtype)
        else:
            labels, res = family_estep.fused_gibbs_sharded(
                spec, seed, params, log_pi, self.parts, self.block_size,
                self.mesh)
        return Sharded(tuple(labels), self.positions, self.n), res

    def zero_labels(self, lead):
        """A Gibbs fit's labels before its first sweep: zeros a shard."""
        return Sharded(tuple(
            torch.zeros(lead + (hi - lo,), dtype=torch.int32,
                        device=part[0].device)
            for part, (lo, hi) in zip(self.parts, self.bounds)),
            self.positions, self.n)

    def reduce_stats(self, stats_of, kind='start'):
        """The sum over the non-empty shards of stats_of(part, lo, hi), a
        tree, in one reduction of `kind`. A process without points
        reduces the tree's zeros, shaped by stats_of at one zero point."""
        return self.reduce_each(
            lambda j: stats_of(self.parts[j], *self.bounds[j]),
            lambda: stats_of(self.zero_part(), 0, 1), kind)

    def anchor_points(self, idx):
        """(the points at the global indices `idx`, the anchor start's
        squared distance scale: the mean per-dim variance over the global
        N, at least 1e-6, two-pass): one reduction each."""
        def picked(x, lo, hi):
            i = idx.to(x.device)
            inside = (i >= lo) & (i < hi)
            a = x.new_zeros((idx.shape[0], x.shape[1]))
            a[inside] = x[i[inside] - lo]
            return a, torch.sum(x, 0)

        anchors, total = self.reduce_stats(
            lambda part, lo, hi: picked(part[0], lo, hi))
        mean = total / self.n
        (sq,) = self.reduce_stats(lambda part, lo, hi: (torch.sum(
            torch.square(part[0] - mean.to(part[0].device)), 0),))
        return anchors, torch.clamp(torch.mean(sq / self.n), min=1e-6)

    def anchor_stats(self, suff_stats, idx):
        """(stats, counts) of the anchor start at the global point indices
        `idx`: the anchors and their scale (`anchor_points`, two
        reductions), then the statistics in a third."""
        anchors, scale2 = self.anchor_points(idx)
        return self.reduce_stats(lambda part, lo, hi: _resp_stats(
            suff_stats, part, anchor_resp(part[0], anchors.to(part[0].device),
                                          scale2.to(part[0].device))))

    def generators(self, gen):
        """One generator a shard, on its device: seeded from one int64
        draw of `gen` XOR the shard index x 0x9E3779B9."""
        base = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        d = self.mesh.shape['data']
        return [torch.Generator(device=part[0].device).manual_seed(
            base ^ ((p % d) * 0x9E3779B9))
            for p, part in zip(self.positions, self.parts)]


def transform_points(tr, x):
    """A Standardizer's transform of x (x itself without one), shard by
    shard for a parallel.mesh.Sharded, with tr's tensors on each shard's
    device."""
    if tr is None:
        return x
    if isinstance(x, Sharded):
        return x.map(lambda s: (s - tr.mean.to(s.device))
                     / tr.scale.to(s.device))
    return tr.transform(x)


def serve_sharded(mesh, x, y, backend, dist, kernel_parts, dense_one):
    """A regression model's predict over a one-row mesh, x (and y)
    sharded: Student-t predictions of CUDA shards (per `backend`) go
    through kernel_parts(xs, ys), one kernel launch a shard with the
    coefficients built once; the rest through dense_one(x_j, y_j) a
    shard. No collective. Returns the four results (mean, var, std,
    nlpd), each a parallel.mesh.Sharded (nlpd None without y)."""
    first, parts = _mesh_parts(mesh, x if y is None else (x, y))
    xs = [part[0] for part in parts]
    ys = None if y is None else [part[1] for part in parts]
    if dist == 'studentt' and resolve_backend(backend, xs[0]):
        outs = kernel_parts(xs, ys)
    else:
        outs = [dense_one(xj, None if ys is None else ys[j])
                for j, xj in enumerate(xs)]
    return tuple(None if outs[0][i] is None
                 else first._replace(shards=tuple(o[i] for o in outs))
                 for i in range(4))


def as_data(data):
    """The data tuple of an engine's `data`: an array or a
    parallel.mesh.Sharded alone, or a tuple of them."""
    if isinstance(data, Sharded) or not isinstance(data, tuple):
        return (data,)
    return data


def from_kernel(tr, x, mu, var, nlpd, incremental):
    """A serving kernel's float32 (mean, var, nlpd) of the points x in
    standardized units -> a regression model's (mean, var, std, nlpd) in
    x's dtype and original units, under the output Standardizer `tr` (or
    None): the NLPD carries the Jacobian sum(log scale); `incremental`
    adds the input back."""
    if mu.dim() == 1:
        mu, var = mu[:, None], var[:, None]
    mu, var = mu.to(x.dtype), var.to(x.dtype)
    if nlpd is not None:
        nlpd = nlpd.to(x.dtype)
        if tr is not None:
            nlpd = nlpd + torch.sum(torch.log(tr.scale.to(x.device)))
    if tr is not None:
        scale = tr.scale.to(x.device)
        mu = mu * scale + tr.mean.to(x.device)
        var = var * torch.square(scale)
    if incremental:
        mu = mu + x[:, :mu.shape[-1]]
    return mu, var, torch.sqrt(var), nlpd
