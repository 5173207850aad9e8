"""Two-level nested mixtures: an outer mixture over M clusters, each
cluster holding its own inner mixture of K components (port of
mimo_tpu/models/hmix.py).

  * The M inner models are a batch axis: the per-cluster family calls
    (updates, expectations, plug-in log-likelihoods, draws) run under
    `torch.func.vmap` over the (M, K, ...)-stacked priors and posteriors,
    as the JAX package runs them under `jax.vmap` (draws with
    randomness='different', one batched draw from the engine's
    generator). The statistics, linear in the weights, are formed for
    every cluster in one call over flat (N, M*K) weights
    (`_cluster_stats`).
  * Hard assignment becomes weighted updates: outer responsibilities or
    one-hot outer labels scale each point's statistics in every inner
    model, exact for the conjugate updates.
  * The fused engines (`fit_vi_fused`, `fit_gibbs_fused`, `fit_map_fused`,
    `fit_em_fused`) flatten the (M, K) posterior into one softmax over
    M*K experts (`_flat_spec`), so their per-point pass is kernel B1 (or
    B2 for Gibbs) with M*K rows on CUDA data; `log_predictive` serves NIW
    and HierTied posteriors through B3 and `predict` Student-t regression
    through B5 (p = 1) or B6 (p > 1), both over the flattened M*K
    components. `backend` follows models.mixture: 'auto', 'kernel' or
    'torch'.
  * Chains: every engine takes `chains=True` with C chain keys in
    `key`, as the flat ones do (models.mixture): each chain's random or
    anchor start is drawn and reduced one chain at a time from its own
    generator, and the M-vmapped algebra runs under one more
    torch.func.vmap over C (`_over_chains`, `_Chains.over`; the identity
    for one fit). The fused engines take theta (C, M*K, m) through
    family_estep.chain_spec, B1 / B2 launching once a sweep for all
    chains; the dense ones form every chain's statistics in one call over
    flat (N, C*M*K) weights (`_cluster_stats`), SVI's under the vmap
    (each chain's own minibatch). Chain c of VI, MAP, ML-EM and SVI
    equals the fit with key c; the Gibbs chains draw from one generator
    seeded by theirs (`batch_generator`).
  * Mesh: the fused engines, `fit_svi`, the dense engines,
    `log_predictive` and `predict` take `mesh=` as the flat ones do
    (models.mixture): the flat M*K E-step or label sweep launches once
    per non-empty shard and makes one reduction a sweep; the two-level
    random and anchor starts draw over the global N; SVI and the dense
    engines reduce once per inner round (the dense VI once more for its
    log-likelihood, MAP-EM and ML-EM twice more for their last M-step and
    log-likelihood), their responsibilities and labels staying on their
    shards; serving runs once per shard with no collective. The dense
    engines run unsharded as the one-position case.
"""

import math
from typing import Any, NamedTuple

import torch
from torch.func import vmap

from mimo_tpu_torch.conjugate.families import (
    Family, gaussian_family, hier_gaussian_family, ilr_family)
from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.gating import Dirichlet
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models.ilr import BayesianILR
from mimo_tpu_torch.models.mixture import (
    BayesianMixture, _Chains, _elbo_loop, _generators, _label_generators,
    _mesh_parts, _over_chains, _random_resp, _reduce_trees, _resp_seed,
    _Shards, _stack, _stack_lead, as_data, batch_generator, from_kernel,
    model_device, resolve_backend, serve_sharded, shard0_draws, stack_trees,
    start_labels, transform_points)
from mimo_tpu_torch.models.mixture import (
    _anchor_indices as _flat_anchor_indices)
from mimo_tpu_torch.ops import cuda_predict
from mimo_tpu_torch.ops.cuda_ilr_predict import (
    ilr_p_predict_cuda_sharded, ilr_predict_cuda_sharded)
from mimo_tpu_torch.ops.cuda_predict import predictive_coefficients
from mimo_tpu_torch.ops.family_estep import (
    EStepSpec, gaussian_spec, hier_gaussian_spec, ilr_spec)
from mimo_tpu_torch.parallel.mesh import Sharded
from mimo_tpu_torch.utils.data import (
    Standardizer, one_hot, sample_batch_indices)
from mimo_tpu_torch.utils.logging import spanned
from mimo_tpu_torch.utils.sanitize import finite_report
from mimo_tpu_torch.utils.stats import (
    normalize_log, sample_categorical_from_log)
from mimo_tpu_torch.utils.tree import on_device, tree_map


class HMixState(NamedTuple):
    """Mean-field state of the nested mixture."""
    outer_gating: Any   # Dirichlet | StickBreaking posterior over M
    inner_gating: Any   # M-stacked gating posterior over K
    components: Any     # M-stacked family posterior (M, K, ...)


class HMixGibbsState(NamedTuple):
    outer_gating: Any
    inner_gating: Any
    components: Any
    labels: torch.Tensor    # (N,) outer cluster labels


class HMixEMState(NamedTuple):
    """Likelihood-only (ML) nested-mixture state."""
    params: Any                     # (M, K, ...) likelihood params
    inner_log_pi: torch.Tensor      # (M, K)
    outer_log_pi: torch.Tensor      # (M,)


def _flatten_mk(tree):
    """(M, K, ...) leaves -> (M*K, ...), m-major (row m*K + k)."""
    return tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), tree)


def _unflatten_mk(tree, m, k):
    """(M*K, ...) leaves, m-major -> (M, K, ...)."""
    return tree_map(lambda a: a.reshape((m, k) + a.shape[1:]), tree)


def _log_clip(p):
    return torch.log(torch.clamp(p, min=1e-37))


def _chains(gens, chains):
    """The `_Chains` of a dense engine over shared data: C chains, one a
    generator in `gens`, or one fit."""
    return _Chains(len(gens) if chains else None)


class BayesianMixtureOfMixtures:
    """Outer gating over M clusters; each cluster an inner conjugate
    mixture over K components (same family across clusters)."""

    def __init__(self, outer_gating_prior, inner_gating_prior,
                 components_prior, family: Family, kind='gmm', affine=True):
        """inner_gating_prior and components_prior carry a leading M axis."""
        self.outer_gating_prior = outer_gating_prior
        self.inner_gating_prior = inner_gating_prior
        self.components_prior = components_prior
        self.family = family
        self.kind = kind
        self.affine = affine
        self.input_transform = None
        self.output_transform = None
        self.cluster_size = outer_gating_prior.dim
        self.mixture_size = inner_gating_prior[0].shape[-1]

    @staticmethod
    def make_gmm(cluster_size, mixture_size, dim, alpha=1.0,
                 inner_alpha=1.0, hierarchical=True, kappa=1e-2,
                 psi_scale=1.0, maxsubiter=5, means=None,
                 dtype=torch.float32, device=None):
        """Mixture of (hierarchical) GMMs, on `device` (by default the
        CUDA card; raises without one: pass device='cpu'). Inner priors
        are replicated across the M clusters; optional `means` (M, dim)
        gives each cluster's prior its own center. `maxsubiter` is the
        inner rounds of the hierarchical update."""

        device = model_device(device)
        m, k = cluster_size, mixture_size
        outer = Dirichlet.standard(m, alpha, dtype, device)
        inner_g = _stack_lead(
            Dirichlet.standard(k, inner_alpha, dtype, device), m)
        if hierarchical:
            comp = HierTied.standard(k, dim, kappa=1.0, hyper_kappa=kappa,
                                     psi_scale=psi_scale, dtype=dtype,
                                     device=device)
            fam = hier_gaussian_family(maxsubiter)
        else:
            comp = NIW.standard(k, dim, kappa=kappa, psi_scale=psi_scale,
                                dtype=dtype, device=device)
            fam = gaussian_family()
        comp_m = _stack_lead(comp, m)
        if means is not None:
            means = torch.as_tensor(means, dtype=dtype, device=device)
            spread = means[:, None, :].expand(m, k, dim).contiguous()
            if hierarchical:
                comp_m = comp_m._replace(
                    hyper=comp_m.hyper._replace(
                        mu=means[:, None, :].contiguous()),
                    mus=spread)
            else:
                comp_m = comp_m._replace(mu=spread)
        return BayesianMixtureOfMixtures(outer, inner_g, comp_m, fam)

    @staticmethod
    def make_ilr(cluster_size, mixture_size, input_dim, output_dim,
                 alpha=1.0, inner_alpha=1.0, affine=True, kappa=1e-2,
                 K_scale=1e-2, psi_scale=1.0, dtype=torch.float32,
                 device=None):
        """Mixture of mixtures of linear experts (NIW basis x MNW
        experts), on `device` as make_gmm."""

        device = model_device(device)
        m, k = cluster_size, mixture_size
        outer = Dirichlet.standard(m, alpha, dtype, device)
        inner_g = _stack_lead(
            Dirichlet.standard(k, inner_alpha, dtype, device), m)
        q = input_dim + (1 if affine else 0)
        comp = (NIW.standard(k, input_dim, kappa=kappa, psi_scale=psi_scale,
                             dtype=dtype, device=device),
                MNW.standard(k, output_dim, q, K_scale=K_scale,
                             psi_scale=psi_scale, dtype=dtype,
                             device=device))
        return BayesianMixtureOfMixtures(outer, inner_g, _stack_lead(comp, m),
                                         ilr_family(affine=affine),
                                         kind='ilr', affine=affine)

    # -- expectations -------------------------------------------------------

    def _inner_elc(self, state: HMixState, data):
        """(M, N, K): per-cluster inner expected log complete likelihood."""
        def per_cluster(comp, gating):
            return (self.family.ell(comp, data)
                    + gating.expected_log_pi()[None, :])
        return vmap(per_cluster)(state.components, state.inner_gating)

    def expected_cluster_loglik(self, state: HMixState, data):
        """(N, M): marginal inner loglik per cluster."""
        return torch.logsumexp(self._inner_elc(state, data), -1).T

    def expected_responsibilities(self, state: HMixState, data):
        """Outer responsibilities (N, M)."""
        resp, _ = normalize_log(
            self.expected_cluster_loglik(state, data)
            + state.outer_gating.expected_log_pi()[None, :])
        return resp

    # -- updates ------------------------------------------------------------

    def _cluster_stats(self, data, inner_w, outer_w, out=True):
        """(stats, counts) of every cluster, (M, K)-stacked, from inner
        weights (M, N, K) scaled by outer weights (N, M); the chains'
        (C, M, K)-stacked from their (C, M, N, K) and (C, N, M). The
        statistics are linear in the weights and every cluster (and
        chain) reads the same data, so one call over the flat (N, M*K)
        weights, m-major (or (N, C*M*K), chain-major), gives them all;
        vmapping the family's call instead runs its (K, N) x (N, m)
        products as a batched matmul ~80x slower at N=1e7 on the H100.
        The weights are formed in place (`out`) but under torch.func.vmap
        (a minibatch each chain draws itself), where `out=False`."""
        *lead, m, n, k = inner_w.shape
        shape = tuple(lead) + (m, k)
        a, b = inner_w.movedim(-2, 0), outer_w.movedim(-2, 0)[..., None]
        if out:
            flat = torch.empty((n,) + shape, dtype=inner_w.dtype,
                               device=inner_w.device)
            torch.mul(a, b, out=flat)
            flat = flat.view(n, -1)
        else:
            flat = (a * b).reshape(n, -1)
        return (tree_map(lambda t: t.reshape(shape + t.shape[1:]),
                         self.family.suff_stats(data, flat)),
                torch.sum(flat, 0).reshape(shape))

    def _inner_posteriors(self, stats, counts):
        """(components, gatings): every cluster's inner posteriors from
        (M, K)-stacked stats and counts."""
        return vmap(lambda pc, pg, s, c: (self.family.update(pc, s),
                                          pg.update(c)))(
            self.components_prior, self.inner_gating_prior, stats, counts)

    def _update_from(self, stats, counts):
        """Inner posteriors of every cluster from (M, K)-stacked stats and
        counts, and the outer posterior from the cluster totals."""
        comps, gatings = self._inner_posteriors(stats, counts)
        return HMixState(
            outer_gating=self.outer_gating_prior.update(torch.sum(counts, -1)),
            inner_gating=gatings, components=comps)

    def _random_state(self, gen, data):
        """The posterior after one weighted update from random two-level
        responsibilities (`_two_level_resp`) over `data`, a `_Shards`:
        two seeds drawn from `gen`, and each shard draws and reduces only
        its own rows of the draw over the global N."""
        seeds = (_resp_seed(gen), _resp_seed(gen))

        def stats_of(part, lo, hi):
            outer_resp, inner_resp = _two_level_resp(
                seeds, hi - lo, self.cluster_size, self.mixture_size,
                data.dtype, part[0].device, lo, data.n)
            return self._cluster_stats(part, inner_resp, outer_resp) + (
                torch.sum(outer_resp, 0),)

        stats, counts, outer_counts = data.reduce_stats(stats_of)
        comps, gatings = self._inner_posteriors(stats, counts)
        return HMixState(
            outer_gating=self.outer_gating_prior.update(outer_counts),
            inner_gating=gatings, components=comps)

    def _vi_sweep(self, state: HMixState, sh, maxsubiter, ch):
        """One nested VI sweep over the `_Shards` sh: each shard's outer
        responsibilities, then `maxsubiter` inner rounds, each one
        reduction of every cluster's statistics (the first also of the
        outer counts). For C chains (`ch`, a `_Chains`) the state is
        C-stacked and a round's reduction serves every chain."""
        outer = [ch.over(lambda st: self.expected_responsibilities(st, part))(
            on_device(state, part[0].device)) if sh.rows(j) else None
            for j, part in enumerate(sh.parts)]
        zero = sh.zero_part()
        zero_outer = zero[0].new_zeros(ch.lead + (1, self.cluster_size))
        for sub in range(max(maxsubiter, 1)):
            red = sh.reduce_each(
                lambda j: self._round_tree(state, sh.parts[j], outer[j],
                                           sub == 0, maxsubiter > 0, ch),
                lambda: self._round_tree(state, zero, zero_outer, sub == 0,
                                         maxsubiter > 0, ch), 'sweep')
            if sub == 0:
                outer_counts, red = red[0], red[1:]
            if maxsubiter:
                comps, gatings = ch.over(self._inner_posteriors)(*red)
                state = state._replace(inner_gating=gatings, components=comps)
        return state._replace(outer_gating=ch.over(
            self.outer_gating_prior.update)(outer_counts))

    def _round_tree(self, state, part, outer, first, inner, ch):
        """One shard's part of an inner round: (the outer counts, where
        `first`) + (every cluster's stats and counts under the inner
        responsibilities of `state`, where `inner`)."""
        tree = (torch.sum(outer, -2),) if first else ()
        if inner:
            st = on_device(state, part[0].device)
            tree += self._cluster_stats(part, torch.softmax(
                ch.over(lambda s: self._inner_elc(s, part))(st), -1), outer)
        return tree

    def _tx_data(self, data):
        data = as_data(data)
        if self.kind == 'ilr' and self.input_transform is not None:
            data = (transform_points(self.input_transform, data[0]),
                    transform_points(self.output_transform, data[1]))
        return data

    def fit_vi(self, data, key=None, maxiter=100, maxsubiter=3,
               randomize=True, mesh=None, chains=False):
        """Nested mean-field coordinate ascent from random two-level
        responsibilities (`randomize` is accepted and unused, as in the
        JAX package). Returns (HMixState, trace): the marginal expected
        log-likelihood after each sweep. With `mesh` (a one-row mesh; the
        dense engines over a mesh, see the module docstring) each shard's
        (n_j, M) and (M, n_j, K) responsibilities stay on its device and
        a sweep makes maxsubiter + 1 reductions: one an inner round, and
        one of its log-likelihood; without one, the same over the one
        position of the data's device. With `chains`, `key` holds C chain
        keys (see the module docstring): C-stacked HMixState, (C,
        maxiter) traces, chain c equal to the fit with key c."""
        sh = _Shards(mesh, self._tx_data(data), 'torch')
        gens = _generators(key, sh.device, chains)
        ch = _chains(gens, chains)
        state = self._random_states(gens, sh, chains)
        trace = []

        def lse_sum(st, part):
            st = on_device(st, part[0].device)
            return (torch.sum(torch.logsumexp(ch.over(
                lambda s: self.expected_cluster_loglik(s, part)
                + s.outer_gating.expected_log_pi()[None, :])(st), -1), -1),)

        for _ in range(maxiter):
            state = self._vi_sweep(state, sh, maxsubiter, ch)
            trace.append(sh.reduce_each(
                lambda j: lse_sum(state, sh.parts[j]),
                lambda: lse_sum(state, sh.zero_part()), 'sweep')[0])
        return finite_report((state, _stack(trace, sh)), 'fit_vi')

    # -- the flat M*K fused engines -----------------------------------------

    def _flat_spec(self):
        """EStepSpec over the FLAT M*K expert axis: the two-level joint
        responsibility r_{n,m,k} factors exactly into outer_{n,m} *
        inner_{n,m,k} with joint logits log pi_m + log pi_mk + ell_mk, so
        the fused machinery applies to the (M, K)-stacked posteriors and
        params flattened m-major. The features, unpack and transposed map
        are the family's own, so the kernels run it as the flat model's
        map with K = M*K rows."""
        mk = self.cluster_size * self.mixture_size
        cp = self.components_prior
        if self.kind == 'ilr':
            base = ilr_spec(cp[0].mu.shape[-1], cp[1].M.shape[-2],
                            affine=self.affine)
        elif isinstance(cp, HierTied):
            base = hier_gaussian_spec()
        else:
            base = gaussian_spec()
        return EStepSpec(
            features=base.features,
            theta=lambda comps: vmap(base.theta)(comps).reshape(mk, -1),
            unpack=base.unpack,
            theta_plugin=lambda params: vmap(base.theta_plugin)(
                params).reshape(mk, -1),
            features_t=base.features_t)

    def _split_flat(self, res):
        """Reshape a flat M*K FusedEStep back to (M, K)-stacked counts and
        stats."""
        mm, kk = self.cluster_size, self.mixture_size
        return res.counts.reshape(mm, kk), _unflatten_mk(res.stats, mm, kk)

    def _update_flat(self, res):
        """The posterior from a flat M*K FusedEStep (`_update_from`)."""
        counts, stats = self._split_flat(res)
        return self._update_from(stats, counts)

    def _fused_setup(self, data, key, chains, backend, mesh, block_size):
        """(data, generators, spec, over) of a fused engine over the flat
        M*K spec: models.mixture's setup (the data's `_Shards`, over the
        one position of its device without `mesh`; one generator, or with
        `chains` one a chain and the chains' spec) and the map over the
        chains' axis."""
        return BayesianMixture._fused_setup(
            self._tx_data(data), key, chains, backend, self._flat_spec(),
            mesh, block_size) + (_over_chains(chains),)

    def _random_states(self, gens, data, chains):
        """`_random_state` of each chain, drawn and reduced one chain at a
        time (the (C, M, N, K) responsibilities never exist)."""
        starts = [self._random_state(g, data) for g in gens]
        return stack_trees(starts) if chains else starts[0]

    def _flat_log_pi(self, state: HMixState, mode=False):
        """(M*K,) flat log weights, m-major: E[log pi_out]_m +
        E[log pi_in]_{m,k} (VI), or with `mode` the logs of the gatings'
        modes clipped at 1e-37 (MAP)."""
        if mode:
            outer = _log_clip(state.outer_gating.mode())
            inner = vmap(lambda g: _log_clip(g.mode()))(state.inner_gating)
        else:
            outer = state.outer_gating.expected_log_pi()
            inner = vmap(lambda g: g.expected_log_pi())(state.inner_gating)
        return (outer[:, None] + inner).reshape(-1)

    def _kl(self, st: HMixState):
        """KL of the components, the inner gatings and the outer gating
        against their priors, summed."""
        kl_c = torch.sum(vmap(self.family.kl)(st.components,
                                              self.components_prior))
        kl_gi = torch.sum(vmap(lambda q, p: q.kl_divergence(p))(
            st.inner_gating, self.inner_gating_prior))
        return kl_c + kl_gi + torch.sum(
            st.outer_gating.kl_divergence(self.outer_gating_prior))

    @spanned('engines')
    def fit_vi_fused(self, data, key=None, maxiter=100, block_size=131072,
                     randomize=True, tol=None, backend='auto', chains=False,
                     mesh=None):
        """Fused nested VI for big N: the two-level E-step runs as one
        FLAT softmax over all M*K experts (kernel B1 on CUDA data, with
        log E[pi_out]_m + log E[pi_in]_{m,k} folded into theta); the
        M-step splits the flat counts back into per-cluster inner updates
        plus the outer update. Equivalent to fit_vi's coordinate ascent
        at maxsubiter=1. Starts from random two-level responsibilities
        (`randomize` is accepted and unused, as in the JAX package).
        Returns (HMixState, trace); the trace is the nested ELBO (lse
        identity minus the KL terms). `tol` stops early on |dELBO| <
        tol. With `chains`, `key` holds C chain keys (see the module
        docstring): a C-stacked HMixState and (C, maxiter) traces, each
        chain stopping on its own `tol`. With `mesh`, see the module
        docstring."""
        data, gens, spec, over = self._fused_setup(data, key, chains,
                                                   backend, mesh, block_size)
        state = self._random_states(gens, data, chains)

        def step(st, _):
            res = data.estep(spec, st.components,
                             over(self._flat_log_pi)(st))
            return over(self._update_flat)(res), res.lse - over(self._kl)(st)

        return finite_report(
            _elbo_loop(step, state, maxiter, tol,
                       (len(gens),) if chains else ()), 'fit_vi_fused')

    def fit_gibbs_fused(self, data, key=None, maxiter=100, block_size=131072,
                        backend='auto', chains=False, mesh=None):
        """Fused nested Gibbs for big N: the (outer, inner) labels are
        drawn JOINTLY as one flat categorical over all M*K experts per
        point given the sampled params (a valid blocked-Gibbs move on
        (z_n, c_n)), so the label sweep is kernel B2 on CUDA data, with
        Philox Gumbel noise keyed by per-sweep seeds from the engine's
        generator. A family with a `gibbs_update` hook (the hierarchical
        one) draws its posterior and params after the sweep from the
        statistics, with the exact draws. Returns HMixGibbsState with the
        OUTER labels (flat label // K).

        With `chains`, `key` holds C chain keys: each chain's per-sweep
        seeds come from its own generator, and the draws run under one
        more vmap with randomness='different' from `batch_generator`, as
        the flat chained Gibbs draws do (the same keys give the same
        chains; a chain is not the single fit draw for draw). Returns the
        C-stacked HMixGibbsState (labels (C, N)). With `mesh`, B2 runs once
        per non-empty shard a sweep and the labels come back as a
        parallel.mesh.Sharded."""
        data, gens, spec, over = self._fused_setup(data, key, chains,
                                                   backend, mesh, block_size)
        dev = data.device
        lead = (len(gens),) if chains else ()
        fam = self.family
        cp, gp = self.components_prior, self.inner_gating_prior
        comps, gatings, outer = cp, gp, self.outer_gating_prior
        if chains:
            comps, gatings, outer = (_stack_lead(t, lead[0])
                                     for t in (comps, gatings, outer))
        params = over(vmap(fam.mode_params))(comps)
        labels = data.zero_labels(lead)
        seeds = torch.stack([torch.randint(0, 2 ** 62, (maxiter,),
                                           generator=g, dtype=torch.int64,
                                           device=dev) for g in gens], -1)
        seeds = seeds if chains else seeds[:, 0]
        gen = batch_generator(gens) if chains else gens[0]

        def draw_params(q):
            return vmap(lambda c: fam.sample_params(gen, c),
                        randomness='different')(q)

        def draw_log_pi(o, g):
            pi_i = vmap(lambda gi: gi.sample(gen),
                        randomness='different')(g)             # (M, K)
            return (_log_clip(o.sample(gen))[:, None]
                    + _log_clip(pi_i)).reshape(-1)

        def gibbs_update(s):
            return vmap(lambda p, st: fam.gibbs_update(gen, p, st),
                        randomness='different')(cp, s)

        for i in range(maxiter):
            if fam.gibbs_update is None:
                params = over(draw_params, randomness='different')(comps)
            log_pi = over(draw_log_pi, randomness='different')(outer,
                                                               gatings)
            labels, res = data.gibbs(spec, seeds[i], params, log_pi)
            counts, stats = over(self._split_flat)(res)
            if fam.gibbs_update is None:
                comps = over(lambda s: vmap(fam.update)(cp, s))(stats)
            else:
                comps, params = over(gibbs_update,
                                     randomness='different')(stats)
            gatings = over(lambda c: vmap(lambda p, ci: p.update(ci))(
                gp, c))(counts)
            outer = over(lambda c: self.outer_gating_prior.update(
                torch.sum(c, -1)))(counts)
        labels = labels.map(lambda t: t // self.mixture_size)
        return finite_report(
            HMixGibbsState(outer_gating=outer, inner_gating=gatings,
                           components=comps,
                           labels=(labels.shards[0] if mesh is None
                                   else labels)),
            'fit_gibbs_fused')

    # -- likelihood-only EM --------------------------------------------------

    def _em_inner_loglik(self, state: HMixEMState, data):
        """(M, N, K): plug-in inner complete log-likelihood."""
        return vmap(lambda p, lpi: self.family.loglik(p, data)
                    + lpi[None, :])(state.params, state.inner_log_pi)

    def cluster_log_likelihood(self, state: HMixEMState, data):
        """(N, M): marginal inner log-likelihood per cluster under plug-in
        parameters."""
        data = self._tx_data(data)
        return torch.logsumexp(self._em_inner_loglik(state, data), -1).T

    def log_likelihood(self, state: HMixEMState, data):
        """(N,): marginal log-likelihood."""
        return torch.logsumexp(self.cluster_log_likelihood(state, data)
                               + state.outer_log_pi[None, :], -1)

    def responsibilities(self, state: HMixEMState, data):
        """(N, M) outer responsibilities under plug-in params."""
        resp, _ = normalize_log(self.cluster_log_likelihood(state, data)
                                + state.outer_log_pi[None, :])
        return resp

    def _anchor_start(self, gen, sh):
        """Anchor-seeded responsibilities at BOTH levels (k-means 'random'
        seeding; a flat random init is an exact symmetric fixed point of
        the vmapped inner updates) over the `_Shards` sh: M x K random
        points of the global N and the distance scale
        (`_Shards.anchor_points`, two reductions), then each shard's inner
        (M, n_j, K) by distance to them and outer (n_j, M) by each
        cluster's best anchor. Returns (the inner, the outer), one a
        position."""
        mm, kk = self.cluster_size, self.mixture_size
        idx = _anchor_indices(gen, sh.n, (mm, kk), sh.device)
        anchors, scale2 = sh.anchor_points(idx.reshape(-1))
        inner, outer = [], []
        for part in sh.parts:
            x0 = part[0]
            a = anchors.to(x0.device).reshape(mm, kk, -1)
            d2 = torch.sum(torch.square(x0[None, :, None, :]
                                        - a[:, None, :, :]), -1)
            s2 = scale2.to(x0.device)
            inner.append(torch.softmax(-0.5 * d2 / s2, -1))
            outer.append(torch.softmax(-0.5 * torch.min(d2, -1).values.T / s2,
                                       -1))                  # (n_j, M)
        return inner, outer

    def _plugin_sweeps(self, sh, maxiter, maxsubiter, gens, m_step,
                       outer_log_pi, ch):
        """The nested plug-in sweeps (fit_em, fit_map) over the `_Shards`
        sh from the two-level anchor start: per sweep `maxsubiter` inner
        rounds (an M-step, one reduction of every cluster's statistics,
        then each shard's inner responsibilities under its plug-in
        params), the last M-step (its reduction also of the outer
        counts), then each shard's outer responsibilities under the
        plug-in params and one reduction of their log-likelihood:
        maxsubiter + 2 reductions a sweep. m_step(stats, counts, outer
        counts or None) -> (state or None, params, inner log weights (M,
        K)); outer_log_pi(state, outer counts) -> (M,). For C chains
        (`gens` one generator a chain, whose anchor starts are drawn one
        chain at a time; `ch` their `_Chains`) every tensor gains a
        leading C axis and a reduction serves every chain.
        Returns (the last state, the trace)."""
        fam = self.family
        starts = [self._anchor_start(g, sh) for g in gens]
        inner, outer = ([ch.stack([s[i][j] for s in starts])
                         for j in range(len(sh.parts))] for i in (0, 1))
        zero = sh.zero_part()
        zeros = (zero[0].new_zeros(ch.lead + (self.cluster_size, 1,
                                           self.mixture_size)),
                 zero[0].new_zeros(ch.lead + (1, self.cluster_size)))

        def reduce(first):
            def tree(part, inn, out):
                return self._cluster_stats(part, inn, out) + (
                    (torch.sum(out, -2),) if first else ())
            return sh.reduce_each(
                lambda j: tree(sh.parts[j], inner[j], outer[j]),
                lambda: tree(zero, *zeros), 'sweep')

        def plug_in_elc(params, ilp, part):
            params, ilp = on_device((params, ilp), part[0].device)
            return ch.over(lambda p, lp: vmap(lambda q: fam.loglik(q, part))(p)
                        + lp[:, None, :])(params, ilp)

        state, trace = None, []
        for _ in range(maxiter):
            for _ in range(maxsubiter):
                _, params, ilp = m_step(*reduce(False), None)
                inner = [torch.softmax(plug_in_elc(params, ilp, part), -1)
                         for part in sh.parts]
            stats, counts, outer_counts = reduce(True)
            state, params, ilp = m_step(stats, counts, outer_counts)
            olp = outer_log_pi(state, outer_counts)
            sums = []
            for j, part in enumerate(sh.parts):
                outer[j], lognorm = normalize_log(
                    torch.logsumexp(plug_in_elc(params, ilp, part),
                                    -1).transpose(-1, -2)
                    + olp.to(part[0].device)[..., None, :])
                sums.append((torch.sum(lognorm, -1),) if sh.rows(j)
                            else None)
            trace.append(_reduce_trees(
                sh.mesh, sums, lambda: (zero[0].new_zeros(ch.lead),),
                'sweep')[0])
        return state, _stack(trace, sh)

    def _require_ml(self):
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; build the '
                'model with hierarchical=False or use fit_vi/fit_gibbs')

    def fit_em(self, data, key=None, maxiter=100, maxsubiter=5, mesh=None,
               chains=False):
        """Nested likelihood-only EM: outer E-step over clusters, then per
        cluster `maxsubiter` weighted inner EM iterations (all clusters
        vmapped at once), from the two-level anchor start. Needs the
        family's ml_update (hierarchical families have none). Returns
        (HMixEMState, loglik trace). With `mesh` (see fit_vi) the anchors
        and their scale come from the global N and a sweep makes
        maxsubiter + 2 reductions (`_plugin_sweeps`). With `chains`,
        `key` holds C chain keys: C-stacked HMixEMState, (C, maxiter)
        traces, chain c equal to the fit with key c."""
        self._require_ml()
        sh = _Shards(mesh, self._tx_data(data), 'torch')
        gens = _generators(key, sh.device, chains)
        ch = _chains(gens, chains)
        fam = self.family

        def m_step(stats, counts, outer_counts):
            """Weighted ML for all clusters: params + inner log weights."""
            csum = torch.clamp(torch.sum(counts, -1, keepdim=True), min=1e-37)
            params = ch.over(vmap(fam.ml_update))(stats)
            ilp = _log_clip(counts / csum)
            return (None if outer_counts is None else
                    HMixEMState(params, ilp, _log_clip(outer_counts / sh.n)),
                    params, ilp)

        state, trace = self._plugin_sweeps(
            sh, maxiter, maxsubiter, gens, m_step,
            lambda st, _: st.outer_log_pi, ch)
        return finite_report((state, trace), 'fit_em')

    def _ml_log_pis(self, counts, n):
        """(inner (M, K), outer (M,)) ML log weights from (M, K) counts."""
        csum = torch.sum(counts, -1)
        ilp = _log_clip(counts / torch.clamp(csum[:, None], min=1e-37))
        return ilp, _log_clip(csum / n)

    def fit_em_fused(self, data, key=None, maxiter=100, block_size=131072,
                     backend='auto', chains=False, mesh=None):
        """Nested likelihood-only EM through the fused E-step: each sweep
        is one FLAT softmax over all M*K experts (kernel B1 on CUDA data),
        fed theta_plugin(ML params), so the (M, N, K) responsibilities
        never exist in the sweeps; the flat M*K anchor init forms one
        (N, M*K) matrix and dense statistics once, and frees them before
        the first sweep. Equivalent to fit_em's coordinate ascent at
        maxsubiter=1 with jointly-updated outer weights. Returns
        (HMixEMState, loglik trace). With `chains`, `key` holds C chain
        keys: the anchor starts are formed and reduced one chain at a
        time, then the C chains run as one program (C-stacked
        HMixEMState, (C, maxiter) traces). With `mesh`, the anchors and
        their scale come from the global N."""
        self._require_ml()
        data, gens, spec, over = self._fused_setup(data, key, chains,
                                                   backend, mesh, block_size)
        spec = spec._replace(theta=spec.theta_plugin)
        n = data.n
        mm, kk = self.cluster_size, self.mixture_size
        fam = self.family
        starts = []
        for g in gens:
            stats, counts = data.anchor_stats(
                fam.suff_stats,
                _anchor_indices(g, n, (mm * kk,), data.device))
            stats = _unflatten_mk(stats, mm, kk)
            counts = counts.reshape(mm, kk)
            starts.append((vmap(fam.ml_update)(stats),)
                          + self._ml_log_pis(counts, n))
        params, ilp, olp = stack_trees(starts) if chains else starts[0]
        trace = []
        for _ in range(maxiter):
            log_pi = (olp[..., :, None] + ilp).flatten(-2).to(data.dtype)
            res = data.estep(spec, params, log_pi)
            counts, stats = over(self._split_flat)(res)
            params = over(vmap(fam.ml_update))(stats)
            ilp, olp = over(lambda c: self._ml_log_pis(c, n))(counts)
            trace.append(res.lse)
        return finite_report((HMixEMState(params, ilp, olp),
                              _stack(trace, data)), 'fit_em_fused')

    # -- MAP EM --------------------------------------------------------------

    def fit_map(self, data, key=None, maxiter=100, maxsubiter=5,
                mesh=None, chains=False):
        """Nested MAP expectation-maximization: posterior update + mode
        plug-in at BOTH levels, weight-masked inner updates, from the
        two-level anchor start. Per sweep: `maxsubiter` inner MAP
        iterations under the current outer responsibilities, the outer
        gating MAP, then outer responsibilities under the plug-in mode
        params. Returns (HMixState, loglik trace). With `mesh` (see
        fit_vi) a sweep makes maxsubiter + 2 reductions. With `chains`,
        `key` holds C chain keys: C-stacked HMixState, (C, maxiter)
        traces, chain c equal to the fit with key c."""
        sh = _Shards(mesh, self._tx_data(data), 'torch')
        gens = _generators(key, sh.device, chains)
        ch = _chains(gens, chains)
        fam = self.family

        def per_cluster(prior_c, prior_g, st, c):
            comp = fam.update(prior_c, st)
            gating = prior_g.update(c)
            return (comp, gating, fam.mode_params(comp),
                    _log_clip(gating.mode()))

        def m_step(stats, counts, outer_counts):
            """Weighted MAP at both levels -> (HMixState or None, plug-in
            params, inner log weights (M, K))."""
            comps, gatings, params, ilp = ch.over(
                lambda st, c: vmap(per_cluster)(
                    self.components_prior, self.inner_gating_prior, st,
                    c))(stats, counts)
            state = None if outer_counts is None else HMixState(
                outer_gating=ch.over(self.outer_gating_prior.update)(
                    outer_counts),
                inner_gating=gatings, components=comps)
            return state, params, ilp

        state, trace = self._plugin_sweeps(
            sh, maxiter, maxsubiter, gens, m_step,
            lambda st, _: ch.over(lambda g: _log_clip(g.mode()))(
                st.outer_gating), ch)
        return finite_report((state, trace), 'fit_map')

    def fit_map_fused(self, data, key=None, maxiter=100, block_size=131072,
                      backend='auto', chains=False, mesh=None):
        """Nested MAP-EM through the fused E-step: the two-level plug-in
        E-step at the posterior MODE runs as one flat M*K softmax (kernel
        B1 on CUDA data, fed theta_plugin(mode params)); the M-step splits
        the flat counts and stats back into per-cluster MAP updates plus
        the outer gating update. Starts from random two-level
        responsibilities, whose (M, N, K) tensors are freed before the
        first sweep. Equivalent to fit_map's coordinate ascent at
        maxsubiter=1 with jointly-updated outer weights. Returns
        (HMixState, trace): the data log-likelihood at each sweep's
        mode. With `chains`, `key` holds C chain keys (C-stacked
        HMixState, (C, maxiter) traces). `mesh` as in fit_vi_fused."""
        data, gens, spec, over = self._fused_setup(data, key, chains,
                                                   backend, mesh, block_size)
        spec = spec._replace(theta=spec.theta_plugin)
        state = self._random_states(gens, data, chains)
        trace = []
        for _ in range(maxiter):
            params = over(vmap(self.family.mode_params))(state.components)
            log_pi = over(lambda s: self._flat_log_pi(s, mode=True))(state)
            res = data.estep(spec, params, log_pi.to(data.dtype))
            state = over(self._update_flat)(res)
            trace.append(res.lse)
        return finite_report((state, _stack(trace, data)), 'fit_map_fused')

    # -- stochastic VI -------------------------------------------------------

    def fit_svi(self, data, key=None, maxiter=500, step_size=1e-2,
                batch_size=128, maxsubiter=2, init_state=None,
                randomize=True, mesh=None, chains=False):
        """Nested stochastic natural-gradient VI: per step, one random
        minibatch (`utils.data.sample_batch_indices`); outer and inner
        responsibilities on the batch; `maxsubiter` blends of the inner
        components and gatings, then one of the outer gating, each with
        stochastic scale B/N (nat <- (1 - rho) nat + rho (prior +
        stats/scale)) at the fixed step. Starts from random two-level
        responsibilities when `randomize` or without `init_state`.
        Returns the final HMixState.

        With `mesh` (a one-row mesh over d data shards) each step draws a
        stratified minibatch of batch_size // d points a shard (a
        generator a shard, seeded from one draw of the key's and the shard
        index), and every inner sub-iteration reduces the shards' (M, K)
        statistics once (the first also the outer counts), as mimo_tpu's
        psum a sub-iteration; a batch_size that d does not divide
        raises. With `chains`, `key` holds C chain keys: each chain
        draws its start and minibatches from its own generator, one
        gather serves every chain, and a step runs under torch.func.vmap
        over C (C-stacked HMixState; chain c equals the fit with key
        c)."""
        if mesh is not None:
            return self._fit_svi_mesh(data, key, maxiter, step_size,
                                      batch_size, maxsubiter, init_state,
                                      randomize, mesh, chains)
        sh = _Shards(None, self._tx_data(data), 'torch')
        data, n = sh.parts[0], sh.n
        scale = batch_size / n
        gens = _generators(key, sh.device, chains)
        ch = _chains(gens, chains)
        state = (self._random_states(gens, sh, chains)
                 if randomize or init_state is None else init_state)

        def step(st, batch):
            outer_resp = self.expected_responsibilities(st, batch)
            for _ in range(maxsubiter):
                st = self._svi_inner(st, *self._cluster_stats(
                    batch, torch.softmax(self._inner_elc(st, batch), -1),
                    outer_resp, out=False), scale, step_size)
            return st._replace(
                outer_gating=self.outer_gating_prior.svi_blend(
                    st.outer_gating, torch.sum(outer_resp, 0), scale,
                    step_size))

        for _ in range(maxiter):
            idx = ch.stack([sample_batch_indices(g, n, batch_size)
                            for g in gens])
            state = ch.over(step)(state, tuple(a[idx] for a in data))
        return finite_report(state, 'fit_svi')

    def _svi_inner(self, state, stats, counts, scale, step_size):
        """One blend of every cluster's inner components and gating."""
        fam = self.family
        comps, gatings = vmap(
            lambda pc, pg, qc, qg, st, c: (
                fam.svi_blend(qc, pc, st, scale, step_size),
                pg.svi_blend(qg, c, scale, step_size)))(
            self.components_prior, self.inner_gating_prior,
            state.components, state.inner_gating, stats, counts)
        return state._replace(components=comps, inner_gating=gatings)

    def _fit_svi_mesh(self, data, key, maxiter, step_size, batch_size,
                      maxsubiter, init_state, randomize, mesh, chains):
        """fit_svi over a mesh (see fit_svi)."""
        n_dev = mesh.shape['data']
        if batch_size % n_dev:
            raise ValueError(f'batch_size={batch_size} must be a multiple '
                             f'of the data-mesh size {n_dev}')
        shards = _Shards(mesh, self._tx_data(data), 'torch', 131072)
        if shards.any_empty:
            raise ValueError(f'N={shards.n} leaves a shard of the '
                             f'{n_dev}-shard mesh empty: SVI draws from '
                             'every shard')
        scale = batch_size / shards.n
        gens = _generators(key, shards.device, chains)
        ch = _chains(gens, chains)
        state = (self._random_states(gens, shards, chains)
                 if randomize or init_state is None else init_state)
        gens = [shards.generators(g) for g in gens]
        local_b = batch_size // n_dev

        def tree(st, b, o, first):
            out = (torch.sum(o, 0),) if first else ()
            if maxsubiter:
                out += self._cluster_stats(b, torch.softmax(
                    self._inner_elc(st, b), -1), o, out=False)
            return out

        for _ in range(maxiter):
            batches = []
            for j, part in enumerate(shards.parts):
                idx = ch.stack([sample_batch_indices(
                    g[j], part[0].shape[0], local_b) for g in gens])
                batches.append(tuple(a[idx] for a in part))
            outer = [ch.over(self.expected_responsibilities)(state, b)
                     for b in batches]
            for sub in range(max(maxsubiter, 1)):
                trees = [ch.over(lambda st, bb, oo: tree(
                    st, bb, oo, sub == 0))(state, b, o)
                    for b, o in zip(batches, outer)]
                red = shards.mesh.reduce_tree(
                    trees, tree_map(torch.zeros_like, trees[0]), 'sweep')
                if sub == 0:
                    outer_counts, red = red[0], red[1:]
                if not maxsubiter:
                    break
                state = ch.over(lambda st, s, c: self._svi_inner(
                    st, s, c, scale, step_size))(state, *red)
            state = state._replace(outer_gating=ch.over(
                lambda g, c: self.outer_gating_prior.svi_blend(
                    g, c, scale, step_size))(state.outer_gating,
                                             outer_counts))
        return finite_report(state, 'fit_svi')

    # -- Gibbs (masked instead of hard-sliced) -------------------------------

    def _gibbs_inner_logp(self, params, probs, data):
        """(M, N, K): each cluster's plug-in log-probabilities under its
        sampled params and inner weights `probs` (M, K)."""
        return vmap(lambda p, pr: self.family.loglik(p, data)
                    + _log_clip(pr)[None, :])(params, probs)

    def _gibbs_inner_stats(self, z, outer_w, data):
        """(stats, counts) of each cluster from inner labels z (M, N),
        each point weighted by its outer one-hot column outer_w (N, M)."""
        return self._cluster_stats(
            data, one_hot(z, self.mixture_size, dtype=outer_w.dtype), outer_w)

    def _gibbs_sweep(self, state: HMixGibbsState, sh, gen, lgens, lead_draw,
                     maxsubiter, ch):
        """`maxsubiter` inner Gibbs rounds in every cluster at once
        (params | posterior, inner weights, inner labels | params,
        posterior | labels), then the outer gating | labels and the outer
        labels from each cluster's marginal loglik under the last round's
        draws, over the `_Shards` sh: the draws of params and weights
        come from `gen`, each shard's labels from its label generator
        (`lgens`; `lead_draw` keeps `gen` in step where this process does
        not hold data shard 0), and each round makes one reduction of
        every cluster's statistics (the first also of the outer counts).
        For C chains (`ch`, a `_Chains`) the draws run under one more vmap
        with randomness='different' and a round's reduction serves every
        chain."""
        fam, mm, kk = self.family, self.cluster_size, self.mixture_size
        labels = state.labels.shards
        outer_w = [one_hot(lab, mm, dtype=sh.dtype) for lab in labels]
        zero = sh.zero_part()
        zero_w = zero[0].new_zeros(ch.lead + (1, mm))
        zero_z = torch.zeros(ch.lead + (mm, 1), dtype=torch.int64,
                             device=sh.device)
        comps, gatings = state.components, state.inner_gating
        logp = [None] * len(sh.parts)
        z = [None] * len(sh.parts)
        outer_counts = None
        for sub in range(max(maxsubiter, 1)):
            first = sub == 0

            def tree(zj, wj, part):
                out = (torch.sum(wj, -2),) if first else ()
                if maxsubiter:
                    out += self._gibbs_inner_stats(zj, wj, part)
                return out
            if maxsubiter:
                params = ch.over(vmap(lambda q: fam.sample_params(gen, q),
                                   randomness='different'),
                              randomness='different')(comps)
                probs = ch.over(vmap(lambda g: g.sample(gen),
                                  randomness='different'),
                             randomness='different')(gatings)
                for j, part in enumerate(sh.parts):
                    if sh.rows(j):
                        logp[j] = ch.over(lambda p, pr: self._gibbs_inner_logp(
                            p, pr, part))(*on_device((params, probs),
                                                     part[0].device))
                        z[j] = sample_categorical_from_log(lgens[j], logp[j])
                lead_draw(lambda n: torch.rand(ch.lead + (mm, n, kk),
                                               generator=gen, dtype=sh.dtype,
                                               device=gen.device))
            red = sh.reduce_each(
                lambda j: tree(z[j], outer_w[j], sh.parts[j]),
                lambda: tree(zero_z, zero_w, zero), 'sweep')
            if first:
                outer_counts, red = red[0], red[1:]
            if maxsubiter:
                comps, gatings = ch.over(self._inner_posteriors)(*red)
        outer_gating = ch.over(self.outer_gating_prior.update)(outer_counts)
        log_w = ch.over(lambda g: _log_clip(g.sample(gen)),
                     randomness='different')(outer_gating)
        new = []
        for j, part in enumerate(sh.parts):
            if sh.rows(j):
                log_p_outer = (torch.logsumexp(logp[j], -1).transpose(-1, -2)
                               + log_w.to(part[0].device)[..., None, :])
                new.append(sample_categorical_from_log(
                    lgens[j], log_p_outer).to(torch.int32))
            else:
                new.append(labels[j])
        lead_draw(lambda n: torch.rand(ch.lead + (n, mm), generator=gen,
                                       dtype=sh.dtype, device=gen.device))
        return HMixGibbsState(outer_gating=outer_gating,
                              inner_gating=gatings, components=comps,
                              labels=state.labels._replace(
                                  shards=tuple(new)))

    def fit_gibbs(self, data, key=None, maxiter=100, maxsubiter=2,
                  init_labels='prior', mesh=None, chains=False):
        """Dense nested blocked Gibbs. `init_labels`: 'prior' (outer
        labels drawn from an outer-gating prior sample) or 'random'.
        Returns the final HMixGibbsState. With `mesh` (see fit_vi) the
        outer labels stay on their shards (a parallel.mesh.Sharded), a
        sweep makes one reduction an inner round, and each shard draws
        its labels from its own generator, data shard 0's the fit's
        (models.mixture `_label_generators`), so a one-position mesh is
        the unsharded chain draw for draw. With `chains`, `key` holds C
        chain keys: each chain's start labels come from its own
        generator, and the sweeps' draws from one generator seeded by the
        chains' (`batch_generator`), as the flat dense Gibbs: the same
        keys give the same chains, but a chain is not the single fit draw
        for draw (C-stacked state, labels (C, N))."""
        if maxsubiter < 1:
            raise ValueError('fit_gibbs draws the outer labels from the '
                             'last inner round: maxsubiter >= 1')
        sh = _Shards(mesh, self._tx_data(data), 'torch')
        gens = _generators(key, sh.device, chains)
        ch = _chains(gens, chains)
        lead_draw = shard0_draws(sh)
        per = [start_labels(sh, g, init_labels, self.cluster_size,
                            self.outer_gating_prior, lead_draw)
               for g in gens]
        priors = (self.outer_gating_prior, self.inner_gating_prior,
                  self.components_prior)
        if chains:
            priors = tuple(_stack_lead(p, ch.size) for p in priors)
        state = HMixGibbsState(*priors, labels=Sharded(
            tuple(ch.stack([p[j] for p in per])
                  for j in range(len(sh.parts))), sh.positions, sh.n))
        gen = batch_generator(gens) if chains else gens[0]
        lgens = _label_generators(gen, sh)
        for _ in range(maxiter):
            state = self._gibbs_sweep(state, sh, gen, lgens, lead_draw,
                                      maxsubiter, ch)
        if mesh is None:
            state = state._replace(labels=state.labels.shards[0])
        return finite_report(state, 'fit_gibbs')

    # -- prediction -----------------------------------------------------------

    def _log_mix_weights(self, state: HMixState):
        """(M, K) log [E[pi_outer]_m * E[pi_inner]_{m,k}] from the
        posterior means."""
        log_in = _log_clip(vmap(lambda g: g.mean())(state.inner_gating))
        return _log_clip(state.outer_gating.mean())[:, None] + log_in

    def _predictive_rows(self, state: HMixState, dist='studentt'):
        """B3's coefficients (thq (M*K, m8), aux (M*K, 8)) of the nested
        predictive density of an NIW or HierTied posterior, m-major. Each
        cluster's rows are built from its own posterior (a HierTied
        cluster's shared hyper scale is its own), then flattened."""
        thq, aux = vmap(lambda post, lw: predictive_coefficients(
            post, lw, dist == 'studentt'))(state.components,
                                           self._log_mix_weights(state))
        return (thq.reshape(-1, thq.shape[-1]).contiguous(),
                aux.reshape(-1, aux.shape[-1]).contiguous())

    def log_predictive(self, state: HMixState, data, dist='studentt',
                       backend='auto', mesh=None):
        """Marginal posterior-predictive log density, (N,): logsumexp over
        all (M, K) of mixture weights x component predictive. `dist`:
        'studentt' or the moment-matched 'gaussian'. On the kernel path
        (see the module docstring) NIW and HierTied posteriors are served
        by B3 over the M*K rows of `_predictive_rows`, in float32, cast
        back to the data's dtype; other families (the nested ILR's joint
        density) take the dense path, and raise under 'kernel'. With
        `mesh` every shard is served on its device (one B3 launch a CUDA
        shard, the rows built once, no collective) and the result is a
        parallel.mesh.Sharded of (n_j,) tensors."""
        if dist not in ('studentt', 'gaussian'):
            raise ValueError(f'unknown dist: {dist!r}')
        served = isinstance(state.components, (NIW, HierTied))
        if backend == 'kernel' and not served:
            raise NotImplementedError(
                'no serving kernel for this family; use '
                "backend='torch'")
        if mesh is not None:
            first, parts = _mesh_parts(mesh, data)
        else:
            first, parts = None, [as_data(data)]
        out = self._log_predictive_parts(state, parts, dist, backend,
                                         served)
        return out[0] if first is None else first._replace(shards=tuple(out))

    def _log_predictive_parts(self, state, parts, dist, backend, served):
        """log_predictive of each data tuple in `parts` (a mesh's shards,
        or the one whole): B3's rows built once, one launch a part."""
        if served and resolve_backend(backend, parts[0][0]):
            thq, aux = self._predictive_rows(state, dist)
            thq, aux = thq.to(torch.float32), aux.to(torch.float32)
            return [cuda_predict.serve_shard(
                part[0].to(torch.float32), lambda xt: cuda_predict.predict(
                    xt, thq.to(xt.device), aux.to(xt.device), xt.shape[1],
                    dist == 'studentt')).to(part[0].dtype) for part in parts]
        fn = (self.family.log_predictive if dist == 'studentt'
              else self.family.log_predictive_gaussian)
        log_w = self._log_mix_weights(state)                # (M, K)
        return [torch.logsumexp(vmap(lambda post: fn(post, part))(
            state.components) + log_w[:, None, :], (0, 2)) for part in parts]

    def init_transform(self, x, y):
        """Optional input/output standardization."""
        self.input_transform = Standardizer.fit(x)
        self.output_transform = Standardizer.fit(y)

    def _tx(self, x):
        return transform_points(self.input_transform, x)

    def _kernel_predict(self, state, xs, ys, prediction, incremental):
        """predict's kernel path over the parts xs (and ys, or None): B5
        (p = 1) or B6 (p > 1) once a part over the M*K flattened experts,
        the coefficients built once; one (mean, var, std, nlpd) a part."""
        basis_post, models_post = state.components
        flat_b, flat_m = _flatten_mk((basis_post, models_post))
        serve = (ilr_predict_cuda_sharded if models_post.M.shape[-2] == 1
                 else ilr_p_predict_cuda_sharded)
        outs = serve(flat_b, flat_m, self._log_mix_weights(state).reshape(-1),
                     [self._tx(x) for x in xs],
                     None if ys is None else [
                         transform_points(self.output_transform, y)
                         for y in ys], self.affine, prediction)
        return [from_kernel(self.output_transform, x, *out, incremental)
                for x, out in zip(xs, outs)]

    def predictive_weights(self, state: HMixState, x, dist='gaussian'):
        """(N, M, K) joint input-conditional weights: softmax over both
        levels of log E[pi_out] + log E[pi_in] + basis-predictive
        logpdf."""
        fn = (_niw.log_predictive_gaussian if dist == 'gaussian'
              else _niw.log_predictive_studentt)
        log_basis = vmap(lambda p: fn(p, x))(state.components[0])
        log_w = torch.movedim(
            log_basis + self._log_mix_weights(state)[:, None, :], 0, 1)
        w = torch.softmax(log_w.reshape(log_w.shape[0], -1), -1)
        return w.reshape(log_w.shape)

    def predictive_activation(self, state: HMixState, x):
        """Normalized two-level basis activations."""
        return self.predictive_weights(state, self._tx(x), dist='gaussian')

    def predictive_moments(self, state: HMixState, x, dist='gaussian'):
        """Per-(cluster, expert) predictive mean (N, M, K, p) and
        covariance (N, M, K, p, p)."""
        fn = (_mnw.predictive_moments_gaussian if dist == 'gaussian'
              else _mnw.predictive_moments_studentt)
        xa = _mnw.augment(x, self.affine)
        mus, covs = vmap(lambda p: fn(p, xa))(state.components[1])
        return torch.movedim(mus, 0, 1), torch.movedim(covs, 0, 1)

    def predict(self, state: HMixState, x, y=None, prediction='average',
                dist='gaussian', incremental=False, backend='auto',
                mesh=None):
        """Two-level posterior-predictive regression: 'mode' picks the
        argmax over all M*K experts, 'average' moment-matches the full
        two-level mixture. Returns (mean, var, std, nlpd) in original
        units (the NLPD carries the Jacobian sum(log scale)); nlpd is
        None without y. `incremental` adds the input back onto the
        prediction.

        `backend`: 'auto' serves Student-t predictions of CUDA data
        through B5 (p = 1) or B6 (p > 1) with the (M, K) posterior
        flattened to M*K experts (the two-level weight softmax is the
        flat softmax over the log mix weights + basis logpdf) and
        everything else through the dense path; 'kernel' requires the
        kernels (raising for CPU data and for dist='gaussian'); 'torch'
        forces the dense path. With `mesh`, every shard of x (and y) is
        served on its device (one B5 or B6 launch a CUDA shard, the
        coefficients built once, no collective); each result is a
        parallel.mesh.Sharded (nlpd None without y)."""
        if self.kind != 'ilr':
            raise ValueError('predict() is for make_ilr models; use '
                             'log_predictive for density models')
        if dist not in ('studentt', 'gaussian'):
            raise ValueError(f'unknown dist: {dist!r}')
        if backend == 'kernel' and dist != 'studentt':
            raise NotImplementedError(
                'fused serving needs studentt predictives; use '
                "backend='torch' (dense) for this config")
        if mesh is not None:
            return serve_sharded(
                mesh, x, y, backend, dist,
                lambda xs, ys: self._kernel_predict(
                    state, xs, ys, prediction, incremental),
                lambda xj, yj: self.predict(state, xj, yj, prediction, dist,
                                            incremental, backend))
        if resolve_backend(backend, x) and dist == 'studentt':
            return self._kernel_predict(state, [x], None if y is None
                                        else [y], prediction,
                                        incremental)[0]
        xx = self._tx(x)
        yy = None
        if y is not None:
            yy = transform_points(self.output_transform, y)
        basis_post, models_post = state.components
        n = x.shape[0]
        j = self.cluster_size * self.mixture_size
        w_f = self.predictive_weights(state, xx, dist).reshape(n, j)
        mus, covs = self.predictive_moments(state, xx, dist)
        mus_f = mus.reshape(n, j, -1)
        p = mus_f.shape[-1]
        covs_f = covs.reshape(n, j, p, p)
        if prediction == 'mode':
            k = torch.argmax(w_f, -1)            # first occurrence on ties
            idx = torch.arange(n, device=x.device)
            mu, cov = mus_f[idx, k], covs_f[idx, k]
        else:
            mu, cov = BayesianILR.mixture_moments(mus_f, covs_f, w_f)
        nlpd = None
        if y is not None:
            fn = (_mnw.log_predictive_gaussian if dist == 'gaussian'
                  else _mnw.log_predictive_studentt)
            xa = _mnw.augment(xx, self.affine)
            log_pl = vmap(lambda q: fn(q, xa, yy))(models_post)   # (M, N, K)
            log_pl = torch.movedim(log_pl, 0, 1).reshape(n, j)
            nlpd = -torch.logsumexp(log_pl + torch.log(w_f + 1e-37), -1)
            if self.output_transform is not None:
                # change of variables: p(y) = p(y_std) / prod(scale)
                nlpd = nlpd + torch.sum(torch.log(self.output_transform.scale))
        if self.output_transform is not None:
            mu = self.output_transform.inverse_transform(mu)
            cov = self.output_transform.scale_cov(cov)
        if incremental:
            mu = mu + x[:, :mu.shape[-1]]
        var = torch.diagonal(cov, dim1=-2, dim2=-1)
        return mu, var, torch.sqrt(var), nlpd


def _two_level_resp(seeds, n, m, k, dtype, device, start=0, total=None):
    """Random normalized two-level responsibilities (models.mixture's
    `_random_resp` at both levels) of points start..start+n-1 of `total`
    (by default n): outer (n, M) keyed by seeds[0], and inner (M, n, K)
    keyed by seeds[1], cluster c's rows at the point indices
    c total + i, so a shard's rows are those of the draw over all N."""
    total = n if total is None else total
    return (_random_resp(seeds[0], n, m, dtype, device, start),
            torch.stack([_random_resp(seeds[1], n, k, dtype, device,
                                      c * total + start)
                         for c in range(m)]))


def _anchor_indices(gen, n, shape, device):
    """prod(shape) distinct random point indices in `shape`, the ML and
    MAP engines' anchors."""
    return _flat_anchor_indices(gen, n, math.prod(shape), device).reshape(
        shape)
