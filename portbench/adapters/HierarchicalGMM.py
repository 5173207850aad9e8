"""The hierarchical DP-GMM's adapter: a configuration names it by
`"model": "HierarchicalGMM"` (stick-breaking gating over Gaussians whose K
means share one Normal-Wishart hyper-prior and one precision,
BayesianGMM.make(hierarchical=True)). The interface is the one
adapters/BayesianGMM.py's docstring gives.

From the DP-GMM's adapter it takes the model's build (BayesianGMM.make,
its TF32 guard), the data (the blobs), the serving pool, the work count's
shape and the faults planted at the kernels' level (`stuck`, `half_batch`,
`altered`); the rest is its own: the anchor start, the fit and its
unpacking, the state, and the check against reference/hgmm.py in float64
from the benchmark's own inputs:

  fit_vi_fused  every kept call: the ELBO trace, relative to the
                reference's (elbo_gap); the final posterior leaf by leaf,
                the hyper-posterior's mu, kappa, psi and nu, the q(mu_k)
                means, kappas and kappas0, and the sticks' gamma and delta
                (post_gap); the final counts a component by Pearson's
                statistic (count_chi2); against float64 VI from the same
                start.

A posterior dict holds reference/hgmm.py's leaves with a leading chain
axis. It uses only the port's public API, so a checkout without the
hierarchical family's span and counter runs it alike. No serving check:
no cell serves this model. Its own fault, `few_rounds`, runs the update
with 12 of its 25 inner rounds.
"""

from pathlib import Path

import torch

from harness import cells, gen
from harness.port import import_port
from reference import hgmm

import_port()

from mimo_tpu_torch.distributions import hierarchical  # noqa: E402
from mimo_tpu_torch.distributions.gating import StickBreaking  # noqa: E402
from mimo_tpu_torch.distributions.hierarchical import HierTied  # noqa: E402
from mimo_tpu_torch.distributions.niw import NIW  # noqa: E402
from mimo_tpu_torch.models.mixture import MFState  # noqa: E402
from mimo_tpu_torch.parallel import fit_chains  # noqa: E402

gmm = cells.adapter('BayesianGMM', Path(__file__).resolve().parents[1])
data, pool, shape, elbo_gap = gmm.data, gmm.pool, gmm.shape, gmm.elbo_gap


def make(config, data, device):
    """BayesianGMM's build (its TF32 guard included) of a configuration
    that asks for the hierarchical family."""
    if not config['make'].get('hierarchical'):
        raise ValueError('the hierarchical GMM takes make.hierarchical: true')
    return gmm.make(config, data, device)


def nb_iter(config):
    return int(config['make'].get('maxsubiter', hgmm.NB_ITER))


def start(config, x, chains, seed):
    """Each chain's starting posterior, float32 (C, ...): BayesianGMM's
    recipe (65,536 points, each assigned to the nearest of K of them,
    their statistics scaled to the N points) through the hierarchical
    update in float64 (the reference's)."""
    post = hgmm.anchor_start(x, config['make'], chains,
                             gen.generator(seed, x.device, 'start'))
    return hgmm.cast(post, torch.float32)


# -- the port's calls --------------------------------------------------------

def state(model, post, chain=None):
    """The port's MFState of a benchmark posterior dict (C, ...), or of
    its chain `chain` alone."""
    p = post if chain is None else {k: v[chain] for k, v in post.items()}
    p = {k: v.to(model.dtype) for k, v in p.items()}
    hyper = NIW(mu=p['hyper_mu'][..., None, :],
                kappa=p['hyper_kappa'][..., None],
                psi=p['hyper_psi'][..., None, :, :],
                nu=p['hyper_nu'][..., None])
    return MFState(HierTied(hyper=hyper, mus=p['mus'], kappas=p['kappas'],
                            kappas0=p['kappas0']),
                   StickBreaking(p['gamma'], p['delta']))


def fit(model, engine, x, keys, maxiter, start=None):
    """A single chain calls the engine itself, more go through
    fit_chains."""
    kw = {} if start is None else dict(randomize=False)
    x = x.to(model.dtype)
    if len(keys) == 1:
        if start is not None:
            kw['init_state'] = state(model, start, 0)
        out = getattr(model.gmm, engine)(x, key=keys[0], maxiter=maxiter,
                                         **kw)
    else:
        if start is not None:
            kw['init_state'] = state(model, start)
        out = fit_chains(model.gmm, engine, x, list(keys), maxiter=maxiter,
                         **kw)
    return unpack(out, chains=len(keys) > 1)


def unpack(out, chains):
    """A VI fit's (MFState, trace) as a posterior dict with a chain
    axis."""
    def lead(t):
        return t if chains else t[None]
    st, trace = out
    comp, gating = st.components, st.gating
    h = comp.hyper
    return dict(hyper_mu=lead(h.mu[..., 0, :]),
                hyper_kappa=lead(h.kappa[..., 0]),
                hyper_psi=lead(h.psi[..., 0, :, :]),
                hyper_nu=lead(h.nu[..., 0]), mus=lead(comp.mus),
                kappas=lead(comp.kappas), kappas0=lead(comp.kappas0),
                gamma=lead(gating.gamma), delta=lead(gating.delta),
                trace=lead(trace))


def serve(model, state, pool, offset, n, traffic):
    raise NotImplementedError('no cell serves the hierarchical GMM')


# -- the check ---------------------------------------------------------------

def post_gap(out, ref):
    """Worst leaf of the posterior: per chain, max |port - ref| over the
    leaf's entries over max |ref|."""
    worst = 0.0
    for key in hgmm.LEAVES:
        b = ref[key].double().reshape(ref[key].shape[0], -1)
        a = out[key].double().reshape(b.shape)
        diff = (a - b).abs().amax(1)
        scale = b.abs().amax(1).clamp(min=1e-300)
        worst = max(worst, float((diff / scale).max()))
    return worst


def count_chi2(out, ref):
    """Pearson's statistic of the final counts a component, per chain:
    the mean over components of (n_port - n_ref)^2 / (n_ref + 1), n the
    points a component holds (kappas - kappas0)."""
    a = out['kappas'].double() - out['kappas0'].double()
    n = (ref['kappas'] - ref['kappas0']).double().clamp(min=0.0)
    return float(((a - n) ** 2 / (n + 1.0)).mean(-1).max())


def vi_numbers(x, config, start, outs):
    """elbo_gap, post_gap and count_chi2 of each output against float64
    VI from the same start, after as many sweeps as the output's trace
    (a control stopped on a scale that is not positive definite ran
    fewer)."""
    prior = hgmm.make_prior(config['make'], x.shape[1], torch.float64,
                            x.device)
    refs, e, p, c = {}, 0.0, 0.0, 0.0
    for o in outs:
        sweeps = o['trace'].shape[-1]
        if sweeps not in refs:
            refs[sweeps] = hgmm.vi_fit(x, prior, start, sweeps,
                                       nb_iter=nb_iter(config))
        ref, ref_trace = refs[sweeps]
        e = max(e, elbo_gap(o['trace'], ref_trace))
        p = max(p, post_gap(o, ref))
        c = max(c, count_chi2(o, ref))
    return {'elbo_gap': e, 'post_gap': p, 'count_chi2': c}


def numbers_fit(config, engine, x, start, outs):
    if engine == 'fit_vi_fused':
        return vi_numbers(x, config, start, outs)
    raise NotImplementedError(f'no check for engine {engine!r}')


def control_fit(config, engine, x, start, outs, maxiter, g):
    """The reference in TF32 from the same start, over `maxiter` sweeps."""
    if engine != 'fit_vi_fused':
        raise NotImplementedError(f'no control for engine {engine!r}')
    prior = hgmm.make_prior(config['make'], x.shape[1], torch.float32,
                            x.device)
    post, trace = hgmm.vi_fit(x, prior, start, maxiter, mode='tf32',
                              nb_iter=nb_iter(config))
    return [{**post, 'trace': trace}]


def numbers_serve(config, pool, posterior, outs):
    raise NotImplementedError('no cell serves the hierarchical GMM')


def control_serve(config, pool, posterior, outs, g):
    raise NotImplementedError('no cell serves the hierarchical GMM')


# -- faults ------------------------------------------------------------------

def few_rounds(assign=setattr):
    """The hierarchical update runs 12 of its inner rounds (the
    configuration's 25)."""
    update = hierarchical.posterior_update

    def short(prior, stats, nb_iter=hgmm.NB_ITER):
        return update(prior, stats, 12)
    assign(hierarchical, 'posterior_update', short)


FAULTS = {'stuck': gmm.stuck, 'half_batch': gmm.half_batch,
          'altered': gmm.altered, 'few_rounds': few_rounds}
