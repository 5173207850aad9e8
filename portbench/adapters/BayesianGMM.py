"""The DP-GMM's adapter: everything the harness needs to know of the model
that a configuration names by `"model": "BayesianGMM"` (stick-breaking
gating over Normal-Wishart components), found by that name as
adapters/<model>.py. The adapters and harness/port.py are the only
modules of the benchmark that import the port.

The interface every adapter gives (the harness treats `model`, `data`,
a posterior and a state as opaque, and hands them back):

  make(config, data, device) -> model
      the port's model from config['make'] in config['dtype'] on
      `device`, raising where the process runs float32 products
      otherwise than config['tf32'] states; `data` is the fit data, for
      a model whose set-up takes something from it (a transform).
  data(config, seed, device) -> data
      the fit data from the seed: a tensor, or a tuple of tensors (such
      as inputs and outputs) whose first axis is the point.
  start(config, data, chains, seed) -> post
      each chain's starting posterior for traffic `"start": "anchor"`:
      a dict of tensors with a leading chain axis.
  fit(model, engine, data, keys, maxiter, start) -> post
      one call of the port's `engine` over the chains' keys, from
      `start` where it is not None (randomize=False): the result as a
      dict of tensors with a leading chain axis, the ELBO a sweep under
      `trace` where the engine gives one.
  state(model, post, chain) -> state
      the port's posterior state of chain `chain` of `post`.
  pool(config, seed, n, device) -> data
      n serving points from the seed, of the kind `data` gives.
  serve(model, state, pool, offset, n, traffic) -> tensor or tuple
      the serving call over points offset:offset+n of the pool, as the
      traffic mix's parameters say; it may return several tensors.
  shape(model, data) -> dict
      the work count's shape (work/<kernel>.py): `n` (the points
      `data` holds, which the harness also counts a call's work and
      places requests by), `d`, `k` and any further width, such as an
      output width. The harness adds `chains` to a fit's and sets `n`
      to each request's size in serving.
  numbers_fit(config, engine, data, start, outs) -> {name: float}
      after the window, the numbers that limits/<workload>.json limits,
      of a fit cell's outputs `outs` (a list of what `fit` returned, one
      a kept call, or the control's in their place) against the
      reference from the same data and start (None where the engine
      starts itself).
  control_fit(config, engine, data, start, outs, maxiter, g) -> outs
      the control's outputs in the port's place: the reference in the
      control's precision, from the same data and start, over `maxiter`
      sweeps or from the port's kept `outs` where the check follows
      them; `g` its generator.
  numbers_serve(config, pool, posterior, outs) -> {name: float}
      of a serving cell's kept requests `outs` (dicts of `offset`, `n`
      and `out`, what `serve` returned) against the reference's answers
      from the pool and the served posterior (the set-up fit's chain
      0 as `fit` gives it). The harness adds numbers_fit of the set-up
      fit, each name prefixed `fit_`.
  control_serve(config, pool, posterior, outs, g) -> outs
      the control's answers in the place of the port's kept `outs`.
  FAULTS
      {name: plant(assign=setattr)}: faults planted in the port for
      calibrate.py --fault and the tests. A fault patches the port, not
      the adapter, which every run loads afresh.

The DP-GMM's data are Gaussian blobs (config['data']: weights,
mean_scale, precision, n, and `means_seed` to fix the means for every
run seed). Its checks, against reference/dpgmm.py in float64 from the
benchmark's own inputs:

  fit_vi_fused     every kept call: the ELBO trace, relative to the
                   reference's (elbo_gap), the final posterior as the
                   statistics it accumulates (post_gap), and its counts
                   a component by Pearson's statistic (count_chi2),
                   against float64 VI from the same start.
  fit_gibbs_fused  every kept call: the final labels against draws from
                   their conditional given the call's final parameters
                   and weights (label_count_z); the final posterior
                   against the conjugate update of those labels'
                   statistics (post_gap); and the final parameter and
                   weight draws against that posterior (draw_z2_dev:
                   reference.draw_z2_dev of draw_test's groups, pooled
                   over the kept calls).
  serve            every kept request: the log-densities against the
                   float64 Student-t mixture of the served posterior
                   (logp_gap); the harness adds the set-up fit that made
                   that posterior, as fit_vi_fused's numbers
                   (fit_elbo_gap, fit_post_gap).
"""

import math
from typing import Any, NamedTuple

import torch

from harness import gen
from harness.port import import_port
from reference import dpgmm

import_port()

from mimo_tpu_torch.distributions import niw  # noqa: E402
from mimo_tpu_torch.distributions.gating import StickBreaking  # noqa: E402
from mimo_tpu_torch.distributions.niw import NIW  # noqa: E402
from mimo_tpu_torch.models import BayesianGMM, mixture  # noqa: E402
from mimo_tpu_torch.models.mixture import MFState  # noqa: E402
from mimo_tpu_torch.ops import cuda_estep, family_estep  # noqa: E402
from mimo_tpu_torch.parallel import fit_chains  # noqa: E402

POST_KEYS = ('mu', 'kappa', 'psi', 'nu', 'gamma', 'delta')


class Model(NamedTuple):
    gmm: Any                 # the port's BayesianGMM
    dtype: torch.dtype       # what it fits and serves in


def make(config, data, device):
    if torch.backends.cuda.matmul.allow_tf32 != config['tf32']:
        raise RuntimeError(
            f"the port runs float32 products with TF32 "
            f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}; "
            f"the configuration states tf32={config['tf32']}")
    dtype = getattr(torch, config['dtype'])
    return Model(BayesianGMM.make(**config['make'], dtype=dtype,
                                  device=device), dtype)


# -- data ------------------------------------------------------------------

def blob_means(data, d, seed, device):
    """The blobs' means, N(0, I) * mean_scale: drawn from the run's seed,
    or, where the configuration fixes `means_seed`, from that seed on the
    host, the same on every device and in every run."""
    shape = (len(data['weights']), d)
    if 'means_seed' in data:
        g = torch.Generator().manual_seed(gen.sub_seed(data['means_seed'],
                                                       'means'))
        means = torch.randn(shape, generator=g).to(device)
    else:
        means = torch.randn(shape, generator=gen.generator(seed, device,
                                                           'means'),
                            device=device)
    return means * float(data['mean_scale'])


def blob_points(data, means, n, g):
    """n points of the blob mixture: label by the weights, then the blob's
    mean plus N(0, I / precision) noise, float32."""
    w = torch.tensor(data['weights'], dtype=torch.float32,
                     device=means.device)
    labels = torch.multinomial(w, n, replacement=True, generator=g)
    noise = torch.randn((n, means.shape[1]), generator=g,
                        device=means.device)
    return means[labels] + noise / math.sqrt(float(data['precision']))


def data(config, seed, device):
    """The configuration's fit data (N, d) float32."""
    d = config['make']['dim']
    means = blob_means(config['data'], d, seed, device)
    return blob_points(config['data'], means, int(config['data']['n']),
                       gen.generator(seed, device, 'data'))


def pool(config, seed, n, device):
    """n serving points of the fit data's blobs."""
    means = blob_means(config['data'], config['make']['dim'], seed, device)
    return blob_points(config['data'], means, n,
                       gen.generator(seed, device, 'pool'))


def start(config, x, chains, seed, sub=65536):
    """Each chain's starting posterior, float32 (C, K, ...): a subsample of
    `sub` points assigned to the nearest of K of them, its statistics
    scaled to the N points and taken through the conjugate update in
    float64 (the reference's). A fit from here starts with the components
    apart, as a warm restart does."""
    make = config['make']
    k, (n, d) = make['size'], x.shape
    prior = dpgmm.make_prior(make, d, torch.float64, x.device)
    g = gen.generator(seed, x.device, 'start')
    stats = []
    for _ in range(chains):
        pts = x[torch.randint(0, n, (sub,), generator=g,
                              device=x.device)].double()
        z = torch.argmin(torch.cdist(pts, pts[:k]), 1)
        resp = torch.nn.functional.one_hot(z, k).double()[:, None, :]
        stats.append([s[0] * (n / sub)
                      for s in dpgmm.stats_from_resp(pts, resp)])
    counts, sx, sxx = (torch.stack(s) for s in zip(*stats))
    return dpgmm.cast(dpgmm.posterior(prior, counts, sx, sxx), torch.float32)


# -- the port's calls --------------------------------------------------------

def state(model, post, chain=None):
    """The port's MFState of a benchmark posterior dict (C, K, ...), or of
    its chain `chain` alone."""
    p = post if chain is None else {k: v[chain] for k, v in post.items()}
    p = {k: v.to(model.dtype) for k, v in p.items()}
    return MFState(NIW(p['mu'], p['kappa'], p['psi'], p['nu']),
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
    def lead(t):
        return t if chains else t[None]
    if isinstance(out, tuple) and len(out) == 2 and not hasattr(
            out, '_fields'):                    # (MFState, trace)
        st, trace = out
        comp, gating = st.components, st.gating
        return dict(mu=lead(comp.mu), kappa=lead(comp.kappa),
                    psi=lead(comp.psi), nu=lead(comp.nu),
                    gamma=lead(gating.gamma), delta=lead(gating.delta),
                    trace=lead(trace))
    comp, gating = out.components, out.gating   # GibbsState
    return dict(mu=lead(comp.mu), kappa=lead(comp.kappa),
                psi=lead(comp.psi), nu=lead(comp.nu),
                gamma=lead(gating.gamma), delta=lead(gating.delta),
                p_mu=lead(out.params.mu), p_lmbda=lead(out.params.lmbda),
                log_pi=lead(out.log_pi), labels=lead(out.labels))


def serve(model, state, pool, offset, n, traffic):
    """log_predictive (traffic `dist`) of the pool's points
    offset:offset+n."""
    return model.gmm.log_predictive(
        state, pool[offset:offset + n].to(model.dtype),
        dist=traffic['dist'])


def shape(model, x):
    n, d = x.shape
    return dict(n=n, d=d, k=model.gmm.size)


# -- the check ---------------------------------------------------------------

def post_gap(out, ref):
    """Worst leaf of the posterior's statistics (reference.natural): per
    chain, max |port - ref| over the leaf's entries over max |ref|."""
    a = (out['natural'] if 'natural' in out
         else dpgmm.natural({k: out[k] for k in POST_KEYS}))
    b = dpgmm.natural(ref)
    worst = 0.0
    for key in a:
        diff = (a[key] - b[key]).flatten(1).abs().amax(1)
        scale = b[key].flatten(1).abs().amax(1).clamp(min=1e-300)
        worst = max(worst, float((diff / scale).max()))
    return worst


def elbo_gap(trace, ref_trace):
    rel = (trace.double() - ref_trace) / ref_trace.abs()
    return float(rel.abs().max())


def count_chi2(out, ref, prior):
    """Pearson's statistic of the final counts a component, per chain:
    the mean over components of (n_port - n_ref)^2 / (n_ref + 1), n the
    points a component holds (kappa - kappa_0). A fit over a resample
    of the points reads about 1, whatever the seed."""
    a = (out['natural'] if 'natural' in out else out)['kappa'].double()
    n = (ref['kappa'] - prior['kappa']).clamp(min=0.0)
    return float(((a - ref['kappa']) ** 2 / (n + 1.0)).mean(-1).max())


def vi_numbers(x, config, start, outs, prefix=''):
    """elbo_gap, post_gap and count_chi2 of each output against float64
    VI from the same start, after as many sweeps as the output's trace
    (a control stopped on a scale that is not positive definite ran
    fewer)."""
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float64,
                             x.device)
    refs, e, p, c = {}, 0.0, 0.0, 0.0
    for o in outs:
        sweeps = o['trace'].shape[-1]
        if sweeps not in refs:
            refs[sweeps] = dpgmm.vi_fit(x, prior, start, sweeps)
        ref, ref_trace = refs[sweeps]
        e = max(e, elbo_gap(o['trace'], ref_trace))
        p = max(p, post_gap(o, ref))
        c = max(c, count_chi2(o, ref, prior))
    return {prefix + 'elbo_gap': e, prefix + 'post_gap': p,
            prefix + 'count_chi2': c}


def vi_control(x, config, start, maxiter):
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float32,
                             x.device)
    post, trace = dpgmm.vi_fit(x, prior, start, maxiter, mode='tf32')
    return [{**post, 'trace': trace}]


def gibbs_numbers(x, config, outs):
    k = config['make']['size']
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float64,
                             x.device)
    count_z = gap = 0.0
    draws = {}
    for o in outs:
        cz = dpgmm.label_test(x, o['p_mu'], o['p_lmbda'], o['log_pi'],
                              o['labels'])
        count_z = max(count_z, float(cz.abs().max()))
        ref = dpgmm.posterior(prior, *dpgmm.stats_from_labels(x, o['labels'],
                                                              k))
        gap = max(gap, post_gap(o, ref))
        for key, z in dpgmm.draw_test(ref, o['p_mu'], o['p_lmbda'],
                                      o['log_pi']).items():
            draws.setdefault(key, []).append(z)
    return {'label_count_z': count_z, 'post_gap': gap,
            'draw_z2_dev': dpgmm.draw_z2_dev(
                {key: torch.cat(z) for key, z in draws.items()})}


def gibbs_control(x, config, outs, g):
    """The reference's last Gibbs stage in the control's precision, from
    each kept call's parameters and weights: its labels, their
    statistics and the conjugate update."""
    k = config['make']['size']
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float32,
                             x.device)
    out = []
    for o in outs:
        labels = dpgmm.gibbs_labels(x, o['p_mu'], o['p_lmbda'], o['log_pi'],
                                    g, mode='tf32')
        post = dpgmm.posterior(prior, *dpgmm.stats_from_labels(
            x, labels, k, mode='tf32'))
        out.append({**o, **post, 'labels': labels})
    return out


def numbers_fit(config, engine, x, start, outs):
    if engine == 'fit_vi_fused':
        return vi_numbers(x, config, start, outs)
    if engine == 'fit_gibbs_fused':
        return gibbs_numbers(x, config, outs)
    raise NotImplementedError(f'no check for engine {engine!r}')


def control_fit(config, engine, x, start, outs, maxiter, g):
    if engine == 'fit_vi_fused':
        return vi_control(x, config, start, maxiter)
    if engine == 'fit_gibbs_fused':
        return gibbs_control(x, config, outs, g)
    raise NotImplementedError(f'no control for engine {engine!r}')


def numbers_serve(config, pool, posterior, outs):
    gap = 0.0
    for o in outs:
        ref = dpgmm.predictive(pool[o['offset']:o['offset'] + o['n']],
                               posterior)
        gap = max(gap, float((o['out'].double() - ref).abs().max()))
    return {'logp_gap': gap}


def control_serve(config, pool, posterior, outs, g):
    return [{**o, 'out': dpgmm.predictive(
        pool[o['offset']:o['offset'] + o['n']], posterior, mode='tf32')}
        for o in outs]


# -- faults ------------------------------------------------------------------
# Each is planted where the port produces its result, on the kernels'
# path (ops/cuda_estep.py) and on the plain path (ops/family_estep.py)
# alike, so that calibrate.py reads it on the card and the tests on the
# CPU.

def _doubled(res):
    def two(t):
        return 2.0 * t
    return res._replace(stats=type(res.stats)(*map(two, res.stats)),
                        lse=two(res.lse), counts=two(res.counts))


def stuck(assign=setattr):
    """Every fit sweep returns the state it was given; Gibbs labels stay
    at their start."""
    loop = mixture._elbo_loop

    def frozen(step, carry, maxiter, tol, lead=()):
        return loop(lambda c, i: (c, step(c, i)[1]), carry, maxiter, tol,
                    lead)
    assign(mixture, '_elbo_loop', frozen)
    gibbs = family_estep.fused_gibbs_sharded

    def same_labels(*args):
        labels, res = gibbs(*args)
        return [torch.zeros_like(z) for z in labels], res
    assign(family_estep, 'fused_gibbs_sharded', same_labels)


def half_batch(assign=setattr):
    """The E-step over the first half of each shard's points, its
    statistics, lse and counts doubled (the mean over the rest); Gibbs'
    statistics likewise, its labels whole."""
    kernel = cuda_estep.fused_estep_cuda_sharded
    plain = family_estep.fused_estep_sharded
    gibbs = family_estep.fused_gibbs_sharded

    def half_kernel(spec, post, log_pi, shards, mesh, ns=None):
        ns = [xts[0].shape[1] for xts in shards] if ns is None else ns
        return _doubled(kernel(spec, post, log_pi, shards, mesh,
                               [n // 2 for n in ns]))

    def halves(shards):
        return [tuple(a[:a.shape[0] // 2] for a in s) for s in shards]

    def half_plain(spec, post, log_pi, shards, *a):
        return _doubled(plain(spec, post, log_pi, halves(shards), *a))

    def half_gibbs(spec, seed, params, log_pi, shards, *a):
        labels, _ = gibbs(spec, seed, params, log_pi, shards, *a)
        _, res = gibbs(spec, seed, params, log_pi, halves(shards), *a)
        return labels, _doubled(res)
    assign(cuda_estep, 'fused_estep_cuda_sharded', half_kernel)
    assign(family_estep, 'fused_estep_sharded', half_plain)
    assign(family_estep, 'fused_gibbs_sharded', half_gibbs)


def altered(assign=setattr):
    """An answer altered where it is produced: the E-step's statistics of
    the largest component off by 10%, one Gibbs label in a hundred moved
    to the next component, one density in a hundred off by 0.1 nats."""
    def off_largest(estep):
        def bad(*args):
            res = estep(*args)
            k = res.counts.shape[-1]
            scale = 1.0 + 0.1 * torch.nn.functional.one_hot(
                torch.argmax(res.counts, -1), k).to(res.counts.dtype)

            def off(t):
                return t * scale.reshape(scale.shape + (1,) * (
                    t.dim() - scale.dim()))
            return res._replace(stats=type(res.stats)(*map(off, res.stats)),
                                counts=off(res.counts))
        return bad
    for module, name in ((cuda_estep, 'fused_estep_cuda_sharded'),
                         (family_estep, 'fused_estep_sharded')):
        assign(module, name, off_largest(getattr(module, name)))
    gibbs = family_estep.fused_gibbs_sharded
    parts = mixture.BayesianMixture._log_predictive_parts

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
    assign(family_estep, 'fused_gibbs_sharded', bad_gibbs)
    assign(mixture.BayesianMixture, '_log_predictive_parts', bad_parts)


def mode_draws(assign=setattr):
    """Gibbs takes each component's and each stick's posterior mode where
    it should draw them."""
    made = BayesianGMM.make

    def planted(*args, **kw):
        model = made(*args, **kw)
        model.family = model.family._replace(
            sample_params=lambda g, q: niw.mode_params(q))
        return model
    assign(BayesianGMM, 'make', staticmethod(planted))
    assign(StickBreaking, 'sample', lambda sticks, g: sticks.mode())


FAULTS = {'stuck': stuck, 'half_batch': half_batch, 'altered': altered,
          'mode_draws': mode_draws}
