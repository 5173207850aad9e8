"""Whether what the timed path produced is correct: the port's outputs
kept from the window against the plain reference (reference/dpgmm.py),
worked out again from the benchmark's own inputs. Each traffic kind
gives numbers; limits/<workload>.json gives each its limit; the run is
correct when every number is finite and within its limit.

  fit_vi_fused     every kept call: the ELBO trace, relative to the
                   reference's (elbo_gap), and the final posterior as
                   the statistics it accumulates (post_gap), against
                   float64 VI from the same start.
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
                   (logp_gap); and the set-up fit that made that
                   posterior, as fit_vi_fused's numbers (fit_elbo_gap,
                   fit_post_gap).

`mode` 'tf32' puts the reference, in the control's precision, in the
port's place: the numbers it reads are the control's."""

import torch

from reference import dpgmm

POST_KEYS = ('mu', 'kappa', 'psi', 'nu', 'gamma', 'delta')


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


def vi_numbers(x, config, start, outs, prefix=''):
    """elbo_gap and post_gap of each output against float64 VI from the
    same start, after as many sweeps as the output's trace (a control
    stopped on a scale that is not positive definite ran fewer)."""
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float64,
                             x.device)
    refs, e, p = {}, 0.0, 0.0
    for o in outs:
        sweeps = o['trace'].shape[-1]
        if sweeps not in refs:
            refs[sweeps] = dpgmm.vi_fit(x, prior, start, sweeps)
        ref, ref_trace = refs[sweeps]
        e = max(e, elbo_gap(o['trace'], ref_trace))
        p = max(p, post_gap(o, ref))
    return {prefix + 'elbo_gap': e, prefix + 'post_gap': p}


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


def gibbs_control(x, config, outs, gen):
    """The reference's last Gibbs stage in the control's precision, from
    each kept call's parameters and weights: its labels, their
    statistics and the conjugate update."""
    k = config['make']['size']
    prior = dpgmm.make_prior(config['make'], x.shape[1], torch.float32,
                             x.device)
    out = []
    for o in outs:
        labels = dpgmm.gibbs_labels(x, o['p_mu'], o['p_lmbda'], o['log_pi'],
                                    gen, mode='tf32')
        post = dpgmm.posterior(prior, *dpgmm.stats_from_labels(
            x, labels, k, mode='tf32'))
        out.append({**o, **post, 'labels': labels})
    return out


def serve_numbers(pool, outs, posterior):
    gap = 0.0
    for o in outs:
        ref = dpgmm.predictive(pool[o['offset']:o['offset'] + o['n']],
                               posterior)
        gap = max(gap, float((o['out'].double() - ref).abs().max()))
    return {'logp_gap': gap}


def serve_control(pool, outs, posterior):
    return [{**o, 'out': dpgmm.predictive(
        pool[o['offset']:o['offset'] + o['n']], posterior, mode='tf32')}
        for o in outs]


def numbers(cell, drv, x, mode='f64', gen=None):
    """The cell's compared numbers from the driver's kept outputs (after
    the window), or with mode 'tf32' the control's."""
    kind, kept = cell.traffic['kind'], drv.sampler.kept()
    if kind == 'serve':
        outs = kept if mode == 'f64' else serve_control(drv.pool, kept,
                                                        drv.posterior)
        fit = ([drv.fit_out] if mode == 'f64' else
               vi_control(x, cell.config, drv.start, drv.fit_maxiter))
        return {**serve_numbers(drv.pool, outs, drv.posterior),
                **vi_numbers(x, cell.config, drv.start, fit,
                             prefix='fit_')}
    outs = [k['out'] for k in kept]
    if drv.engine == 'fit_vi_fused':
        if mode != 'f64':
            outs = vi_control(x, cell.config, drv.start, drv.maxiter)
        return vi_numbers(x, cell.config, drv.start, outs)
    if drv.engine == 'fit_gibbs_fused':
        if mode != 'f64':
            outs = gibbs_control(x, cell.config, outs, gen)
        return gibbs_numbers(x, cell.config, outs)
    raise NotImplementedError(f'no check for engine {drv.engine!r}')


def finite_outputs(drv):
    """How many kept outputs hold a non-finite value."""
    bad = 0
    for k in drv.sampler.kept():
        out = k['out']
        leaves = out.values() if isinstance(out, dict) else [out]
        bad += any(t.is_floating_point() and not bool(torch.isfinite(t).all())
                   for t in leaves)
    return bad


def judge(found, limits):
    """(correct, [(name, value, limit)]): every limit's number present,
    finite and at most its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = found.get(name)
        good = (value is not None and value == value
                and abs(value) != float('inf') and value <= limit)
        ok &= good
        rows.append((name, value, limit))
    return ok, rows
