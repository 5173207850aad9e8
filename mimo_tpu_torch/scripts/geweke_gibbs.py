"""Geweke joint-distribution test of the FULL Gibbs transition (port of
the JAX repository's scripts/geweke_gibbs.py): every sampled conditional
of the production sweep, for all 8 families.

The fixed-state two-sample test (ops/precision.py) certifies only the
label conditional; this tests everything else too: the conjugate
updates and the SAMPLED parameter conditionals (the Bartlett Wishart,
the Gaussian mean draw, the stick-breaking Beta draws, the Matrix-Normal
expert draws, the Gamma draws of the diagonal families, the exact tied,
hierarchical and tied-affine draws) and the two-level nested sweep
(models/hmix.py's joint flat label draw + the vmapped sub-model draws).

Geweke (2004, "Getting it right"): if the Gibbs transition
T(theta' | theta, y) leaves p(theta | y) invariant for every y, then the
chain

    y_t ~ p(y | theta_{t-1}),   theta_t ~ T(. | theta_{t-1}, y_t)

has stationary marginal theta_t ~ p(theta), the PRIOR. So every marginal
statistic of (theta, y) must match between (a) iid prior draws (params
and weights from the prior, data generated from them) and (b) the
successive-conditional chain that regenerates the data each sweep and
applies the production transition. A bias in ANY sampled conditional
shifts the stationary distribution and shows as a large z-score.

Families whose Gibbs step is a Family.gibbs_update (tied, hier,
tied-affine, nested) draw the prior with gibbs_update at ZERO statistics:
the exact conditional at no data is the prior.

z = (mean_a - mean_b) / sqrt(se_a^2 + se_b^2), se_b from batch means
(the chain autocorrelates). |z| > ~4 on any statistic indicates a
transition bug; healthy runs sit under ~3.5 at 1,500 draws and ~3 at
20,000.

Backends: `plain` runs the label sweep through the blockwise twin
(ops/family_estep.py::fused_gibbs_blockwise) on the CPU, in float64 by
default; `cuda` through kernel B2 (ops/cuda_gibbs.py::fused_gibbs_cuda)
on the card, in float32; it raises without a card. Both draw B2's Philox
labels from int64 sweep seeds taken from the side's torch.Generator.

    python -m mimo_tpu_torch.scripts.geweke_gibbs                 # CPU f64
    python -m mimo_tpu_torch.scripts.geweke_gibbs --backend cuda --family hier
    python -m mimo_tpu_torch.scripts.geweke_gibbs --family tied-affine \\
        --draws 40000
"""

import argparse
import json
import sys

import numpy as np
import torch
from torch.func import vmap

FAMILIES = ['gmm', 'ilr', 'diag', 'tied', 'tied-diag', 'hier',
            'tied-affine', 'nested']
# the names of the arcsinh data moments that end every family's vector:
# the JAX script appends them to the seven flat families' vectors without
# naming them, so its summary never scores them; here they are named and
# scored in all eight (the vectors stay equal to JAX's)
GMM_MOMENTS = ['mean_x0', 'var_x0', 'mean_xx']
ILR_MOMENTS = ['mean_x0', 'var_x0', 'mean_y0', 'var_y0', 'mean_xy']


def _arcsinh_moments(arrs):
    """Variance-stabilised data moments: prior-predictive tails are
    Student-t-like, raw sample variances break the CLT z and can overflow
    f32; arcsinh is monotone and applied identically to both sides."""
    return torch.asinh(torch.stack(arrs))


def _log_clip(p):
    return torch.log(torch.clamp(p, min=1e-37))


def _zero_stats(family, data_dims, kk, dtype, device):
    """family.suff_stats of a zero-weighted dummy point: the exact
    conditional at zero statistics is the prior, so gibbs_update(gen,
    prior, zero_stats) IS a prior draw for gibbs_update families."""
    dummy = tuple(torch.zeros((1, d), dtype=dtype, device=device)
                  for d in data_dims)
    return family.suff_stats(dummy, torch.zeros((1, kk), dtype=dtype,
                                                device=device))


def _sweep_seed(gen):
    """One int64 Philox sweep seed from the side's generator, on its
    device, as the engines draw theirs."""
    return torch.randint(0, 2 ** 62, (), generator=gen, dtype=torch.int64,
                         device=gen.device)


def _label_sweep(spec, backend, n):
    """sweep(seed, params, log_pi, data) -> the FusedEStep of one fused
    label sweep: B2 on kernel_xts(data) for 'cuda' (the plain twin when
    the data lies on the CPU, as every kernel wrapper does), the
    blockwise twin in one block for 'plain'."""
    if backend == 'cuda':
        from mimo_tpu_torch.ops.cuda_estep import kernel_xts
        from mimo_tpu_torch.ops.cuda_gibbs import fused_gibbs_cuda
        from mimo_tpu_torch.utils.tree import cast_floats

        def sweep(seed, params, log_pi, data):
            # B2 runs in float32; its statistics come back in the data's
            # dtype, as the engines cast them
            return cast_floats(fused_gibbs_cuda(spec, seed, params, log_pi,
                                                kernel_xts(data), n)[1],
                               data[0].dtype)
    else:
        from mimo_tpu_torch.ops.family_estep import fused_gibbs_blockwise

        def sweep(seed, params, log_pi, data):
            return fused_gibbs_blockwise(spec, seed, params, log_pi, data,
                                         n)[1]
    return sweep


def build_mixture_config(args, dtype, device):
    """Config of every flat-mixture family: a dict of the model and its
    init / generate / transition / stats_of."""
    from mimo_tpu_torch.utils.linalg import logdet_psd

    n, kk, d = args.n, args.k, args.dim
    fam = args.family
    # moderately tight priors so prior-drawn data is non-degenerate (a
    # diffuse NIW makes both sides produce huge-variance data and the
    # test loses power, not validity)
    if fam in ('gmm', 'tied', 'hier'):
        from mimo_tpu_torch.models.gmm import BayesianGMM
        model = BayesianGMM.make(
            size=kk, dim=d, gating='stick-breaking', alpha=1.5, kappa=2.0,
            psi_scale=1.0, nu=float(d + 3), tied=(fam == 'tied'),
            hierarchical=(fam == 'hier'), dtype=dtype, device=device)
        data_dims = (d,)

        def generate(gen, params, pi):
            x, _ = BayesianGMM.generate(gen, params, pi, n)
            return (x,)

        def stats_of(params, pi, data):
            (x,) = data
            lam = params.lmbda
            per_k = [params.mu[:, 0], pi]
            names = [f'mu{j}_x0' for j in range(kk)] \
                + [f'pi{j}' for j in range(kk)]
            if fam == 'gmm':
                per_k += [logdet_psd(lam),
                          torch.diagonal(lam, dim1=-2, dim2=-1).sum(-1)]
                names += [f'logdetL{j}' for j in range(kk)] \
                    + [f'trL{j}' for j in range(kk)]
            else:
                # shared scale: one logdet/trace; for hier also the
                # spread of the means (sensitive to the tau/hyper draw)
                per_k += [logdet_psd(lam[:1]),
                          torch.diagonal(lam[:1], dim1=-2, dim2=-1).sum(-1)]
                names += ['logdetL', 'trL']
                if fam == 'hier':
                    mu0 = params.mu[:, 0]
                    per_k += [torch.mean(mu0)[None],
                              torch.asinh(torch.var(mu0,
                                                    unbiased=False))[None]]
                    names += ['mean_mu', 'asinh_var_mu']
            vec = torch.cat(per_k + [_arcsinh_moments([
                torch.mean(x[:, 0]), torch.var(x[:, 0], unbiased=False),
                torch.mean(torch.sum(x * x, -1))])])
            return vec, names + GMM_MOMENTS
    elif fam in ('diag', 'tied-diag'):
        from mimo_tpu_torch.distributions.niw import GaussParams
        from mimo_tpu_torch.models.gmm import BayesianGMM
        model = BayesianGMM.make(
            size=kk, dim=d, gating='stick-breaking', alpha=1.5, kappa=2.0,
            diag=True, tied=(fam == 'tied-diag'), dtype=dtype,
            device=device)
        # tighter Gamma prior than the standard (alpha=2, beta=1): keeps
        # prior-predictive tails from dominating the data moments
        model.components_prior = model.components_prior._replace(
            alpha=torch.full((kk, d), 3.0, dtype=dtype, device=device),
            beta=torch.full((kk, d), 1.0, dtype=dtype, device=device))
        data_dims = (d,)

        def generate(gen, params, pi):
            full = GaussParams(mu=params.mu,
                               lmbda=torch.diag_embed(params.lmbda_diag))
            x, _ = BayesianGMM.generate(gen, full, pi, n)
            return (x,)

        def stats_of(params, pi, data):
            (x,) = data
            per_k = [params.mu[:, 0], pi]
            names = [f'mu{j}_x0' for j in range(kk)] \
                + [f'pi{j}' for j in range(kk)]
            if fam == 'diag':
                per_k += [torch.sum(torch.log(params.lmbda_diag), -1)]
                names += [f'sumlogL{j}' for j in range(kk)]
            else:
                per_k += [torch.sum(torch.log(params.lmbda_diag[:1]), -1)]
                names += ['sumlogL']
            vec = torch.cat(per_k + [_arcsinh_moments([
                torch.mean(x[:, 0]), torch.var(x[:, 0], unbiased=False),
                torch.mean(torch.sum(x * x, -1))])])
            return vec, names + GMM_MOMENTS
    elif fam in ('ilr', 'tied-affine'):
        from mimo_tpu_torch.models.ilr import BayesianILR
        model = BayesianILR.make(
            size=kk, input_dim=d, output_dim=1, gating='stick-breaking',
            alpha=1.5, kappa=2.0, K_scale=1.0, psi_scale=1.0,
            basis_psi_scale=1.0, tied_affine=(fam == 'tied-affine'),
            dtype=dtype, device=device)
        data_dims = (d, 1)

        def generate(gen, params, pi):
            bp, ep = params
            x, y, _ = BayesianILR.generate(gen, bp, ep, pi, n,
                                           affine=model.affine)
            return (x, y)

        def stats_of(params, pi, data):
            x, y = data
            bp, ep = params
            per_k = [bp.mu[:, 0], logdet_psd(bp.lmbda), pi]
            names = ([f'bmu{j}' for j in range(kk)]
                     + [f'blogdet{j}' for j in range(kk)]
                     + [f'pi{j}' for j in range(kk)])
            if fam == 'ilr':
                per_k += [ep.A[:, 0, 0], ep.A[:, 0, -1],
                          torch.log(ep.lmbda[:, 0, 0])]
                names += ([f'A{j}' for j in range(kk)]
                          + [f'c{j}' for j in range(kk)]
                          + [f'loglam{j}' for j in range(kk)])
            else:
                # shared slope + shared noise: one stat each; offsets per k
                per_k += [ep.A[:1, 0, 0], ep.A[:, 0, -1],
                          torch.log(ep.lmbda[:1, 0, 0])]
                names += (['A_shared'] + [f'c{j}' for j in range(kk)]
                          + ['loglam'])
            vec = torch.cat(per_k + [_arcsinh_moments([
                torch.mean(x[:, 0]), torch.var(x[:, 0], unbiased=False),
                torch.mean(y[:, 0]), torch.var(y[:, 0], unbiased=False),
                torch.mean(x[:, 0] * y[:, 0])])])
            return vec, names + ILR_MOMENTS
    else:
        raise ValueError(fam)

    sweep = _label_sweep(model._estep_spec(), args.backend, n)

    def init(gen):
        """A prior draw of (params, pi)."""
        fam_ = model.family
        if fam_.gibbs_update is None:
            params = fam_.sample_params(gen, model.components_prior)
        else:
            _, params = fam_.gibbs_update(
                gen, model.components_prior,
                _zero_stats(fam_, data_dims, kk, dtype, device))
        return params, model.gating_prior.sample(gen)

    def transition(gen, params, pi, data):
        """ONE production Gibbs sweep, the body of fit_gibbs_fused's loop
        (models/mixture.py): fused label sweep -> conjugate update ->
        parameter draws (or the family's exact gibbs_update) -> gating
        update and its draw."""
        fam_ = model.family
        res = sweep(_sweep_seed(gen), params, _log_clip(pi), data)
        if fam_.gibbs_update is None:
            comps = fam_.update(model.components_prior, res.stats)
            params = fam_.sample_params(gen, comps)
        else:
            _, params = fam_.gibbs_update(gen, model.components_prior,
                                          res.stats)
        pi = model.gating_prior.update(res.counts).sample(gen)
        return params, pi

    return {'model': model, 'init': init, 'generate': generate,
            'transition': transition, 'stats_of': stats_of}


def build_nested_config(args, dtype, device):
    """The two-level nested Gibbs sweep of hmix.fit_gibbs_fused: the
    joint flat (z, c) label draw over all M*K experts, then the vmapped
    per-cluster exact hierarchical gibbs_update and both gating levels."""
    from mimo_tpu_torch.models.hmix import BayesianMixtureOfMixtures
    from mimo_tpu_torch.utils.linalg import cholesky, inv_psd, logdet_psd

    n, d = args.n, args.dim
    mm, kk = args.m, args.k
    model = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=mm, mixture_size=kk, dim=d, alpha=1.5,
        inner_alpha=1.5, hierarchical=True, kappa=2.0, psi_scale=1.0,
        dtype=dtype, device=device)
    sweep = _label_sweep(model._flat_spec(), args.backend, n)

    def gibbs_update(gen, stats):
        return vmap(lambda p, s: model.family.gibbs_update(gen, p, s),
                    randomness='different')(model.components_prior, stats)

    def init(gen):
        zs = _zero_stats(model.family, (d,), kk, dtype, device)
        zs_m = type(zs)(*(a.expand((mm,) + a.shape) for a in zs))
        _, params = gibbs_update(gen, zs_m)
        pi_o = model.outer_gating_prior.sample(gen)
        pi_i = vmap(lambda g: g.sample(gen), randomness='different')(
            model.inner_gating_prior)
        return params, (pi_o, pi_i)

    def generate(gen, params, pis):
        pi_o, pi_i = pis
        log_flat = (_log_clip(pi_o)[:, None] + _log_clip(pi_i)).reshape(-1)
        flat = torch.multinomial(torch.softmax(log_flat, -1), n,
                                 replacement=True, generator=gen)
        mu = params.mu.reshape(mm * kk, d)
        chol = cholesky(inv_psd(params.lmbda.reshape(mm * kk, d, d)))
        z = torch.randn((n, d), generator=gen, dtype=dtype, device=device)
        x = mu[flat] + torch.einsum('nde,ne->nd', chol[flat], z)
        return (x,)

    def transition(gen, params, pis, data):
        pi_o, pi_i = pis
        log_pi = (_log_clip(pi_o)[:, None] + _log_clip(pi_i)).reshape(-1)
        # the flat spec flattens the (M, K) axes itself (hmix._flat_spec)
        res = sweep(_sweep_seed(gen), params, log_pi, data)
        counts, stats = model._split_flat(res)
        _, params = gibbs_update(gen, stats)
        pi_o = model.outer_gating_prior.update(
            torch.sum(counts, -1)).sample(gen)
        pi_i = vmap(lambda g, c: g.update(c).sample(gen),
                    randomness='different')(model.inner_gating_prior, counts)
        return params, (pi_o, pi_i)

    def stats_of(params, pis, data):
        (x,) = data
        pi_o, pi_i = pis
        mu = params.mu.reshape(mm * kk, d)
        vec = torch.cat([
            mu[:, 0],                                   # M*K
            logdet_psd(params.lmbda[:, 0]),             # M: shared per cluster
            pi_o,                                       # M
            pi_i.reshape(-1),                           # M*K
            _arcsinh_moments([torch.mean(x[:, 0]),
                              torch.var(x[:, 0], unbiased=False),
                              torch.mean(torch.sum(x * x, -1))]),
        ])
        names = ([f'mu{j}' for j in range(mm * kk)]
                 + [f'logdetL{j}' for j in range(mm)]
                 + [f'piO{j}' for j in range(mm)]
                 + [f'piI{j}' for j in range(mm * kk)]
                 + GMM_MOMENTS)
        return vec, names

    return {'model': model, 'init': init, 'generate': generate,
            'transition': transition, 'stats_of': stats_of}


def build_config(args, dtype, device):
    if args.family == 'nested':
        return build_nested_config(args, dtype, device)
    return build_mixture_config(args, dtype, device)


def prior_side(cfg, gen, draws):
    """(a) iid prior draws: init -> generate -> stats_of. Returns ((draws,
    S) on the device, read back once by the caller; the S names)."""
    init, generate, stats_of = cfg['init'], cfg['generate'], cfg['stats_of']
    out = []
    for _ in range(draws):
        params, pi = init(gen)
        vec, names = stats_of(params, pi, generate(gen, params, pi))
        out.append(vec)
    return torch.stack(out), names


def successive_side(cfg, gen, draws, burn, thin):
    """(b) the successive-conditional chain from a prior draw: generate,
    then `thin` transitions with fresh data between them, then stats_of;
    the first `burn` rows dropped. (draws, S) on the device."""
    generate, transition = cfg['generate'], cfg['transition']
    params, pi = cfg['init'](gen)
    out = []
    for t in range(burn + draws):
        data = generate(gen, params, pi)
        for i in range(thin):
            params, pi = transition(gen, params, pi, data)
            if i + 1 < thin:     # fresh data between thinned sweeps
                data = generate(gen, params, pi)
        if t >= burn:
            out.append(cfg['stats_of'](params, pi, data)[0])
    return torch.stack(out)


def batch_means_se(a, nb=50):
    m = len(a) // nb
    bm = a[:nb * m].reshape(nb, m).mean(axis=1)
    return bm.std(ddof=1) / np.sqrt(nb)


def summarize(prior_stats, succ_stats, names, out=print):
    """Drop the non-finite rows of each side (loudly; under 1% each or
    ValueError), then one z a statistic. Returns (max |z|, per-statistic
    records, dropped prior rows, dropped successive rows)."""
    prior_stats = np.asarray(prior_stats, np.float64)
    succ_stats = np.asarray(succ_stats, np.float64)
    bad_p = ~np.isfinite(prior_stats).all(axis=1)
    bad_s = ~np.isfinite(succ_stats).all(axis=1)
    if bad_p.any() or bad_s.any():
        runs, in_run = [], False
        for i, b in enumerate(bad_s):
            if b and not in_run:
                runs.append([i, i])
                in_run = True
            elif b:
                runs[-1][1] = i
            else:
                in_run = False
        out(f'WARNING: dropped non-finite draws: prior '
            f'{int(bad_p.sum())}/{len(bad_p)}, successive '
            f'{int(bad_s.sum())}/{len(bad_s)} in {len(runs)} run(s) '
            f'{runs[:5]}')
    if not (bad_p.mean() < 0.01 and bad_s.mean() < 0.01):
        raise ValueError('too many non-finite draws: investigate before '
                         'trusting z')
    prior_stats = prior_stats[~bad_p]
    succ_stats = succ_stats[~bad_s]
    recs = []
    for j, name in enumerate(names):
        pa, sb = prior_stats[:, j], succ_stats[:, j]
        se_a = pa.std(ddof=1) / np.sqrt(len(pa))
        se_b = batch_means_se(sb)
        z = (pa.mean() - sb.mean()) / np.sqrt(se_a ** 2 + se_b ** 2)
        recs.append({'stat': name, 'prior_mean': float(pa.mean()),
                     'succ_mean': float(sb.mean()), 'z': float(z)})
        out(f'{name:<10} prior {pa.mean():+10.4f} succ {sb.mean():+10.4f}'
            f'  z {z:+6.2f}')
    mx = max(abs(r['z']) for r in recs)
    return mx, recs, int(bad_p.sum()), int(bad_s.sum())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--backend', default='plain', choices=['plain', 'cuda'],
                    help='cuda = kernel B2 on the card (float32; raises '
                         'without one); plain = the blockwise twin on the '
                         'CPU (float64 unless --f32)')
    ap.add_argument('--family', default='gmm', choices=FAMILIES)
    ap.add_argument('--draws', type=int, default=20000)
    ap.add_argument('--thin', type=int, default=2,
                    help='transitions per collected draw')
    ap.add_argument('--burn', type=int, default=500)
    ap.add_argument('--n', type=int, default=512)
    ap.add_argument('--k', type=int, default=3)
    ap.add_argument('--m', type=int, default=2,
                    help='outer clusters (nested family only)')
    ap.add_argument('--dim', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--f64', action='store_true',
                    help='float64 on the cuda backend too (default on for '
                         'the plain backend)')
    ap.add_argument('--assert-below', type=float, default=None,
                    help='exit 1 if max|z| reaches this (a regression '
                         'gate; ~4.5 at 4k draws, ~3.5 at 20k)')
    return ap.parse_args(argv)


def run(args, out=print):
    """Both sides and the summary for the parsed `args`. Returns (max |z|,
    per-statistic records, the result record of the final JSON line)."""
    if args.backend == 'cuda':
        from mimo_tpu_torch.models.mixture import model_device
        device = model_device(None)      # raises without a card
    else:
        device = torch.device('cpu')
    dtype = torch.float64 if (args.backend == 'plain' or args.f64) \
        else torch.float32
    cfg = build_config(args, dtype, device)

    g_prior = torch.Generator(device=device).manual_seed(2 * args.seed)
    g_succ = torch.Generator(device=device).manual_seed(2 * args.seed + 1)
    prior, names = prior_side(cfg, g_prior, args.draws)
    succ = successive_side(cfg, g_succ, args.draws, args.burn, args.thin)
    mx, recs, bad_p, bad_s = summarize(prior.cpu().double().numpy(),
                                       succ.cpu().double().numpy(), names,
                                       out)
    result = {'backend': args.backend, 'family': args.family,
              'draws': args.draws, 'dropped_prior': bad_p,
              'dropped_succ': bad_s, 'thin': args.thin, 'max_abs_z': mx,
              'n': args.n, 'k': args.k, 'd': args.dim,
              'dtype': str(dtype).replace('torch.', '')}
    return mx, recs, result


def main(argv=None):
    args = parse_args(argv)
    mx, recs, result = run(args, out=lambda s: print(s, flush=True))
    print(json.dumps(result))
    if args.assert_below is not None and mx >= args.assert_below:
        print(f'FAIL: max|z| {mx:.2f} >= {args.assert_below}')
        sys.exit(1)
    return mx, recs


if __name__ == '__main__':
    main()
