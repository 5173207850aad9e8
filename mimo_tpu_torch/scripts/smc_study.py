"""SMC value study (port of the JAX repository's scripts/smc_study.py):
when does smc_gibbs beat independent restarts?

`fit_chains` runs C independent Gibbs chains as one batched program;
`smc_gibbs` adds systematic resampling of chain states by data
log-likelihood. Resampling costs nothing extra but kills diversity, so it
pays only when independent chains get STUCK in bad modes. The toy is
built to have sticky bad modes: 4 well-separated clusters with unequal
weights, fit with exactly 4 components, where a chain that merges two
clusters and splits another stays there for hundreds of sweeps.

Protocol (equal sweep budgets): C chains x R rounds x S sweeps.
  independent: fit_chains(fit_gibbs, maxiter=R*S)
  smc:         smc_gibbs(n_rounds=R, sweeps_per_round=S)
Each chain is scored by HELD-OUT log predictive density through the
serving surface (MFState(components, gating) -> log_predictive: kernel
B3 on the card, once a chain).

Prints per arm the best, mean and worst chain and the fraction of
chains within 1 nat/point of the best (the chains resampling rescues).

    python -m mimo_tpu_torch.scripts.smc_study [--seeds 5] [--cpu]
"""

import argparse
import json

import numpy as np
import torch

from mimo_tpu_torch.distributions.niw import GaussParams
from mimo_tpu_torch.models.gmm import BayesianGMM
from mimo_tpu_torch.models.mixture import MFState, model_device
from mimo_tpu_torch.parallel.chains import fit_chains, smc_gibbs
from mimo_tpu_torch.utils.tree import tree_map


def make_data(gen, n, dtype=torch.float64):
    """4 tight, well-separated, unequal-weight clusters on the generator's
    device: sticky bad modes for a K=4 fit (merging the two heavy
    clusters is near-irreversible for single-site label Gibbs)."""
    dev = gen.device
    mus = torch.tensor([[-6., -6.], [-6., 6.], [6., -6.], [6., 6.]],
                       dtype=dtype, device=dev)
    lm = (torch.eye(2, dtype=dtype, device=dev) / 0.4).expand(4, 2, 2)
    x, _ = BayesianGMM.generate(gen, GaussParams(mus, lm),
                                [0.4, 0.3, 0.2, 0.1], n)
    return x


def score_chains(model, states, x_test):
    """Held-out mean log predictive of each chain (C,) as a numpy array:
    every chain's GibbsState is served through the standard surface
    (predict-after-resample), one log_predictive a chain."""
    c = states.labels.shape[0]
    out = [torch.mean(model.log_predictive(
        MFState(components=tree_map(lambda a: a[i], states.components),
                gating=tree_map(lambda a: a[i], states.gating)), x_test))
        for i in range(c)]
    return torch.stack(out).double().cpu().numpy()


def summ(s):
    best = s.max()
    return {'best': float(best), 'mean': float(s.mean()),
            'worst': float(s.min()),
            'frac_good': float(np.mean(s > best - 1.0))}


def run_seed(seed, chains, rounds, sweeps, n, device, dtype):
    """One seed of the study: (independent scores (C,), smc scores (C,))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = make_data(gen, n, dtype)
    x_test = make_data(gen, 500, dtype)
    keys = torch.randint(0, 2 ** 62, (chains + 1,), generator=gen,
                         dtype=torch.int64, device=device).tolist()
    m = BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=dtype,
                         device=device)
    ind = fit_chains(m, 'fit_gibbs', x, keys[:chains],
                     maxiter=rounds * sweeps)
    s_ind = score_chains(m, ind, x_test)
    smc, _ = smc_gibbs(m, x, keys[chains], n_chains=chains, n_rounds=rounds,
                       sweeps_per_round=sweeps)
    return s_ind, score_chains(m, smc, x_test)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seeds', type=int, default=5)
    ap.add_argument('--chains', type=int, default=16)
    ap.add_argument('--rounds', type=int, default=10)
    ap.add_argument('--sweeps', type=int, default=10)
    ap.add_argument('--n', type=int, default=2000)
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU in float64 (default: the card, '
                         'float32; raises without one)')
    args = ap.parse_args(argv)
    device = model_device('cpu' if args.cpu else None)
    dtype = torch.float64 if args.cpu else torch.float32

    rows = []
    for seed in range(args.seeds):
        s_ind, s_smc = run_seed(seed, args.chains, args.rounds, args.sweeps,
                                args.n, device, dtype)
        row = {'seed': seed, 'independent': summ(s_ind), 'smc': summ(s_smc)}
        rows.append(row)
        print(f"seed {seed}: ind best {row['independent']['best']:+.3f} "
              f"mean {row['independent']['mean']:+.3f} "
              f"worst {row['independent']['worst']:+.3f} "
              f"frac_good {row['independent']['frac_good']:.2f} | "
              f"smc best {row['smc']['best']:+.3f} "
              f"mean {row['smc']['mean']:+.3f} "
              f"worst {row['smc']['worst']:+.3f} "
              f"frac_good {row['smc']['frac_good']:.2f}", flush=True)

    agg = {arm: {k: float(np.mean([r[arm][k] for r in rows]))
                 for k in ('best', 'mean', 'worst', 'frac_good')}
           for arm in ('independent', 'smc')}
    print(json.dumps({'seeds': args.seeds, 'chains': args.chains,
                      'budget_sweeps': args.rounds * args.sweeps,
                      'device': str(device), 'aggregate': agg}))
    return rows, agg


if __name__ == '__main__':
    main()
