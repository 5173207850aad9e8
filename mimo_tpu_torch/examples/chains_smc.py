"""Chain parallelism (the counterpart of examples/chains_smc.py): VI
restarts over a set of chain keys with best-of selection, split-R-hat and
ESS over a batch of Gibbs chains' log-likelihood traces, and SMC-style
population Gibbs with systematic resampling. The dense VI restarts, the
Gibbs chains and the SMC population each run as one batched program.

    python -m mimo_tpu_torch.examples.chains_smc [--cpu] [--chains C]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import chain_keys, generator, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('parallel chains + SMC', argv,
                      chains=(int, 8, 'chain count'))
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.models.gmm import BayesianGMM
    from mimo_tpu_torch.parallel.chains import best_of, fit_chains, smc_gibbs
    from mimo_tpu_torch.parallel.diagnostics import diagnostics

    dt = args.dtype
    true_mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]], dtype=dt,
                           device=dev)
    true_lm = torch.eye(2, dtype=dt, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(generator(args, dev),
                                GaussParams(true_mu, true_lm), [.3, .4, .3],
                                10000)

    model = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                             psi_scale=0.5, dtype=dt, device=dev)
    keys = chain_keys(args.seed, args.chains)
    states, vlbs = fit_chains(model, 'fit_vi', x, keys, maxiter=100)
    finals = to_numpy(vlbs[:, -1])
    print(f'{args.chains} vmapped VI chains, final ELBOs: '
          f'{finals.round(1)}')
    _, idx = best_of(states, vlbs)
    print(f'best chain {int(idx)}: {finals[int(idx)]:.1f}')

    # convergence diagnostics over a Gibbs trace stack
    _, lls = fit_chains(model, 'fit_gibbs', x, keys, maxiter=150,
                        track_loglik=True)
    d = diagnostics(to_numpy(lls)[:, 50:])          # post-burn-in
    print(f"Gibbs loglik diagnostics over {args.chains} chains: "
          f"split-R-hat {d['rhat']:.3f} (rank {d['rhat_rank']:.3f}), "
          f"ESS {d['ess']:.0f} of {d['n']}")

    _, smc_lls = smc_gibbs(model, x, key=args.seed, n_chains=args.chains,
                           n_rounds=8, sweeps_per_round=10)
    smc_lls = to_numpy(smc_lls)
    print('SMC population mean loglik per round:', smc_lls.round(1))
    return {'vi_elbos': finals, 'best_chain': int(idx),
            'rhat': float(d['rhat']), 'rhat_rank': float(d['rhat_rank']),
            'ess': float(d['ess']), 'smc_loglik': smc_lls}


if __name__ == '__main__':
    main()
