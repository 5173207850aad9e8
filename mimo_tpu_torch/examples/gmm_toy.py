"""Fixed-K GMM on a 2-D toy: maximum-likelihood EM, VI with best-of-N
restarts as one batch of chains, and MAP-EM (the counterpart of
examples/gmm_toy.py).

    python -m mimo_tpu_torch.examples.gmm_toy [--cpu] [--nb_models K]
        [--restarts R] [--plot]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import (
    chain_keys, generator, maybe_save_plot, setup)
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('fixed-K GMM toy', argv,
                      nb_models=(int, 5, 'truncation K'),
                      restarts=(int, 5, 'parallel restarts'))
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.models.gmm import GMM, BayesianGMM
    from mimo_tpu_torch.parallel.chains import best_of, fit_chains

    dt = args.dtype
    true_mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]], dtype=dt,
                           device=dev)
    true_lm = torch.eye(2, dtype=dt, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(generator(args, dev),
                                GaussParams(true_mu, true_lm), [.3, .4, .3],
                                3000)

    # ML EM
    em_state, ll = GMM(3, 2).fit_em(x, key=args.seed, maxiter=150)
    print(f'EM final loglik {float(ll[-1]):.1f}; means:\n',
          to_numpy(em_state.params.mu))

    # Bayesian VI with best-of-N restarts
    model = BayesianGMM.make(size=args.nb_models, dim=2, gating='dirichlet',
                             alpha=1.0, kappa=0.05, psi_scale=0.5, dtype=dt,
                             device=dev)
    states, vlbs = fit_chains(model, 'fit_vi', x,
                              chain_keys(args.seed, args.restarts),
                              maxiter=150)
    state, idx = best_of(states, vlbs)
    print(f'VI best-of-{args.restarts} ELBO {float(vlbs[idx, -1]):.1f} '
          f'(chain {int(idx)})')
    used = to_numpy(model.used_labels(state, x))
    means = to_numpy(state.components.mu)[used]
    print('recovered means:\n', means)

    # MAP EM
    _, trace = model.fit_map(x, key=args.seed, maxiter=100)
    print(f'MAP final complete-loglik {float(trace[-1]):.1f}')

    if args.plot:
        from mimo_tpu_torch.distributions import niw
        from mimo_tpu_torch.utils.plot import plot_mixture
        resp = model.expected_responsibilities(state, (x,))
        plot_mixture(x, niw.mode_params(state.components),
                     state.gating.mean(), labels=torch.argmax(resp, -1))
        maybe_save_plot(args, 'gmm_toy')
    return {'em_loglik': float(ll[-1]),
            'em_means': to_numpy(em_state.params.mu),
            'vi_elbo': float(vlbs[idx, -1]), 'vi_means': means,
            'map_loglik': float(trace[-1]), 'true_means': to_numpy(true_mu)}


if __name__ == '__main__':
    main()
