"""DP-GMM: a truncated stick-breaking mixture of Gaussians fitted by
blocked Gibbs, then by VI warm-started from the Gibbs state (the
counterpart of examples/dpgmm.py): full covariances, or diagonal with
--diag, or tied with --tied.

    python -m mimo_tpu_torch.examples.dpgmm [--cpu] [--nb_models K]
        [--alpha A] [--diag] [--tied] [--n N] [--plot]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import generator, maybe_save_plot, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('DP-GMM (stick-breaking)', argv,
                      nb_models=(int, 25, 'truncation level'),
                      alpha=(float, 1.0, 'DP concentration'),
                      diag=(bool, False, 'diagonal covariances'),
                      tied=(bool, False, 'tied covariances'),
                      n=(int, 20000, 'data size'))
    from mimo_tpu_torch.distributions.gating import StickBreaking
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.models.gmm import BayesianGMM
    from mimo_tpu_torch.models.mixture import MFState

    dt, gen = args.dtype, generator(args, dev)
    # stick-breaking prior draws
    sb = StickBreaking.standard(args.nb_models, args.alpha, dt, dev)
    draws = StickBreaking(*(t.expand(3, args.nb_models).contiguous()
                            for t in sb)).sample(gen)
    print('three stick-breaking prior draws (first 6 weights):')
    print(to_numpy(draws[:, :6]).round(3))

    true_mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.], [0., -4.]],
                           dtype=dt, device=dev)
    true_lm = torch.eye(2, dtype=dt, device=dev).expand(4, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(gen, GaussParams(true_mu, true_lm),
                                [.25, .3, .25, .2], args.n)

    model = BayesianGMM.make(size=args.nb_models, dim=2, gating='dp',
                             alpha=args.alpha, diag=args.diag,
                             tied=args.tied, kappa=0.05, psi_scale=0.5,
                             dtype=dt, device=dev)
    gs = model.fit_gibbs(x, key=args.seed, maxiter=200)
    counts = np.bincount(to_numpy(gs.labels), minlength=args.nb_models)
    print('Gibbs occupancy (sorted):', np.sort(counts)[::-1][:8])

    state, vlb = model.fit_vi(x, key=args.seed + 1, maxiter=200,
                              init_state=MFState(gs.components, gs.gating),
                              randomize=False)
    used = to_numpy(model.used_labels(state, x))
    means = to_numpy(state.components.mu)[used]
    print(f'VI ELBO {float(vlb[-1]):.1f}; {used.sum()} components used')
    print('means:\n', means.round(2))

    if args.plot and not args.diag:
        from mimo_tpu_torch.distributions import niw
        from mimo_tpu_torch.utils.plot import plot_mixture
        resp = model.expected_responsibilities(state, (x,))
        plot_mixture(x[:3000], niw.mode_params(state.components),
                     state.gating.mean(),
                     labels=torch.argmax(resp[:3000], -1))
        maybe_save_plot(args, 'dpgmm')
    return {'gibbs_occupancy': np.sort(counts)[::-1],
            'elbo': float(vlb[-1]), 'used': int(used.sum()),
            'means': means, 'true_means': to_numpy(true_mu)}


if __name__ == '__main__':
    main()
