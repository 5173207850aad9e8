"""Hierarchical mixtures (the counterpart of examples/hgmm.py): (a) a
flat GMM with a shared Normal-Wishart hyper-prior and tied precision,
Gibbs then warm VI; (b) a two-level mixture of GMMs on two
super-clusters, nested VI.

    python -m mimo_tpu_torch.examples.hgmm [--cpu] [--nb_models K]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import generator, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('hierarchical GMMs', argv,
                      nb_models=(int, 8, 'components / inner mixtures'))
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.models.gmm import BayesianGMM
    from mimo_tpu_torch.models.hmix import BayesianMixtureOfMixtures
    from mimo_tpu_torch.models.mixture import MFState

    dt = args.dtype
    true_mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]], dtype=dt,
                           device=dev)
    true_lm = torch.eye(2, dtype=dt, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(generator(args, dev),
                                GaussParams(true_mu, true_lm), [.3, .4, .3],
                                5000)

    # (a) flat hierarchical GMM: Gibbs then warm VI
    model = BayesianGMM.make(size=args.nb_models, dim=2, gating='dp',
                             hierarchical=True, kappa=0.05, psi_scale=0.5,
                             dtype=dt, device=dev)
    gs = model.fit_gibbs(x, key=args.seed, maxiter=100)
    counts = np.bincount(to_numpy(gs.labels), minlength=args.nb_models)
    print('hier-GMM Gibbs occupancy:', np.sort(counts)[::-1][:5])
    st, vlb = model.fit_vi(x, key=args.seed + 1, maxiter=100,
                           init_state=MFState(gs.components, gs.gating),
                           randomize=False)
    used = to_numpy(model.used_labels(st, x))
    means = to_numpy(st.components.mus)[used]
    print(f'hier-GMM VI ELBO {float(vlb[-1]):.1f}; means:\n', means.round(2))

    # (b) two-level mixture of GMMs on two super-clusters
    rng = np.random.default_rng(args.seed)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x2 = np.vstack([blob([-5, -5], 800), blob([-5, -3], 800),
                    blob([5, 5], 800), blob([5, 3], 800)])
    x2 = torch.as_tensor(x2[rng.permutation(len(x2))], dtype=dt, device=dev)
    mm = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=True,
        kappa=0.5, psi_scale=0.5, maxsubiter=5, means=[[-5, -4], [5, 4]],
        dtype=dt, device=dev)
    st2, _ = mm.fit_vi(x2, key=args.seed, maxiter=50, maxsubiter=3)
    resp = mm.expected_responsibilities(st2, (x2,))
    lab = to_numpy(torch.argmax(resp, -1))
    left = to_numpy(x2)[:, 0] < 0
    left_labels = np.bincount(lab[left], minlength=2)
    right_labels = np.bincount(lab[~left], minlength=2)
    print('mixture-of-GMMs: left-cluster labels', left_labels,
          '| right-cluster labels', right_labels)
    return {'gibbs_occupancy': np.sort(counts)[::-1],
            'elbo': float(vlb[-1]), 'means': means,
            'true_means': to_numpy(true_mu), 'left_labels': left_labels,
            'right_labels': right_labels}


if __name__ == '__main__':
    main()
