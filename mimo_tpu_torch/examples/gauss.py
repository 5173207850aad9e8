"""Single Gaussian with a Normal-Inverse-Wishart prior: the conjugate
posterior, its mode, a posterior draw, the Student-t predictive and the
log marginal likelihood (the counterpart of examples/gauss.py).

    python -m mimo_tpu_torch.examples.gauss [--cpu] [--x64] [--seed S]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import generator, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('Single Gaussian | NIW', argv)
    from mimo_tpu_torch.distributions import niw
    from mimo_tpu_torch.distributions.niw import NIW

    rng = np.random.default_rng(args.seed)
    true_mu = np.array([1.0, -2.0])
    true_cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    x = torch.as_tensor(rng.multivariate_normal(true_mu, true_cov, 5000),
                        dtype=args.dtype, device=dev)

    prior = NIW.standard(1, 2, kappa=1e-2, psi_scale=1.0, dtype=args.dtype,
                         device=dev)
    stats = niw.suff_stats(x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                         device=dev))
    post = niw.posterior_update(prior, stats)

    post_mu = to_numpy(post.mu[0])
    print('posterior mean  ', post_mu, ' true', true_mu)
    map_cov = np.linalg.inv(to_numpy(niw.mode_params(post).lmbda[0]))
    print('MAP covariance  \n', map_cov)
    print('true covariance \n', true_cov)

    # a posterior draw and the predictive density
    params = niw.sample_params(generator(args, dev), post)
    lp = to_numpy(niw.log_predictive_studentt(post, x[:5])[:, 0])
    print('posterior draw mu', to_numpy(params.mu[0]))
    print('predictive logpdf of 5 points', lp)

    lml = float(niw.log_marginal_likelihood(prior, post, x.shape[0])[0])
    print('log marginal likelihood', lml)
    return {'posterior_mean': post_mu, 'map_cov': map_cov,
            'draw_mu': to_numpy(params.mu[0]), 'logpdf': lp,
            'log_marginal_likelihood': lml}


if __name__ == '__main__':
    main()
