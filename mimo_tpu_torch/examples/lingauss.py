"""Single linear-Gaussian regression with conjugate priors: Matrix-Normal-
Wishart (affine through a ones column), its diagonal-noise variant
(Matrix-Normal-Gamma) and tied-affine experts with an explicit offset
prior (the counterpart of examples/lingauss.py).

    python -m mimo_tpu_torch.examples.lingauss [--cpu] [--x64] [--seed S]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('linear Gaussian | MNW', argv)
    from mimo_tpu_torch.distributions import affine, mng, mnw
    from mimo_tpu_torch.distributions.affine import TiedAffine
    from mimo_tpu_torch.distributions.mng import MNG
    from mimo_tpu_torch.distributions.mnw import MNW, augment

    rng = np.random.default_rng(args.seed)
    n, q, p = 2000, 3, 2
    true_A = rng.standard_normal((p, q))
    true_c = np.array([0.5, -1.0])
    x_np = rng.standard_normal((n, q))
    # JAX's driver rounds x to its float dtype before forming y
    x = torch.as_tensor(x_np, dtype=args.dtype, device=dev)
    y = torch.as_tensor(to_numpy(x).astype(np.float64) @ true_A.T + true_c
                        + 0.1 * rng.standard_normal((n, p)),
                        dtype=args.dtype, device=dev)
    ones = torch.ones((n, 1), dtype=x.dtype, device=dev)
    kw = dict(dtype=x.dtype, device=dev)

    # plain MNW (affine via the ones column)
    prior = MNW.standard(1, p, q + 1, K_scale=1e-2, **kw)
    xa = augment(x, True)
    stats = mnw.suff_stats(xa, y, ones)
    post = mnw.posterior_update(prior, stats)
    est = to_numpy(post.M[0])
    slope_err = np.abs(est[:, :q] - true_A).max()
    offset_err = np.abs(est[:, q] - true_c).max()
    print('MNW slope error ', slope_err.round(5),
          '| offset error ', offset_err.round(5))
    lp = to_numpy(mnw.log_predictive_studentt(post, xa[:3], y[:3])[:, 0])
    print('predictive logpdf of 3 points', lp.round(2))

    # diagonal noise (MNG)
    prior_d = MNG.standard(1, p, q + 1, K_scale=1e-2, **kw)
    post_d = mng.posterior_update(prior_d, stats)
    noise_prec = to_numpy(post_d.alpha[0] / post_d.beta[0])
    print('MNG noise precisions ', noise_prec.round(2), '(true 100)')

    # tied-affine: explicit offset prior, shared slope
    prior_a = TiedAffine.standard(1, p, q, K_scale=1e-2, kappa=1e-2, **kw)
    stats_a = affine.suff_stats(x, y, ones)
    post_a = affine.posterior_update(prior_a, stats_a, nb_iter=25)
    tied_slope_err = np.abs(to_numpy(post_a.M) - true_A).max()
    tied_offset_err = np.abs(to_numpy(post_a.mus[0]) - true_c).max()
    print('tied-affine slope error ', tied_slope_err.round(5),
          '| offset error ', tied_offset_err.round(5))
    return {'mnw_M': est, 'tied_M': to_numpy(post_a.M),
            'tied_offset': to_numpy(post_a.mus[0]),
            'mnw_slope_error': float(slope_err),
            'mnw_offset_error': float(offset_err), 'mnw_logpdf': lp,
            'mng_noise_precisions': noise_prec,
            'tied_slope_error': float(tied_slope_err),
            'tied_offset_error': float(tied_offset_err)}


if __name__ == '__main__':
    main()
