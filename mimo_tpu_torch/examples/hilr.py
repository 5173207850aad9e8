"""Hierarchical ILR variants on a triangle wave (the counterpart of
examples/hilr.py): tied-activation experts (a hierarchical basis with
tied-affine experts: shared slope and noise), Gibbs then warm VI, and a
two-level mixture of ILRs by nested VI. The tied-activation model
predicts through kernel B5 on the card; the nested one predicts at its
default Gaussian predictive, the dense path, as the JAX driver does.

    python -m mimo_tpu_torch.examples.hilr [--cpu] [--nb_models K] [--plot]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import maybe_save_plot, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('hierarchical ILR', argv,
                      nb_models=(int, 25, 'experts'))
    from mimo_tpu_torch.models.hmix import BayesianMixtureOfMixtures
    from mimo_tpu_torch.models.ilr import BayesianILR
    from mimo_tpu_torch.models.mixture import MFState

    rng = np.random.default_rng(args.seed)
    n = 1500
    x = torch.as_tensor(rng.uniform(-3., 3., (n, 1)), dtype=args.dtype,
                        device=dev)
    xr = to_numpy(x)
    tri = 2.0 * np.abs(xr / 2.0 - np.floor(xr / 2.0 + 0.5)) - 0.5
    y = torch.as_tensor(tri + 0.05 * rng.standard_normal((n, 1)),
                        dtype=args.dtype, device=dev)

    # tied-activation: hierarchical basis + tied-affine experts
    m = BayesianILR.make(size=args.nb_models, input_dim=1, output_dim=1,
                         alpha=5.0, kappa=0.05, tied_affine=True,
                         hier_basis=True, maxsubiter=10, dtype=args.dtype,
                         device=dev)
    m.init_transform(x, y)
    g = m.fit_gibbs((x, y), key=args.seed, maxiter=30)
    st, _ = m.fit_vi((x, y), key=args.seed + 1, maxiter=100,
                     init_state=MFState(g.components, g.gating),
                     randomize=False)
    mu, _, std, nlpd = m.predict(st, x, y)
    rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
    mean_nlpd = float(torch.mean(nlpd))
    print(f'tied-activation ILR: RMSE {rmse:.4f}, mean NLPD '
          f'{mean_nlpd:.4f}')

    # two-level mixture of ILRs
    mm = BayesianMixtureOfMixtures.make_ilr(
        cluster_size=2, mixture_size=6, input_dim=1, output_dim=1,
        kappa=0.05, dtype=args.dtype, device=dev)
    mm.init_transform(x, y)
    st2, tr = mm.fit_vi((x, y), key=args.seed, maxiter=40, maxsubiter=2)
    mu2, _, _, nlpd2 = mm.predict(st2, x, y)
    rmse2 = float(torch.sqrt(torch.mean((mu2 - y) ** 2)))
    nlpd2 = float(torch.mean(nlpd2))
    print(f'mixture-of-ILRs marginal loglik {float(tr[-1]):.1f}, RMSE '
          f'{rmse2:.4f}, mean NLPD {nlpd2:.4f}')

    if args.plot:
        from mimo_tpu_torch.utils.plot import plot_regression_band
        plot_regression_band(x, mu, std, y=y)
        maybe_save_plot(args, 'hilr')
    return {'rmse': rmse, 'nlpd': mean_nlpd,
            'nested_loglik': float(tr[-1]), 'nested_rmse': rmse2,
            'nested_nlpd': nlpd2}


if __name__ == '__main__':
    main()
