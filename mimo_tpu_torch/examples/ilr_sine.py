"""The flagship workload: an infinite mixture of linear regressions on a
noisy sine (the counterpart of examples/ilr_sine.py): standardized data,
the prior from the command line's hyperparameters, a Gibbs start,
super-iterations of SVI with prior <- posterior re-anchoring, then the
moment-matched prediction and its NLPD (kernel B5 on the card).

    python -m mimo_tpu_torch.examples.ilr_sine [--cpu] [--nb_models K]
        [--svi_iters S] [--n N] [--plot]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import maybe_save_plot, setup
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup(
        'ILR on sine (evaluate_sine parity)', argv,
        nb_models=(int, 50, 'expert truncation (--nb_models)'),
        alpha=(float, 5.0, 'DP concentration (--alpha)'),
        super_iters=(int, 2, 'SVI super-iterations (--super_iters)'),
        gibbs_iters=(int, 10, 'Gibbs init sweeps (--gibbs_iters)'),
        svi_iters=(int, 500, 'SVI iterations (--svi_iters)'),
        svi_stepsize=(float, 5e-1, '(--svi_stepsize)'),
        svi_batchsize=(int, 256, '(--svi_batchsize)'),
        prediction=(str, 'average', 'average | mode (--prediction)'),
        n=(int, 2000, 'training points'),
    )
    from mimo_tpu_torch.config import (
        GatingConfig, ILRConfig, TrainConfig, flagship_fit)

    rng = np.random.default_rng(args.seed)
    x_np = rng.uniform(-6., 6., (args.n, 1))
    x = torch.as_tensor(x_np, dtype=args.dtype, device=dev)
    # JAX's driver forms the noise and the target from x in its dtype
    xr = to_numpy(x)
    noise = 0.1 * (1.0 + 0.2 * np.abs(xr))
    y = torch.as_tensor(np.sin(xr) + noise * rng.standard_normal((args.n, 1)),
                        dtype=args.dtype, device=dev)

    cfg = ILRConfig(size=args.nb_models, input_dim=1, output_dim=1,
                    gating=GatingConfig('stick-breaking', args.alpha),
                    kappa=0.05, K_scale=1e-2)
    model = cfg.build(dtype=args.dtype, device=dev)
    model.init_transform(x, y)

    train = TrainConfig(super_iters=args.super_iters,
                        gibbs_iters=args.gibbs_iters,
                        svi_iters=args.svi_iters,
                        svi_step_size=args.svi_stepsize,
                        svi_batch_size=args.svi_batchsize, seed=args.seed)
    model, state = flagship_fit(model, (x, y), train)

    mu, _, std, nlpd = model.predict(state, x, y,
                                     prediction=args.prediction)
    rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
    mean_nlpd = float(torch.mean(nlpd))
    used = int(model.used_labels(state, (x, y)).sum())
    print(f'RMSE {rmse:.4f} | mean NLPD {mean_nlpd:.4f} | '
          f'{used} experts used')

    if args.plot:
        from mimo_tpu_torch.utils.plot import plot_regression_band
        plot_regression_band(x, mu, std, y=y)
        maybe_save_plot(args, 'ilr_sine')
    return {'rmse': rmse, 'nlpd': mean_nlpd, 'used': used}


if __name__ == '__main__':
    main()
