"""Multi-seed sinc study (the counterpart of examples/ilr_sinc_study.py,
itself the reference's evaluate_sinc_parallel.py): every seed gets its
own random 80% train split (ShuffleSplit semantics) and runs the flagship
recipe (Gibbs start -> super-iterations of [SVI -> prior <- posterior
re-anchor]); each seed's predictive mean and std on the input grid and
its held-out NLPD come from kernel B5 on the card. Reports the per-seed
RMSE against the true sinc mean and the held-out NLPD, and checks that
the mean RMSE stays under 0.2.

The seeds' fits run as one program, as JAX's vmap runs them: the dense
Gibbs and SVI engines batched over the seeds as chains, each chain with
its own (ntr, 1) split and, after the first re-anchor, its own priors
(`with_priors` of the S-stacked state). The serving runs a seed at a
time.

    python -m mimo_tpu_torch.examples.ilr_sinc_study [--cpu] [--seeds S]
        [--svi_iters I] [--plot]
"""

import numpy as np
import torch

from mimo_tpu_torch.examples._common import (
    chain_keys, check, maybe_save_plot, setup)
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup(
        'multi-seed sinc study (the seeds as one program)', argv,
        seeds=(int, 8, 'number of random train splits (reference: 24)'),
        models=(int, 50, 'DP truncation level (reference: 100)'),
        alpha=(float, 50.0, 'DP concentration (reference: 100)'),
        gibbs_iters=(int, 10, 'Gibbs init sweeps'),
        super_iters=(int, 2, 'SVI super-iterations with re-anchoring'),
        svi_iters=(int, 500, 'SVI steps per super-iteration'),
        svi_step_size=(float, 0.5, 'SVI step size'),
        svi_batch_size=(int, 256, 'SVI minibatch'),
        prediction=(str, 'average', 'mode or average'),
    )
    from mimo_tpu_torch.models.ilr import BayesianILR
    from mimo_tpu_torch.models.mixture import MFState
    from mimo_tpu_torch.utils.tree import tree_map

    # the sinc dataset with input-dependent noise
    rng = np.random.default_rng(args.seed)
    n = 2500
    grid = np.linspace(-10., 10., n).reshape(n, 1)
    noise = 0.05 + 0.2 * (1. + np.sin(2. * grid)) / (1. + np.exp(-0.2 * grid))
    target = np.sinc(grid) + noise * rng.standard_normal((n, 1))
    mean_true = np.sinc(grid)

    # per-seed 80/20 shuffle splits, stacked on the chain axis
    n_tr = int(0.8 * n)
    perms = np.stack([rng.permutation(n) for _ in range(args.seeds)])

    def on_dev(a):
        return torch.as_tensor(a, dtype=args.dtype, device=dev)

    xtr, ytr = on_dev(grid[perms[:, :n_tr]]), on_dev(target[perms[:, :n_tr]])

    m = BayesianILR.make(size=args.models, input_dim=1, output_dim=1,
                         alpha=args.alpha, kappa=0.05, dtype=args.dtype,
                         device=dev)
    gx, gy = on_dev(grid), on_dev(target)
    m.init_transform(gx, gy)

    # the flagship recipe on every seed's split as one program
    keys = chain_keys(args.seed, args.seeds)
    g = m.fit_gibbs((xtr, ytr), key=keys, maxiter=args.gibbs_iters,
                    chains=True)
    states = MFState(g.components, g.gating)
    mm = m
    for it in range(args.super_iters):
        states, _ = mm.fit_svi(
            (xtr, ytr), key=keys + it + 1, maxiter=args.svi_iters,
            step_size=args.svi_step_size, batch_size=args.svi_batch_size,
            init_state=states, randomize=False, chains=True)
        mm = mm.with_priors(states)     # prior <- posterior re-anchor

    mus, stds, nlpds = [], [], []
    for s in range(args.seeds):
        st = tree_map(lambda a: a[s], states)
        te = perms[s, n_tr:]
        mu, _, std, _ = m.predict(st, gx, prediction=args.prediction)
        _, _, _, nlpd = m.predict(st, on_dev(grid[te]), on_dev(target[te]),
                                  prediction=args.prediction)
        mus.append(to_numpy(mu)[:, 0])
        stds.append(to_numpy(std)[:, 0])
        nlpds.append(to_numpy(nlpd))

    mu, std = np.stack(mus), np.stack(stds)                   # (S, n)
    rmse = np.sqrt(np.mean((mu - mean_true.T) ** 2, axis=1))  # (S,)
    nlpd_mean = np.array([a.mean() for a in nlpds])           # (S,)

    print(f'{args.seeds} seeds | RMSE vs true mean: '
          f'{rmse.mean():.4f} +- {rmse.std():.4f} '
          f'(min {rmse.min():.4f}, max {rmse.max():.4f})')
    print(f'held-out NLPD: {nlpd_mean.mean():.4f} +- {nlpd_mean.std():.4f}')
    check(np.isfinite(rmse).all() and np.isfinite(nlpd_mean).all(),
          'sinc study: non-finite RMSE or NLPD')
    check(rmse.mean() < 0.2, f'sinc recovery degraded: {rmse.mean()}')

    if args.plot:
        import matplotlib.pyplot as plt
        from mimo_tpu_torch.utils.plot import plot_violin_box
        _, axes = plt.subplots(3, 1, figsize=(7, 9))
        mu_avg, mu_std = mu.mean(0), mu.std(0)
        std_avg, std_std = std.mean(0), std.std(0)
        axes[0].plot(grid, mean_true, 'k--', zorder=10)
        axes[0].scatter(grid, target, s=0.75, facecolors='none',
                        edgecolors='grey', zorder=1)
        axes[0].plot(grid, mu_avg, '-r', zorder=5)
        for c in (1., 2.):
            axes[0].fill_between(grid.ravel(), mu_avg - c * mu_std,
                                 mu_avg + c * mu_std, color=(0, 0, 1, .1))
        axes[0].set_title('predictive mean across seeds')
        axes[1].plot(grid, noise, 'k--', zorder=10)
        axes[1].plot(grid, std_avg, '-r', zorder=5)
        for c in (1., 2.):
            axes[1].fill_between(grid.ravel(), std_avg - c * std_std,
                                 std_avg + c * std_std, color=(0, 0, 1, .1))
        axes[1].set_title('predictive std vs true noise level')
        plot_violin_box([rmse, nlpd_mean], labels=['RMSE', 'NLPD'],
                        ax=axes[2])
        axes[2].set_title('per-seed RMSE / held-out NLPD')
        plt.tight_layout()
        maybe_save_plot(args, 'ilr_sinc_study')
    return {'rmse': rmse, 'nlpd': nlpd_mean, 'rmse_mean': float(rmse.mean()),
            'nlpd_mean': float(nlpd_mean.mean())}


if __name__ == '__main__':
    main()
