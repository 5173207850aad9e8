"""ILR evaluation over the reference's benchmark datasets (the
counterpart of examples/ilr_eval.py): sine, sinc, step, step with cubic
polynomial features (step_poly), a hyperbolic chirp, the multi-valued
inverse S-curve, and the CMB table (Hannah 2011) when a copy is given by
--cmb_path. Each runs the flagship recipe (Gibbs start -> super-
iterations of SVI or VI with prior <- posterior re-anchoring), predicts
through kernel B5 on the card, and prints RMSE / mean NLPD / experts used
on one line a dataset.

    python -m mimo_tpu_torch.examples.ilr_eval [--cpu] [--dataset NAME]
        [--seed S] [--plot]

The data are drawn from numpy's default_rng(seed) exactly as the JAX
driver draws them, so both packages fit the same points.
"""

import os

import numpy as np
import torch

from mimo_tpu_torch.examples._common import maybe_save_plot, setup

# the CMB table is not in the repository: pass --cmb_path to a copy (two
# comma-separated columns under a header); without one it is skipped
CMB_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'cmb.csv')


def poly_features(x, degree):
    """1-D polynomial feature map [x, x^2, ..., x^degree]; the affine
    experts supply the bias column."""
    return np.concatenate([x ** p for p in range(1, degree + 1)], axis=-1)


def make_dataset(name, n, rng, cmb_path=CMB_DEFAULT):
    """Returns (x_raw, x_features, y) as float64 arrays; x_raw is what gets
    plotted."""
    if name == 'sine':
        x = rng.uniform(-6., 6., (n, 1))
        y = np.sin(x) + 0.1 * (1.0 + 0.2 * np.abs(x)) \
            * rng.standard_normal((n, 1))
    elif name == 'sinc':
        x = np.linspace(-10., 10., n).reshape(n, 1)
        noise = 0.05 + 0.2 * (1. + np.sin(2. * x)) / (1. + np.exp(-0.2 * x))
        y = np.sinc(x) + noise * rng.standard_normal((n, 1))
    elif name in ('step', 'step_poly'):
        q = n // 4
        x = np.concatenate([np.linspace(-2., -1., q), np.linspace(-1., 0., q),
                            np.linspace(0., 1., q),
                            np.linspace(1., 2., n - 3 * q)]).reshape(-1, 1)
        mean = np.concatenate([np.full(q, 1.), np.full(q, 3.),
                               np.full(q, 0.),
                               np.full(n - 3 * q, 4.)]).reshape(-1, 1)
        sigma = 3.0 if name == 'step_poly' else 0.1
        y = mean + sigma * rng.standard_normal((len(x), 1))
        if name == 'step_poly':
            return x, poly_features(x, 3), y
    elif name == 'chirp':
        # hyperbolic chirp f(t) = f0 f1 t1 / ((f0 - f1) t + f1 t1), its
        # phase integrated (scipy.signal.chirp's method='hyperbolic')
        x = np.linspace(0., 5., n).reshape(n, 1)
        f0, f1, t1 = 2.5, 1.0, 2.5
        sing = -f1 * t1 / (f0 - f1)
        phase = -2 * np.pi * f0 * f1 * t1 / (f0 - f1) \
            * np.log(np.abs(1 - x / sing))
        y = np.cos(phase) + 0.25 * rng.standard_normal((n, 1))
    elif name == 'inverse':
        out = rng.uniform(0., 1., (n, 1))
        x = out + 0.3 * np.sin(2. * np.pi * out) \
            + 0.05 * rng.standard_normal((n, 1))
        y = out
    elif name == 'cmb':
        if not os.path.exists(cmb_path):
            raise FileNotFoundError(
                f'{cmb_path} not found; pass --cmb_path (CMB table from '
                f'Hannah 2011, two comma-separated columns)')
        data = np.loadtxt(cmb_path, delimiter=',', skiprows=1)
        x, y = data[:n, :1], data[:n, 1:]
    else:
        raise ValueError(name)
    return x, x, y


# per-dataset hyperparameters (the reference drivers' nb_models and
# alpha); the small datasets use full-batch VI inside the super-iterations
PRESETS = {
    'sine': dict(n=2000, k=50, alpha=5.0, engine='svi'),
    'sinc': dict(n=2500, k=50, alpha=5.0, engine='svi'),
    'step': dict(n=160, k=10, alpha=1.0, engine='vi'),
    'step_poly': dict(n=160, k=10, alpha=1.0, engine='vi'),
    'chirp': dict(n=1500, k=50, alpha=5.0, engine='vi'),
    'inverse': dict(n=200, k=10, alpha=1.0, engine='vi'),
    'cmb': dict(n=696, k=25, alpha=3.0, engine='vi'),
}


def parse(argv=None):
    """(args, device) of the command line `argv`."""
    return setup(
        'ILR benchmark datasets (evaluate_* parity)', argv,
        dataset=(str, 'all', 'sine|sinc|step|step_poly|chirp|inverse|cmb|all'),
        nb_models=(int, 0, 'expert truncation (0 = per-dataset preset)'),
        alpha=(float, 0.0, 'DP concentration (0 = preset)'),
        n=(int, 0, 'training points (0 = preset)'),
        super_iters=(int, 2, 'SVI super-iterations'),
        gibbs_iters=(int, 25, 'Gibbs init sweeps'),
        svi_iters=(int, 500, 'SVI iterations per super-iteration'),
        svi_stepsize=(float, 5e-1, 'SVI step size'),
        svi_batchsize=(int, 128, 'SVI batch size'),
        prediction=(str, 'average', 'average | mode'),
        cmb_path=(str, CMB_DEFAULT, 'path to the CMB csv'),
    )


def fit(name, args, dev):
    """The flagship recipe on dataset `name` at the settings of `args`
    (from `parse`), drawn from default_rng(args.seed). Returns (model,
    state, x_raw, x, y) with x (the features) and y on `dev`; raises
    FileNotFoundError for a CMB table that is not there."""
    from mimo_tpu_torch.config import (
        GatingConfig, ILRConfig, TrainConfig, flagship_fit)
    preset = PRESETS[name]
    n = args.n or preset['n']
    x_raw, x_feat, y = make_dataset(name, n, np.random.default_rng(args.seed),
                                    args.cmb_path)
    x = torch.as_tensor(x_feat, dtype=args.dtype, device=dev)
    yt = torch.as_tensor(y, dtype=args.dtype, device=dev)
    cfg = ILRConfig(size=args.nb_models or preset['k'],
                    input_dim=x.shape[-1], output_dim=1,
                    gating=GatingConfig('stick-breaking',
                                        args.alpha or preset['alpha']),
                    kappa=0.05, K_scale=1e-2)
    model = cfg.build(dtype=args.dtype, device=dev)
    model.init_transform(x, yt)
    train = TrainConfig(super_iters=args.super_iters,
                        gibbs_iters=args.gibbs_iters,
                        svi_iters=args.svi_iters,
                        vi_iters=args.svi_iters,
                        svi_step_size=args.svi_stepsize,
                        svi_batch_size=min(args.svi_batchsize, x.shape[0]),
                        seed=args.seed, engine=preset['engine'])
    model, state = flagship_fit(model, (x, yt), train)
    return model, state, x_raw, x, yt


def main(argv=None):
    args, dev = parse(argv)
    names = list(PRESETS) if args.dataset == 'all' else [args.dataset]
    results = {}
    for name in names:
        try:
            model, state, x_raw, x, y = fit(name, args, dev)
        except FileNotFoundError as e:
            print(f'{name}: skipped ({e})')
            continue
        mu, _, std, nlpd = model.predict(state, x, y,
                                         prediction=args.prediction)
        rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
        mean_nlpd = float(torch.mean(nlpd))
        used = int(model.used_labels(state, (x, y)).sum())
        n, k = x.shape[0], model.size
        print(f'{name:10s} N={n:5d} K={k:3d}: RMSE {rmse:8.4f} | '
              f'mean NLPD {mean_nlpd:8.4f} | {used} experts')
        results[name] = {'rmse': rmse, 'nlpd': mean_nlpd, 'used': used,
                         'n': n, 'k': k}

        if args.plot:
            import matplotlib.pyplot as plt
            from mimo_tpu_torch.utils.plot import plot_regression_band
            plt.figure()
            plot_regression_band(x_raw, mu, std, y=y)
            maybe_save_plot(args, f'ilr_{name}')
    return results


if __name__ == '__main__':
    main()
