"""Truncated stick-breaking prior: Dirichlet-process intuition (the
counterpart of examples/dp_sticks.py). Draws weight vectors from
StickBreaking(K, alpha), all at once, checks their Monte-Carlo mean
against the analytic decay E[pi_k] = (1 / (1 + alpha)) (alpha / (1 +
alpha))^k, and draws random DP mixture CDFs (weights x standard-normal
atoms) against the base measure's CDF.

    python -m mimo_tpu_torch.examples.dp_sticks [--cpu] [--k K]
        [--alpha A] [--draws D] [--cdfs C] [--plot]
"""

import math

import torch

from mimo_tpu_torch.examples._common import (
    check, generator, maybe_save_plot, setup)
from mimo_tpu_torch.utils.data import to_numpy


def expected_weights(k, alpha, dtype=torch.float64, device=None):
    """The prior mean of the K stick-breaking weights before truncation:
    E[pi_k] = (1 / (1 + alpha)) (alpha / (1 + alpha))^k, k = 0..K-1."""
    rate = alpha / (1.0 + alpha)
    return (1.0 / (1.0 + alpha)) * rate ** torch.arange(k, dtype=dtype,
                                                        device=device)


def main(argv=None):
    args, dev = setup('Truncated stick-breaking / DP prior demo', argv,
                      k=(int, 1000, 'truncation level'),
                      alpha=(float, 10.0, 'DP concentration'),
                      draws=(int, 10000, 'prior weight draws'),
                      cdfs=(int, 10, 'random mixture CDFs to draw'))
    from mimo_tpu_torch.distributions.gating import StickBreaking

    gen = generator(args, dev)
    prior = StickBreaking.standard(args.k, args.alpha, args.dtype, dev)
    # all the draws at once: the prior's sticks repeated over the draws
    batch = StickBreaking(*(t.expand(args.draws, args.k).contiguous()
                            for t in prior))
    weights = batch.sample(gen)                           # (draws, K)

    # the Monte-Carlo mean of the weights against its closed form
    mean_w = torch.mean(weights, 0)
    theory = expected_weights(args.k, args.alpha, args.dtype, dev)
    err = float(torch.max(torch.abs(mean_w[:50] - theory[:50])))
    print(f'K={args.k} alpha={args.alpha}: E[pi_1..5] = '
          f'{to_numpy(mean_w[:5]).round(4)} (theory '
          f'{to_numpy(theory[:5]).round(4)}, max abs err first 50 sticks '
          f'{err:.2e})')
    check(err < 5e-3, 'stick-breaking prior mean off its closed form')

    # random DP mixture CDFs: F(x) = sum_k pi_k 1[omega_k <= x],
    # omega_k ~ N(0, 1), scattered around the base measure's CDF
    atoms = torch.randn((args.cdfs, args.k), generator=gen,
                        dtype=args.dtype, device=dev)
    grid = torch.linspace(-3.0, 3.0, 200, dtype=args.dtype, device=dev)
    sample_cdfs = torch.einsum('ck,ckx->cx', weights[:args.cdfs],
                               (atoms[:, :, None] <= grid[None, None, :])
                               .to(args.dtype))
    base_cdf = 0.5 * (1.0 + torch.erf(grid / math.sqrt(2.0)))
    dev_sup = float(torch.mean(torch.max(
        torch.abs(sample_cdfs - base_cdf[None]), -1).values))
    print(f'{args.cdfs} random DP({args.alpha}) mixture CDFs: mean sup '
          f'deviation from the base N(0,1) CDF {dev_sup:.3f} '
          f'(shrinks as alpha grows)')
    check(bool(torch.all(torch.abs(sample_cdfs[:, -1] - 1.0) < 1e-3)),
          'CDFs must reach 1 at the right edge')
    print('OK')

    if args.plot:
        import matplotlib.pyplot as plt
        _, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.bar(range(1, 51), to_numpy(mean_w[:50]))
        ax1.set_xlabel('stick index')
        ax1.set_ylabel('E[pi_k]')
        for c in to_numpy(sample_cdfs):
            ax2.step(to_numpy(grid), c, alpha=0.6)
        ax2.plot(to_numpy(grid), to_numpy(base_cdf), 'k--', lw=2)
        maybe_save_plot(args, 'dp_sticks')
    return {'mean_weights': to_numpy(mean_w[:50]),
            'theory': to_numpy(theory[:50]),
            'max_abs_err': err, 'mean_sup_deviation': dev_sup}


if __name__ == '__main__':
    main()
