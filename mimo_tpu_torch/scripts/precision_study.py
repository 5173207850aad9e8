"""Does the kernels' precision rule move the fitted posterior? (port of
the JAX repository's scripts/precision_study.py.)

At the north-star shape (N=1e7, K=50, d=2, DP gating, kappa=0.05,
psi_scale=0.5; VI 200 sweeps, Gibbs 100), compare on the card
  - backend 'cuda': kernels B1 / B2 (their products on TF32 tensor cores
    under the precision rule of csrc/estep.cuh) and B3 for the held-out
    score;
  - backend 'plain': the float32 plain PyTorch twins of the same passes;
reporting the final ELBO and its relative delta, the held-out mean log
predictive (label-permutation invariant) and its delta, the rate, and
the non-finite count. The Gibbs numbers are different draws on the two
backends and are compared, not held.

    python -m mimo_tpu_torch.scripts.precision_study [--cpu]
"""

import argparse
import time

import numpy as np
import torch

from mimo_tpu_torch.distributions.niw import GaussParams
from mimo_tpu_torch.models.gmm import BayesianGMM
from mimo_tpu_torch.models.mixture import model_device

N, K, D, VI_ITERS, GIBBS_ITERS, N_TEST = 10_000_000, 50, 2, 200, 100, 100_000
ENGINE_BACKEND = {'cuda': 'kernel', 'plain': 'torch'}


def _data(seed, n, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    mu = torch.tensor([[-3., 0.], [3., 0.], [0., 4.]], dtype=dtype,
                      device=device)
    lm = torch.eye(2, dtype=dtype, device=device).expand(3, 2, 2) * 2.0
    return BayesianGMM.generate(gen, GaussParams(mu, lm), [.3, .4, .3], n)[0]


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(n=N, k=K, vi_iters=VI_ITERS, gibbs_iters=GIBBS_ITERS, n_test=N_TEST,
        backends=('plain', 'cuda'), device=None, dtype=torch.float32,
        out=print):
    """Both fits on each backend (each run twice, the second timed) and
    their held-out scores. Returns {backend: {'elbo', 'logpred', 'vi_rate',
    'nonfinite', 'gibbs_logpred', 'gibbs_rate'}} and prints the
    reference's lines; with both backends also the deltas. `device`: by
    default the card (raises without one)."""
    device = model_device(device)
    x = _data(0, n, device, dtype)
    x_test = _data(99, n_test, device, dtype)
    model = BayesianGMM.make(size=k, dim=D, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, dtype=dtype,
                             device=device)
    res = {}
    for backend in backends:
        eng = ENGINE_BACKEND[backend]

        def pred(st):
            return float(torch.mean(model.log_predictive(st, x_test,
                                                         backend=eng)))
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            st, vlb = model.fit_vi_fused(x, key=1, maxiter=vi_iters,
                                         backend=eng)
            _sync(device)
            dt = time.perf_counter() - t0
        v = vlb.double().cpu().numpy()
        r = res[backend] = {'elbo': float(v[-1]), 'logpred': pred(st),
                            'vi_rate': vi_iters / dt,
                            'nonfinite': int((~np.isfinite(v)).sum())}
        out(f"VI {backend:6s}: final ELBO {r['elbo']:.8g} | held-out mean "
            f"logpred {r['logpred']:.6f} | {r['vi_rate']:.1f} iters/s | "
            f"nonfinite {r['nonfinite']}")
    if len(backends) == 2:
        a, b = (res[bk] for bk in backends)
        out(f"delta: ELBO rel {(b['elbo'] - a['elbo']) / abs(a['elbo']):+.2e}"
            f" | logpred {b['logpred'] - a['logpred']:+.6f} nats/pt")

    # Gibbs: stochastic, so the backends' held-out scores are compared
    for backend in backends:
        eng = ENGINE_BACKEND[backend]
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            gs = model.fit_gibbs_fused(x, key=2, maxiter=gibbs_iters,
                                       backend=eng)
            _sync(device)
            dt = time.perf_counter() - t0
        r = res[backend]
        r['gibbs_logpred'] = float(torch.mean(model.log_predictive(
            gs, x_test, backend=eng)))
        r['gibbs_rate'] = gibbs_iters / dt
        out(f"Gibbs {backend:6s}: held-out mean logpred "
            f"{r['gibbs_logpred']:.6f} | {r['gibbs_rate']:.1f} sweeps/s")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cpu', action='store_true',
                    help='the plain backend on the CPU in float32 (the '
                         'cuda backend needs the card)')
    args = ap.parse_args(argv)
    out = lambda s: print(s, flush=True)  # noqa: E731
    if args.cpu:
        return run(backends=('plain',), device='cpu', out=out)
    return run(out=out)


if __name__ == '__main__':
    main()
