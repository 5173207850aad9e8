#!/usr/bin/env python3
"""Time the serving kernels B3-B6 of one checkout of mimo_tpu_torch on
one CUDA card, at the input widths on each side of their compiled limits.

    python3 serving_widths.py [--tree DIR] [--label NAME] [--n N] [--k K]

mimo_tpu_torch is imported from DIR (default: this script's directory),
so that two checkouts, for example a parent commit unpacked with
`git archive` into build/ and this one, can be timed on the same card
one after the other (parent, change, change, parent). Each kernel is fed
a random posterior with the scales of a fit at N ~ 1e6 (K components, N
points, float32, seed 0) through the checkout's own coefficient functions
and wrappers:

  B3  Student-t mixture density, d = 2, 4, 5, 8, 9, 12, 16, 17, 24, 25,
      32 (9, 17 and 25 just past a compiled width, padded up);
  B4  diagonal Student-t mixture density at the same d, tail exponents
      equal across dims (as in a fit); B4u the same at d = 2, 4, 5, 8
      with tail exponents drawn per dim;
  B5  ILR predict, p = 1, with y, d = 1, 4, 5, 8;
  B6  ILR predict, p = 2, MNW experts, with y, d = 2, 3, 4, 8.

For each: the kernel's mean CUDA-event time over 10 launches after 2
warm-ups, its plain PyTorch version's over 2, and the kernel's max |err|
against the plain version. Prints the card's name and power limit
(nvidia-smi), then one JSON line {"label": ..., "rows": [{"kernel", "d",
"p", "k", "n", "ms", "plain_ms", "max_abs_err"} or an "error" where the
checkout refused the shape, ...]}.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parent))
    ap.add_argument('--label', default='this checkout')
    ap.add_argument('--n', type=int, default=1_000_000)
    ap.add_argument('--k', type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('serving_widths: no CUDA device')
    import mimo_tpu_torch  # noqa: F401  (the float32 precision policy)
    from mimo_tpu_torch.distributions.mnw import MNW
    from mimo_tpu_torch.distributions.ng import NG
    from mimo_tpu_torch.distributions.niw import NIW
    from mimo_tpu_torch.ops import (
        cuda_diag_predict, cuda_ilr_predict, cuda_predict)
    if not mimo_tpu_torch.__file__.startswith(str(Path(args.tree).resolve())):
        raise SystemExit(f'serving_widths: imported {mimo_tpu_torch.__file__}'
                         f', not the package under {args.tree}')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    print(smi.stdout.strip())
    dev = torch.device('cuda:0')
    gen = torch.Generator(device=dev).manual_seed(0)
    n, k = args.n, args.k

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def psd(q):
        a = randn(k, q, q)
        return a @ a.transpose(-1, -2) / q + torch.eye(q, device=dev)

    def counts():
        return 1e4 + 1e4 * rand(k)

    def ilr_posterior(d, p):
        nu_b, nu_e = counts(), counts()
        basis = NIW(mu=rand(k, d) * 6 - 3, kappa=counts(),
                    psi=psd(d) / nu_b[:, None, None], nu=nu_b)
        experts = MNW(M=randn(k, p, d + 1) * 0.5, K_=psd(d + 1) * 1e4,
                      psi=psd(p) * 100.0 / nu_e[:, None, None], nu=nu_e)
        return basis, experts

    def ng_posterior(d, shared=True):
        c = (1e4 + 9e4 * rand(k, 1)).expand(k, d) if shared else \
            1e4 + 9e4 * rand(k, d)
        return NG(mu=randn(k, d) * 4.0, kappa=c, alpha=0.5 * c,
                  beta=0.5 * c * (0.25 + 0.5 * rand(k, d)))

    log_w = torch.log_softmax(randn(k), 0)
    cases = []
    widths = (2, 4, 5, 8, 9, 12, 16, 17, 24, 25, 32)
    for d in widths:
        basis, _ = ilr_posterior(d, 1)
        xt = (rand(d, n) * 6 - 3).contiguous()
        thq, aux = cuda_predict.predictive_coefficients(basis, log_w)
        cases.append(('B3', d, 0, lambda xt=xt, thq=thq, aux=aux:
                      cuda_predict.predict(xt, thq, aux, n),
                      lambda xt=xt, thq=thq, aux=aux:
                      cuda_predict.predict_plain(xt, thq, aux, n)))
    for name, d in ([('B4', d) for d in widths]
                    + [('B4u', d) for d in (2, 4, 5, 8)]):
        post = ng_posterior(d, name == 'B4')
        xt = (post.mu[torch.randint(0, k, (n,), generator=gen, device=dev)]
              + 0.5 * randn(n, d)).T.contiguous()
        # (thu, h, aux) or (rows, aux), whichever the checkout builds
        coef = cuda_diag_predict.diag_predict_coefficients(post, log_w)
        cases.append((name, d, 0, lambda xt=xt, coef=coef:
                      cuda_diag_predict.diag_predict(xt, *coef, n),
                      lambda xt=xt, coef=coef:
                      cuda_diag_predict.diag_predict_plain(xt, *coef, n)))
    for d in (1, 4, 5, 8):
        basis, experts = ilr_posterior(d, 1)
        xt = torch.cat([rand(d, n) * 6 - 3, randn(1, n)]).contiguous()
        th, aux = cuda_ilr_predict.ilr_predict_coefficients(basis, experts,
                                                            log_w)
        cases.append(('B5', d, 1, lambda xt=xt, th=th, aux=aux:
                      cuda_ilr_predict.ilr_predict(xt, th, aux, n, True,
                                                   False),
                      lambda xt=xt, th=th, aux=aux:
                      cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n, True,
                                                         False)))
    for d in (2, 3, 4, 8):
        p = 2
        basis, experts = ilr_posterior(d, p)
        xt = torch.cat([rand(d, n) * 6 - 3, randn(p, n)]).contiguous()
        th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
            basis, experts, log_w, True, True)
        cases.append(('B6', d, p, lambda xt=xt, th=th, aux=aux, vc=vc, p=p:
                      cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                     True, False),
                      lambda xt=xt, th=th, aux=aux, vc=vc, p=p:
                      cuda_ilr_predict.ilr_p_predict_plain(
                          xt, th, aux, vc, n, p, True, False)))

    rows = []
    for name, d, p, kern, plain in cases:
        try:
            err = float((kern().double() - plain().double()).abs().max())
        except (NotImplementedError, RuntimeError) as e:   # a refused shape
            rows.append({'kernel': name, 'd': d, 'p': p, 'k': k, 'n': n,
                         'error': str(e)})
            print(f'{args.label}: {name} d={d} p={p}: {e}', flush=True)
            continue
        rows.append({'kernel': name, 'd': d, 'p': p, 'k': k, 'n': n,
                     'ms': cuda_ms(torch, kern, 10),
                     'plain_ms': cuda_ms(torch, plain, 2),
                     'max_abs_err': err})
        r = rows[-1]
        print(f'{args.label}: {name} d={d} p={p} K={k} N={n}: kernel '
              f'{r["ms"]:.6g} ms, plain {r["plain_ms"]:.6g} ms, max|err| '
              f'{err:.3g}', flush=True)
    print(json.dumps({'label': args.label, 'rows': rows}))


if __name__ == '__main__':
    main()
