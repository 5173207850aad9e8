#!/usr/bin/env python3
"""Time kernels B1 and B2 of one checkout of mimo_tpu_torch on one CUDA
card at shapes past their plain layout (csrc/tc.cuh).

    python3 layout_rates.py [--tree DIR] [--label NAME] [--fed]

mimo_tpu_torch is imported from DIR (default: this script's directory),
so that two checkouts, for example a parent commit unpacked with
`git archive` into build/ and this one, can be timed on the same card
one after the other (parent, change, change, parent). Cells, float32,
seed 0, random NIW posteriors with the scales of a fit at N ~ 1e6 (as
chip_smoke.py phase 4 draws them) over the Gauss map; B1 takes the VI
coefficients, B2 the plug-in ones at the posterior mode:

  wide  K=300, d=2, N=1,000,003 (chip_smoke.py phase 4's cell past the
        plain layout) with C=1 and C=2 chains (theta (C, K, m8), the
        chains' posteriors drawn one after the other);
  fed   (with --fed) N=1e6, K=128, d=16 and N=1e6, K=256, d=32 (the
        Gauss shapes of bench.py:296-312), and the ILR map at d=16, p=1,
        K=50, N=1,000,003 (random coefficients, x ~ U(-2, 2)).

For each: the kernel's mean CUDA-event time over 5 launches after 2
warm-ups (or the error where the checkout refuses the shape), its plain
PyTorch version's over 2, and the kernel's max |err| against it (B1's
statistics and lse; B2's share of labels unlike the plain Philox draw).
Prints the card's name and power limit (nvidia-smi), then one JSON line
{"label": ..., "rows": [{"kernel", "cell", "k", "d", "p", "c", "n",
"ms", "plain_ms", "err"}, ...]}.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(torch, fn, reps, warm=2):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gauss_thetas(torch, gen, k, d, c, dev):
    """C stacked (VI theta, plug-in theta) pairs over the Gauss map with
    c + log pi in column 0, and points (d, n) around the first centre."""
    from mimo_tpu_torch.distributions.niw import NIW, mode_params
    from mimo_tpu_torch.ops.cuda_estep import pad_theta
    from mimo_tpu_torch.ops.family_estep import gaussian_spec
    spec = gaussian_spec()
    vi, pl, mu0 = [], [], None
    for _ in range(c):
        a = torch.randn((k, d, d), generator=gen, device=dev)
        psi = (a @ a.transpose(-1, -2) / d + torch.eye(d, device=dev)) * 2e-4
        post = NIW(
            mu=torch.randn((k, d), generator=gen, device=dev) * 4.0,
            kappa=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev),
            psi=psi,
            nu=d + 2.0 + 1e5 * torch.rand((k,), generator=gen, device=dev))
        log_pi = torch.log_softmax(
            torch.randn((k,), generator=gen, device=dev), 0)
        vi.append(pad_theta(spec.theta(post), log_pi, torch.float32)[0])
        pl.append(pad_theta(spec.theta_plugin(mode_params(post)), log_pi,
                            torch.float32)[0])
        mu0 = post.mu[0] if mu0 is None else mu0
    return torch.stack(vi).contiguous(), torch.stack(pl).contiguous(), mu0


def time_pair(torch, rows, row, kern, plain, err):
    try:
        row['ms'] = cuda_ms(torch, kern, 5)
    except (NotImplementedError, RuntimeError) as exc:
        row['error'] = f'{type(exc).__name__}: {exc}'[:300]
        rows.append(row)
        print(json.dumps(row), flush=True)
        return
    row['plain_ms'] = cuda_ms(torch, plain, 2, warm=0)
    row['err'] = err()
    rows.append(row)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parent))
    ap.add_argument('--label', default='this')
    ap.add_argument('--fed', action='store_true')
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('layout_rates: no CUDA device')
    import mimo_tpu_torch  # noqa: F401  (the float32 precision policy)
    from mimo_tpu_torch.ops import _build, cuda_estep, cuda_gibbs
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.load()
    dev = torch.device('cuda:0')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def b1_err(xt, th, n, kind=cuda_estep.GAUSS, p=0):
        acc, lse = cuda_estep.estep(xt, th, n, kind, p)
        pacc, plse = cuda_estep.estep_plain(xt, th, n, kind, p)
        return max(float((acc - pacc).abs().max()),
                   float((lse - plse).abs().max()))

    def b2_err(xt, th, seeds, n, kind=cuda_estep.GAUSS, p=0):
        lab, _ = cuda_gibbs.gibbs(xt, th, seeds, n, kind, p)
        plab, _ = cuda_gibbs.gibbs_plain(xt, th, seeds, n, kind, p)
        return float((lab != plab).double().mean())

    def cell(name, k, d, n, c, p=0, kind=cuda_estep.GAUSS):
        if kind == cuda_estep.GAUSS:
            th_vi, th_g, mu0 = gauss_thetas(torch, gen, k, d, c, dev)
            xt = (torch.randn((d, n), generator=gen, device=dev) * 4.0
                  + mu0[:, None])
        else:
            m = cuda_estep.feature_width(kind, d, p)
            m8 = -(-m // 8) * 8
            xt = torch.rand((d + p, n), generator=gen, device=dev) * 4 - 2
            th_vi = torch.randn((c, k, m8), generator=gen,
                                device=dev) * 0.05
            th_vi[..., m:] = 0.0
            th_g = th_vi
        if c == 1:
            th_vi, th_g = th_vi[0], th_g[0]
        seeds = (torch.arange(c, dtype=torch.int64, device=dev) * 7919 + 11
                 if c > 1 else torch.tensor(11, dtype=torch.int64,
                                            device=dev))
        base = {'cell': name, 'k': k, 'd': d, 'p': p, 'c': c, 'n': n}
        time_pair(torch, rows, dict(base, kernel='B1'),
                  lambda: cuda_estep.estep(xt, th_vi, n, kind, p),
                  lambda: cuda_estep.estep_plain(xt, th_vi, n, kind, p),
                  lambda: b1_err(xt, th_vi, n, kind, p))
        time_pair(torch, rows, dict(base, kernel='B2'),
                  lambda: cuda_gibbs.gibbs(xt, th_g, seeds, n, kind, p),
                  lambda: cuda_gibbs.gibbs_plain(xt, th_g, seeds, n, kind,
                                                 p),
                  lambda: b2_err(xt, th_g, seeds, n, kind, p))
        torch.cuda.empty_cache()

    cell('wide', 300, 2, 1_000_003, 1)
    cell('wide', 300, 2, 1_000_003, 2)
    if args.fed:
        cell('fed', 128, 16, 1_000_000, 1)
        cell('fed', 256, 32, 1_000_000, 1)
        cell('fed-ilr', 50, 16, 1_000_003, 1, p=1, kind=cuda_estep.ILR)
    print(json.dumps({'label': args.label, 'rows': rows}))


if __name__ == '__main__':
    main()
