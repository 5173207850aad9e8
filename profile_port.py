#!/usr/bin/env python3
"""Where the time goes in the port's cells on one CUDA card.

    python3 profile_port.py [--units U] [--engines-only]

For each cell it fits the model at the size `chip_smoke.py` drives,
warms up, then measures one unit of work (a warm-started VI sweep, a
Gibbs sweep, one serving call, a sweep of a 50-sweep MAP-EM or ML-EM fit
with its init, a dense VI sweep or an SVI step; `--engines-only` runs
just the last three, the cells of `chip_smoke.py` phase 17): the wall time per unit (median of 3
un-profiled runs of U units, synchronised), and under `torch.profiler`
the device time per unit, split into the named kernel and the other
device ops (their count and time). The idle share is 1 - device busy /
wall: how far the host holds the card back. Prints one line per cell
and engine, with the card's name and power limit first.
"""

import argparse
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import mimo_tpu_torch  # noqa: F401  (sets the float32 precision policy)
from mimo_tpu_torch.distributions.niw import GaussParams
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models.mixture import MFState

N_GMM, N_SINE, N_P3, N_Q8, K = (10_000_000, 10_000_000, 1_000_000,
                                 1_000_000, 50)


def wall_ms(fn, units, reps=3):
    """Median wall time per unit of fn() (which does `units` units)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3 / units)
    return statistics.median(times)


def device_split(fn, units, kernel):
    """(device busy, kernel, other ops' time, other ops' count) per unit,
    in ms, from the profiler's device events of one run of fn()."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = kern = count = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total / 1e3
        busy += t
        if kernel in e.key:
            kern += t
        else:
            count += e.count
    return busy / units, kern / units, (busy - kern) / units, count / units


def serving_data(g, n, d, p, dev):
    """The serving cells' data: the sine flagship (p = 1: x ~ U(-6, 6),
    y = sin x + 0.1 eps) or y = tanh(x w) + 0.1 eps, x ~ U(-3, 3)^d."""
    if p == 1:
        x = torch.rand((n, 1), generator=g, device=dev) * 12 - 6
        return x, torch.sin(x) + 0.1 * torch.randn((n, 1), generator=g,
                                                   device=dev)
    x = torch.rand((n, d), generator=g, device=dev) * 6 - 3
    w = torch.randn((d, p), generator=g, device=dev)
    return x, torch.tanh(x @ w) + 0.1 * torch.randn((n, p), generator=g,
                                                    device=dev)


def report(card, cell, unit, fn, units, kernel):
    fn()                                    # warm
    wall = wall_ms(fn, units)
    for _ in range(3):      # a profiling window now and then records nothing
        busy, kern, other, count = device_split(fn, units, kernel)
        if busy > 0.0:
            break
    else:
        raise SystemExit('profile_port: the profiler saw no device time')
    print(f'{cell}, per {unit} ({card}): wall {wall:.6g} ms; device busy '
          f'{busy:.6g} ms; {kernel} {kern:.6g} ms '
          f'({100 * kern / busy:.4g}% of busy); other device ops '
          f'{count:.4g} ({other:.4g} ms); idle share '
          f'{max(0.0, 1 - busy / wall):.3f}', flush=True)


def engine_cells(card, dev, x, u):
    """The cells of chip_smoke.py phase 17 on the DP-GMM data: MAP-EM and
    ML-EM through B1 (a 50-sweep fit, its init included, per sweep), the
    dense VI sweep on the first 1e6 points and the SVI step at B=256 and
    65536 (no kernel: their device time is all other ops)."""
    m = BayesianGMM.make(size=K, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    cell = f'DP-GMM N={N_GMM}'
    report(card, cell, 'MAP-EM sweep (50-sweep fit)',
           lambda: m.fit_map_fused(x, key=1, maxiter=50), 50, 'estep_tc')
    report(card, cell, 'ML-EM sweep (50-sweep fit)',
           lambda: m.fit_em_fused(x, key=0, maxiter=50), 50, 'estep_tc')
    x1 = x[:1_000_000]
    st, _ = m.fit_vi(x1, key=1, maxiter=5)
    report(card, 'DP-GMM N=1000000 (dense)', 'fit_vi sweep',
           lambda: m.fit_vi(x1, maxiter=u, init_state=st, randomize=False),
           u, 'estep_tc')
    st, _ = m.fit_svi(x, key=5, maxiter=50, step_size=0.5, batch_size=256)
    for b in (256, 65536):
        report(card, f'{cell} SVI B={b}', 'step',
               lambda bb=b: m.fit_svi(x, key=6, maxiter=100, step_size=0.5,
                                      batch_size=bb, init_state=st),
               100, 'estep_tc')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--units', type=int, default=5)
    ap.add_argument('--engines-only', action='store_true',
                    help="only the cells of chip_smoke.py phase 17")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_port: needs a CUDA device')
    dev = torch.device('cuda:0')
    u = args.units
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)

    # the GMM cells: the data of bench.py:90-98
    kg = torch.Generator(device=dev).manual_seed(0)
    mu = torch.randn((3, 2), generator=kg, device=dev) * 4.0
    lm = torch.eye(2, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3], N_GMM)
    engine_cells(card, dev, x, u)
    if args.engines_only:
        return
    for label, kw, maps in (
            ('DP-GMM', dict(gating='dp', psi_scale=0.5),
             ('estep_tc', 'gibbs_tc', 'predict_kernel')),
            ('diag GMM', dict(gating='dirichlet', diag=True),
             ('estep_tc', 'gibbs_tc', 'diag_predict_kernel')),
            ('tied GMM', dict(gating='dp', tied=True, psi_scale=0.5),
             ('estep_tc', 'gibbs_tc', 'predict_kernel')),
            ('tied diag GMM', dict(gating='dirichlet', diag=True, tied=True),
             ('estep_tc', 'gibbs_tc', 'diag_predict_kernel')),
            ('hier GMM', dict(gating='dp', hierarchical=True, psi_scale=0.5,
                              maxsubiter=25),
             ('estep_tc', 'gibbs_tc', 'predict_kernel'))):
        m = BayesianGMM.make(size=K, dim=2, kappa=0.05, device=dev, **kw)
        st, _ = m.fit_vi_fused(x, key=1, maxiter=20)
        report(card, f'{label} N={N_GMM}', 'VI sweep',
               lambda: m.fit_vi_fused(x, maxiter=u, init_state=st,
                                      randomize=False), u, maps[0])
        report(card, f'{label} N={N_GMM}', 'Gibbs sweep',
               lambda: m.fit_gibbs_fused(x, key=2, maxiter=u), u, maps[1])
        report(card, f'{label} N={N_GMM}', 'predict call',
               lambda: m.log_predictive(st, x), 1, maps[2])
    del x
    torch.cuda.empty_cache()

    # the ILR q8 fit cell (bench.py:313-336): Gibbs then VI from it
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((N_Q8, 8), generator=g, device=dev) * 6 - 3
    w = torch.randn((8, 1), generator=g, device=dev)
    y = torch.sin(x @ w) + 0.1 * torch.randn((N_Q8, 1), generator=g,
                                             device=dev)
    m = BayesianILR.make(size=K, input_dim=8, output_dim=1, alpha=2.0,
                         kappa=0.05, device=dev)
    gs = m.fit_gibbs_fused((x, y), key=2, maxiter=20)
    st, _ = m.fit_vi_fused((x, y), key=1, maxiter=20, randomize=False,
                           init_state=MFState(gs.components, gs.gating))
    report(card, f'ILR q8 N={N_Q8} d=8 p=1', 'VI sweep',
           lambda: m.fit_vi_fused((x, y), maxiter=u, init_state=st,
                                  randomize=False), u, 'estep_tc')
    report(card, f'ILR q8 N={N_Q8} d=8 p=1', 'Gibbs sweep',
           lambda: m.fit_gibbs_fused((x, y), key=2, maxiter=u), u, 'gibbs_tc')
    del x, y, m, st, gs
    torch.cuda.empty_cache()

    # the ILR serving cells of chip_smoke.py phases 9 and 12, MNW and MNG
    # experts: the sine flagship (Gibbs 10 -> VI 20) and p>1 serving
    # (VI 20), one predict call each (weights, moments and NLPD)
    for diag in (False, True):
        for n, d, p in ((N_SINE, 1, 1), (N_P3, 2, 3)):
            x, y = serving_data(torch.Generator(device=dev).manual_seed(5),
                                n, d, p, dev)
            m = BayesianILR.make(size=K, input_dim=d, output_dim=p,
                                 alpha=2.0, kappa=0.05 if p == 1 else 0.1,
                                 diag=diag, device=dev)
            m.init_transform(x, y)
            init = None
            if p == 1:
                gs = m.fit_gibbs_fused((x, y), key=0, maxiter=10)
                init = MFState(gs.components, gs.gating)
            st, _ = m.fit_vi_fused((x, y), key=1, maxiter=20,
                                   randomize=init is None, init_state=init)
            cell = (f'ILR {"sine" if p == 1 else "p>1"}'
                    f'{", MNG experts" if diag else ""} N={n} d={d} p={p}')
            report(card, cell, 'predict call', lambda: m.predict(st, x, y), 1,
                   'ilr_predict_kernel' if p == 1 else 'ilr_p_predict_kernel')
            del x, y, m, st
            torch.cuda.empty_cache()

    # the tied-activation ILR cells
    for n, d, p in ((N_SINE, 1, 1), (N_P3, 2, 3)):
        x, y = serving_data(torch.Generator(device=dev).manual_seed(7), n, d,
                            p, dev)
        kw = (dict(alpha=5.0, kappa=0.05, maxsubiter=10) if p == 1
              else dict(alpha=2.0, kappa=0.1))
        m = BayesianILR.make(size=K, input_dim=d, output_dim=p,
                             tied_affine=True, hier_basis=True, device=dev,
                             **kw)
        m.init_transform(x, y)
        gs = m.fit_gibbs_fused((x[:10_000], y[:10_000]), key=0, maxiter=60)
        st, _ = m.fit_vi_fused((x, y), key=1, maxiter=20, randomize=False,
                               init_state=MFState(gs.components, gs.gating))
        cell = f'hilr {"sine" if p == 1 else "p>1"} N={n} d={d} p={p}'
        report(card, cell, 'VI sweep',
               lambda: m.fit_vi_fused((x, y), maxiter=u, init_state=st,
                                      randomize=False), u, 'estep_tc')
        report(card, cell, 'Gibbs sweep',
               lambda: m.fit_gibbs_fused((x, y), key=2, maxiter=u), u,
               'gibbs_tc')
        report(card, cell, 'predict call', lambda: m.predict(st, x, y), 1,
               'ilr_predict_kernel' if p == 1 else 'ilr_p_predict_kernel')
        del x, y, m, st, gs
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
