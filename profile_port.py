#!/usr/bin/env python3
"""Where the time goes in the port's cells on one CUDA card.

    python3 profile_port.py [--units U] [--engines-only | --nested-only
                                         | --nested-probes | --chains
                                         | --stream | --mesh
                                         | --stream-mesh | --fed]

For each cell it fits the model at the size `chip_smoke.py` drives,
warms up, then measures one unit of work (a warm-started VI sweep, a
Gibbs sweep, one serving call, a sweep of a 50-sweep MAP-EM or ML-EM fit
with its init, a dense VI sweep or an SVI step; `--engines-only` runs
just the last three, the cells of `chip_smoke.py` phase 17;
`--nested-only` just the nested mixtures of phase 18): the wall time
per unit (median of 3
un-profiled runs of U units, synchronised), and under `torch.profiler`
the device time per unit, split into the named kernel and the other
device ops (their count and time). The idle share is 1 - device busy /
wall: how far the host holds the card back. Prints one line per cell
and engine, with the card's name and power limit first.

`--nested-probes` runs the measurements behind the nested model's design
instead (see `nested_probes`); `--chains` the chains of `chip_smoke.py`
phase 19 (see `chain_cells`); `--stream` the streamed sweeps of its phase
20 (see `stream_cells`); `--mesh` the sharded sweeps and serving of its
phase 21 (see `mesh_cells`); `--stream-mesh` the streamed and dense
sweeps over a mesh of its phase 22 (see `stream_mesh_cells`); `--fed`
the DP-GMM sweeps of its phase 27 through the streamed layout (see
`fed_cells`).
"""

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch
from torch.func import vmap
from torch.profiler import ProfilerActivity, profile

import mimo_tpu_torch  # noqa: F401  (sets the float32 precision policy)
from mimo_tpu_torch.distributions.niw import GaussParams
from mimo_tpu_torch.io import MmapDataset, stage, stream, write_bin
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models.hmix import HMixState
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.parallel import fit_chains, make_mesh, shard_data
from mimo_tpu_torch.utils.tree import tree_map

from chip_smoke import (
    N_NEST, N_NEST_ILR_FIT, N_NEST_MAP, fed_data, nested_blobs)

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


def fed_cells(card, dev, u):
    """The DP-GMM cells of chip_smoke.py phase 27 past the kernels' plain
    layout, on bench.py:90-98's data: N=1e6 at K=256, d=32 and K=128,
    d=16, a warm-started VI sweep and a Gibbs sweep after 20 VI sweeps.
    B1's share is that of its two streamed passes (estep_st_*), then of
    each apart; B2's that of gibbs_st_*, then of its label pass."""
    for n, k, d in ((1_000_000, 256, 32), (1_000_000, 128, 16)):
        x, _ = fed_data(torch.Generator(device=dev).manual_seed(27), n, d,
                        dev)
        m = BayesianGMM.make(size=k, dim=d, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
        st, _ = m.fit_vi_fused(x, key=1, maxiter=20)
        cell = f'fed DP-GMM N={n} K={k} d={d}'
        for kernel in ('estep_st', 'estep_st_logits', 'estep_st_stats'):
            report(card, cell, 'VI sweep',
                   lambda: m.fit_vi_fused(x, maxiter=u, init_state=st,
                                          randomize=False), u, kernel)
        for kernel in ('gibbs_st', 'gibbs_st_logits'):
            report(card, cell, 'Gibbs sweep',
                   lambda: m.fit_gibbs_fused(x, key=2, maxiter=u), u, kernel)
        del x, m, st
        torch.cuda.empty_cache()


def nested_cells(card, dev, u):
    """The cells of chip_smoke.py phase 18: the nested GMM (M=4, K=8,
    d=2) at N=1e6, plain and hierarchical (a VI sweep of a 50- or 20-sweep
    fit from the random start, a Gibbs sweep, a log_predictive call), its
    MAP-EM and ML-EM at N=1e7 (a sweep of a 20-sweep fit, init
    included), and the nested ILR sine's predict call (M=2, K=6, N=1e7,
    dense Gibbs 30 on the first 2e5 points)."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = nested_blobs(g, N_NEST, dev)
    for hier, sweeps in ((False, 50), (True, 20)):
        m = BayesianMixtureOfMixtures.make_gmm(
            4, 8, 2, hierarchical=hier, kappa=0.5, psi_scale=0.5,
            maxsubiter=5, device=dev)
        cell = f'nested {"hier " if hier else ""}GMM N={N_NEST} M=4 K=8'
        st, _ = m.fit_vi_fused(x, key=0, maxiter=sweeps)
        report(card, cell, f'VI sweep ({sweeps}-sweep fit)',
               lambda: m.fit_vi_fused(x, key=0, maxiter=sweeps), sweeps,
               'estep_tc')
        report(card, cell, 'Gibbs sweep',
               lambda: m.fit_gibbs_fused(x, key=2, maxiter=u), u, 'gibbs_tc')
        report(card, cell, 'predict call', lambda: m.log_predictive(st, x),
               1, 'predict_kernel')
    del x
    x = nested_blobs(g, N_NEST_MAP, dev)
    m = BayesianMixtureOfMixtures.make_gmm(
        4, 8, 2, hierarchical=False, kappa=0.5, psi_scale=0.5, device=dev)
    cell = f'nested GMM N={N_NEST_MAP} M=4 K=8'
    report(card, cell, 'MAP-EM sweep (20-sweep fit)',
           lambda: m.fit_map_fused(x, key=3, maxiter=20), 20, 'estep_tc')
    report(card, cell, 'ML-EM sweep (20-sweep fit)',
           lambda: m.fit_em_fused(x, key=3, maxiter=20), 20, 'estep_tc')
    del x, m
    torch.cuda.empty_cache()
    x, y = serving_data(torch.Generator(device=dev).manual_seed(5), N_SINE,
                        1, 1, dev)
    m = BayesianMixtureOfMixtures.make_ilr(2, 6, 1, 1, kappa=0.05,
                                           device=dev)
    m.init_transform(x[:200_000], y[:200_000])
    st = gibbs_state(m.fit_gibbs((x[:200_000], y[:200_000]), key=2,
                                 maxiter=30))
    report(card, f'nested ILR sine N={N_SINE} M=2 K=6', 'predict call',
           lambda: m.predict(st, x, y, dist='studentt'), 1,
           'ilr_predict_kernel')
    del x, y, m, st
    torch.cuda.empty_cache()


def top_device_ops(fn, count=3):
    """The `count` device ops that took the most time in one run of fn():
    [(name, ms, calls)], and the device busy time in ms."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda o: -o[1])
    return ops[:count], sum(o[1] for o in ops)


def gibbs_state(gs):
    """The HMixState of a nested Gibbs state (its labels dropped)."""
    return HMixState(gs.outer_gating, gs.inner_gating, gs.components)


def nested_probes(card, dev):
    """The measurements behind the nested model's design. (1) The
    per-cluster statistics of the nested MAP-EM cell's random start
    (N=1e7, M=4, K=8, d=2, random two-level weights) three ways: vmapped
    over M (one batched (K, N) x (N, m) matmul), a loop of M calls, and
    `_cluster_stats`' one call over flat (N, M*K) weights: wall time of
    one call and its top device ops. (2) A MAP-EM sweep of a 20-sweep fit
    (its random start included) with the statistics vmapped and as
    shipped. (3) The nested ILR sine (M=2, K=6, N=1e7, fitted on the
    first 2e5 points) by bench.py:400-420's dense VI 30 sweeps of 2 inner
    rounds, dense VI 100 of 5 and dense Gibbs 30: the RMSE of predict over
    all points."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = nested_blobs(g, N_NEST_MAP, dev)
    mm, kk, n = 4, 8, N_NEST_MAP
    m = BayesianMixtureOfMixtures.make_gmm(
        mm, kk, 2, hierarchical=False, kappa=0.5, psi_scale=0.5, device=dev)
    fam, data = m.family, (x,)
    inner = torch.softmax(torch.randn((mm, n, kk), generator=g, device=dev),
                          -1)
    outer = torch.softmax(torch.randn((n, mm), generator=g, device=dev), -1)

    def vmapped(data, inner_w, outer_w):
        w = inner_w * outer_w.T[:, :, None]
        return (vmap(lambda ww: fam.suff_stats(data, ww))(w),
                torch.sum(w, 1))

    ways = (('vmapped over M', lambda: vmapped(data, inner, outer)),
            ('a loop of M calls', lambda: [
                fam.suff_stats(data, inner[i] * outer[:, i:i + 1])
                for i in range(mm)]),
            ('one call over flat (N, M*K) weights',
             lambda: m._cluster_stats(data, inner, outer)))
    cell = f'nested GMM N={n} M={mm} K={kk} d=2'
    for name, fn in ways:
        fn()                                    # warm
        wall = wall_ms(fn, 1)
        top, busy = top_device_ops(fn)
        ops = '; '.join(f'{k[:60]} {t:.6g} ms x{c}' for k, t, c in top)
        print(f'{cell} statistics, {name} ({card}): wall {wall:.6g} ms; '
              f'device busy {busy:.6g} ms; top device ops: {ops}',
              flush=True)
    del inner, outer
    m._cluster_stats = vmapped
    report(card, cell, 'MAP-EM sweep (20-sweep fit), statistics vmapped',
           lambda: m.fit_map_fused(x, key=3, maxiter=20), 20, 'estep_tc')
    del m._cluster_stats
    report(card, cell, 'MAP-EM sweep (20-sweep fit), statistics flat',
           lambda: m.fit_map_fused(x, key=3, maxiter=20), 20, 'estep_tc')
    del x, m
    torch.cuda.empty_cache()

    x, y = serving_data(torch.Generator(device=dev).manual_seed(5), N_SINE,
                        1, 1, dev)
    head = (x[:N_NEST_ILR_FIT], y[:N_NEST_ILR_FIT])
    m = BayesianMixtureOfMixtures.make_ilr(2, 6, 1, 1, kappa=0.05,
                                           device=dev)
    m.init_transform(*head)
    for name, fit in (
            ('dense fit_vi 30, 2 inner rounds (bench.py:400-420)',
             lambda: m.fit_vi(head, key=2, maxiter=30, maxsubiter=2)[0]),
            ('dense fit_vi 100, 5 inner rounds',
             lambda: m.fit_vi(head, key=2, maxiter=100, maxsubiter=5)[0]),
            ('dense fit_gibbs 30, 2 inner rounds', lambda: gibbs_state(
                m.fit_gibbs(head, key=2, maxiter=30, maxsubiter=2)))):
        mu = m.predict(fit(), x, y, dist='studentt')[0]
        rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
        print(f'nested ILR sine N={N_SINE} M=2 K=6, {name} on the first '
              f'{N_NEST_ILR_FIT} ({card}): RMSE {rmse:.6g} over all points',
              flush=True)
    del x, y, m
    torch.cuda.empty_cache()


def chain_cells(card, dev, x, u):
    """The chains of chip_smoke.py phase 19 (fit_chains: one launch of B1
    or B2 a sweep for all C chains): a warm-started VI sweep of one fit
    against a VI sweep of C chains at bench.py:421-439's cell (the first
    1e5 points, K=16, C=16) and at the main cell (N=1e7, K=50, C=8), and a
    Gibbs sweep of one fit against C=8 chains at the main cell. Each cell
    also runs one chain through fit_chains: the same engine code as the
    one fit, its K-sized algebra under torch.func.vmap at C=1, so the two
    rows price vmap's host cost."""
    for n, k, c in ((100_000, 16, 16), (N_GMM, K, 8)):
        xs = x[:n]
        m = BayesianGMM.make(size=k, dim=2, gating='dp', kappa=0.05,
                             psi_scale=0.5, device=dev)
        keys = list(range(1, c + 1))
        st1, _ = m.fit_vi_fused(xs, key=1, maxiter=20)
        stc, _ = fit_chains(m, 'fit_vi_fused', xs, keys, maxiter=20)
        cell = f'DP-GMM N={n} K={k}'
        report(card, cell, 'VI sweep, one fit',
               lambda: m.fit_vi_fused(xs, maxiter=u, init_state=st1,
                                      randomize=False), u, 'estep_tc')
        st1c = tree_map(lambda a: a[None], st1)
        report(card, cell, 'VI sweep of 1 chain (vmap at C=1)',
               lambda: fit_chains(m, 'fit_vi_fused', xs, [1], maxiter=u,
                                  init_state=st1c, randomize=False), u,
               'estep_tc')
        report(card, cell, f'VI sweep of {c} chains',
               lambda: fit_chains(m, 'fit_vi_fused', xs, keys, maxiter=u,
                                  init_state=stc, randomize=False), u,
               'estep_tc')
        if n == N_GMM:
            report(card, cell, 'Gibbs sweep, one fit',
                   lambda: m.fit_gibbs_fused(xs, key=2, maxiter=u), u,
                   'gibbs_tc')
            report(card, cell, f'Gibbs sweep of {c} chains',
                   lambda: fit_chains(m, 'fit_gibbs_fused', xs, keys,
                                      maxiter=u), u, 'gibbs_tc')
        del m, st1, st1c, stc
        torch.cuda.empty_cache()


def mesh_cells(card, dev, x, u):
    """The sharded sweeps of chip_smoke.py phase 21 at the main cell
    (N=1e7, K=50): a warm-started VI sweep, a Gibbs sweep and one
    log_predictive call, unsharded and over a (1, 4) mesh of four
    positions on this card (B1, B2 or B3 once a shard, one reduction a
    sweep)."""
    m = BayesianGMM.make(size=K, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    mesh = make_mesh(devices=[dev] * 4)
    xs = shard_data(mesh, x)
    st, _ = m.fit_vi_fused(x, key=1, maxiter=20)
    cell = f'DP-GMM N={N_GMM}'
    for label, data, kw in (('one launch', x, {}),
                            ('(1, 4) mesh', xs, dict(mesh=mesh))):
        report(card, cell, f'VI sweep, {label}',
               lambda: m.fit_vi_fused(data, maxiter=u, init_state=st,
                                      randomize=False, **kw), u, 'estep_tc')
        report(card, cell, f'Gibbs sweep, {label}',
               lambda: m.fit_gibbs_fused(data, key=2, maxiter=u, **kw), u,
               'gibbs_tc')
        report(card, cell, f'predict, {label}',
               lambda: m.log_predictive(st, data, **kw), 1,
               'predict_kernel')


def stream_mesh_cells(card, dev, x, u):
    """The sweeps of chip_smoke.py phase 22, unsharded and over a (1, 4)
    mesh of four positions on this card: the streamed VI sweep over all
    1e7 points in blocks of 2^20 from a file (B1 once a block, or once a
    shard of each block), the streamed SVI step at B=65536 over the first
    2e6 points, and the dense VI and Gibbs sweeps on the first 1e6 points
    (no kernel: their device time is all other ops)."""
    import numpy as np
    m = BayesianGMM.make(size=K, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    mesh = make_mesh(devices=[dev] * 4)
    path = os.path.join(tempfile.gettempdir(),
                        f'profile_port_mesh_{os.getpid()}.bin')
    b = 1 << 20
    try:
        write_bin(path, x.cpu().numpy())
        ds = MmapDataset(path)
        nb = -(-N_GMM // b)
        st, _ = m.fit_vi_fused(x, key=1, maxiter=20)
        for label, kw in (('one position', {}), ('(1, 4) mesh',
                                                 dict(mesh=mesh))):
            report(card, f'stream N={N_GMM} B={b} ({nb} blocks)',
                   f'VI sweep, {label}',
                   lambda: m.fit_vi_stream_full(
                       lambda i: ds.read_block(i * b, b), nb, init_state=st,
                       maxiter=u, **kw), u, 'estep_tc')
        for label, mm in (('one position', make_mesh(devices=[dev])),
                          ('(1, 4) mesh', mesh)):
            def svi(mm=mm):
                rng = np.random.default_rng(0)
                return m.fit_svi_stream(
                    lambda i: ds.read_block(
                        int(rng.integers(0, 2_000_000 - 65536)), 65536),
                    2_000_000, init_state=st, maxiter=16 * u, step_size=0.5,
                    batch_size=65536, group=16, mesh=mm)
            report(card, 'SVI-stream N=2000000 B=65536',
                   f'step, {label}', svi, 16 * u, 'estep_tc')
        ds.close()
    finally:
        if os.path.exists(path):
            os.unlink(path)
    x1 = x[:1_000_000]
    xs1 = shard_data(mesh, x1)
    sv, _ = m.fit_vi(x1, key=1, maxiter=5)
    for label, data, kw in (('unsharded', x1, {}),
                            ('(1, 4) mesh', xs1, dict(mesh=mesh))):
        report(card, 'DP-GMM N=1000000 (dense)', f'fit_vi sweep, {label}',
               lambda: m.fit_vi(data, maxiter=u, init_state=sv,
                                randomize=False, **kw), u, 'estep_tc')
        report(card, 'DP-GMM N=1000000 (dense)', f'fit_gibbs sweep, {label}',
               lambda: m.fit_gibbs(data, key=2, maxiter=u, **kw), u,
               'gibbs_tc')


def trace_events(fn):
    """The device events of one run of fn() from the profiler's chrome
    trace: {'kernel': [(start, end, name)], 'h2d': [(start, end)]} in
    microseconds (a profiling window that records no kernel is retried)."""
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.unlink(path)
        out = {'kernel': [], 'h2d': []}
        for e in events:
            if e.get('ph') != 'X':
                continue
            span = (float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
            if e.get('cat') == 'kernel':
                out['kernel'].append(span + (e.get('name', ''),))
            elif e.get('cat') == 'gpu_memcpy' and 'HtoD' in e.get('name', ''):
                out['h2d'].append(span)
        if out['kernel']:
            return out
    raise SystemExit('profile_port: the profiler saw no device time')


def covered(spans, by):
    """Total length of `spans` that lies inside the union of `by`."""
    union = []
    for a, b in sorted(by):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    return sum(max(0.0, min(b, v) - max(a, u))
               for a, b in spans for u, v in union)


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def stream_cells(card, dev, x, u):
    """The streamed sweeps of chip_smoke.py phase 20: cell (b), the first
    2e6 points of the GMM data in 4 blocks of 5e5, and cell (c), all 1e7
    in blocks of 2^20, fit_vi_stream_full warm-started from an in-memory
    VI fit. Per sweep: the wall time (median of 3 runs of U sweeps)
    beside the in-memory sweep's; under the profiler B1's device time and
    launches, the host-to-device bytes and copy time, and the share of
    the copy time that overlaps a kernel (on the compute stream); on the
    host clock the reader's time a block in read_block (file to numpy),
    in waiting for a free pinned buffer and in filling it (the numpy copy
    and the cast), and the main thread's time a sweep waiting for the
    reader."""
    reads, fills, waits, gets, stagers = [], [], [], [], []
    fill, acquire, init = (stage.Stager.fill, stage.Stager._acquire,
                           stage.Stager.__init__)
    get = stream.Prefetcher.get

    def timed_get(self):
        t0 = time.perf_counter()
        try:
            return get(self)
        finally:
            gets.append(time.perf_counter() - t0)

    def timed_fill(self, chunks):
        t0 = time.perf_counter()
        out = fill(self, chunks)
        fills.append(time.perf_counter() - t0 - self._waited)
        return out

    def timed_acquire(self):
        t0 = time.perf_counter()
        out = acquire(self)
        self._waited = time.perf_counter() - t0
        waits.append(self._waited)
        return out

    def kept_init(self, *a, **kw):
        init(self, *a, **kw)
        stagers.append(self)

    stage.Stager.fill, stage.Stager._acquire = timed_fill, timed_acquire
    stage.Stager.__init__ = kept_init
    stream.Prefetcher.get = timed_get
    m = BayesianGMM.make(size=K, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    path = os.path.join(tempfile.gettempdir(),
                        f'profile_port_{os.getpid()}.bin')
    try:
        for n, b in ((2_000_000, 500_000), (N_GMM, 1 << 20)):
            xs = x[:n]
            write_bin(path, xs.cpu().numpy())
            ds = MmapDataset(path)
            nb = -(-n // b)

            def rb(i):
                t0 = time.perf_counter()
                out = ds.read_block(i * b, b)
                reads.append(time.perf_counter() - t0)
                return out

            st, _ = m.fit_vi_fused(xs, key=1, maxiter=20)

            def streamed():
                return m.fit_vi_stream_full(rb, nb, init_state=st,
                                            maxiter=u)

            streamed()                                    # warm
            wall = wall_ms(streamed, u)
            mem = wall_ms(lambda: m.fit_vi_fused(
                xs, maxiter=u, init_state=st, randomize=False), u)
            for t in (reads, fills, waits, gets):
                t.clear()
            n0 = len(stagers)
            streamed()
            h2d_bytes = sum(s.h2d_bytes for s in stagers[n0:]) / u
            wait_ms = 1e3 * sum(gets) / u
            host = [1e3 * statistics.median(t) for t in (reads, waits, fills)]
            ev = trace_events(streamed)
            b1 = [k for k in ev['kernel'] if 'estep_tc' in k[2]]
            kern_ms = sum(k[1] - k[0] for k in ev['kernel']) / 1e3 / u
            b1_ms = sum(k[1] - k[0] for k in b1) / 1e3 / u
            copy_ms = sum(e[1] - e[0] for e in ev['h2d']) / 1e3 / u
            hidden = covered(ev['h2d'], [k[:2] for k in ev['kernel']])
            share = hidden / 1e3 / u / copy_ms if copy_ms else 0.0
            spans = [k[:2] for k in ev['kernel']] + ev['h2d']
            busy_ms = covered([(min(a for a, _ in spans),
                                max(b for _, b in spans))], spans) / 1e3 / u
            print(f'stream N={n} B={b} ({nb} blocks), per sweep ({card}): '
                  f'wall {wall:.6g} ms (in memory {mem:.6g} ms); B1 '
                  f'{b1_ms:.6g} ms device in {len(b1) / u:.4g} launches; all '
                  f'kernels {kern_ms:.6g} ms; host-to-device '
                  f'{h2d_bytes / 1e6:.6g} MB in {copy_ms:.6g} ms '
                  f'({h2d_bytes / copy_ms / 1e6 if copy_ms else 0:.6g} '
                  f'GB/s), share of the copy under a kernel {share:.3f}; '
                  f'device busy (kernels or copies) {busy_ms:.6g} ms, idle '
                  f'share {max(0.0, 1 - busy_ms / wall):.3f}; reader a block '
                  f'(median): read_block {host[0]:.6g} ms, waiting for a '
                  f'pinned buffer {host[1]:.6g} ms, pinned fill '
                  f'{host[2]:.6g} ms; main thread waiting for the reader '
                  f'{wait_ms:.6g} ms a sweep', flush=True)
            # the same host work alone on the main thread, for contrast
            arr = ds.read_block(0, b)
            pinned = torch.empty(arr.shape, pin_memory=True)
            alone = [1e3 * statistics.median(
                timed(fn) for _ in range(5)) for fn in (
                    lambda: ds.read_block(0, b),
                    lambda: pinned.copy_(torch.from_numpy(arr)))]
            print(f'stream N={n} B={b}: alone on the main thread, read_block '
                  f'{alone[0]:.6g} ms, numpy -> pinned copy {alone[1]:.6g} '
                  f'ms ({arr.nbytes / 1e6:.6g} MB; torch threads '
                  f'{torch.get_num_threads()})', flush=True)
            ds.close()
            del st, xs
            torch.cuda.empty_cache()
    finally:
        stage.Stager.fill, stage.Stager._acquire = fill, acquire
        stage.Stager.__init__ = init
        stream.Prefetcher.get = get
        if os.path.exists(path):
            os.unlink(path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--units', type=int, default=5)
    only = ap.add_mutually_exclusive_group()
    only.add_argument('--engines-only', action='store_true',
                      help="only the cells of chip_smoke.py phase 17")
    only.add_argument('--nested-only', action='store_true',
                      help="only the cells of chip_smoke.py phase 18")
    only.add_argument('--nested-probes', action='store_true',
                      help="the measurements behind the nested model's "
                           "design (see nested_probes)")
    only.add_argument('--chains', action='store_true',
                      help="only the chains of chip_smoke.py phase 19")
    only.add_argument('--stream', action='store_true',
                      help="only the streamed sweeps of chip_smoke.py "
                           "phase 20")
    only.add_argument('--mesh', action='store_true',
                      help="only the sharded sweeps of chip_smoke.py "
                           "phase 21")
    only.add_argument('--stream-mesh', action='store_true',
                      help="only the streamed and dense sweeps over a "
                           "mesh of chip_smoke.py phase 22")
    only.add_argument('--fed', action='store_true',
                      help="only the DP-GMM sweeps of chip_smoke.py phase "
                           "27 (the streamed layout)")
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
    if args.nested_only:
        nested_cells(card, dev, u)
        return
    if args.nested_probes:
        nested_probes(card, dev)
        return
    if args.fed:
        fed_cells(card, dev, u)
        return

    # the GMM cells: the data of bench.py:90-98
    kg = torch.Generator(device=dev).manual_seed(0)
    mu = torch.randn((3, 2), generator=kg, device=dev) * 4.0
    lm = torch.eye(2, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3], N_GMM)
    if args.chains:
        chain_cells(card, dev, x, u)
        return
    if args.stream:
        stream_cells(card, dev, x, u)
        return
    if args.mesh:
        mesh_cells(card, dev, x, u)
        return
    if args.stream_mesh:
        stream_mesh_cells(card, dev, x, u)
        return
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
