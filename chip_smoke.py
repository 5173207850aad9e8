#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed S]

Phases, one or more printed lines each:
  1. card     nvidia-smi's name and power limit, torch and CUDA versions;
  2. build    nvcc builds mimo_tpu_torch/csrc/*.cu into build/ (first use);
  3. B1       the fused E-step kernel against its plain PyTorch version at
              N=1,000,003, K=50, d=2 (and d=3, K=7, N=1000), run twice
              and required bitwise equal;
  4. B2       the Gibbs label-sweep kernel: labels in range, statistics
              equal to the one-hot sums of its own labels, labels equal to
              the plain Philox draw for draw, label frequencies at 4 points
              within 5 sigma of the softmax;
  5. B3       the predictive-density kernel against its plain version,
              Student-t and Gaussian;
  6. main     the DP-GMM main path at N=1e7, K=50, d=2 through the
              public entry points (fit_vi_fused, fit_gibbs_fused,
              log_predictive), with the kernels' launch counts, a kernel-
              vs-plain check of the engines on a 100,003-point slice, the
              rates, and each kernel's time beside its plain version's.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or if any check
fails, the script exits non-zero and prints no result.
"""

import argparse
import json
import math
import re
import statistics
import subprocess
import time

import torch

import mimo_tpu_torch  # noqa: F401  (sets the float32 precision policy)
from mimo_tpu_torch.distributions.gating import StickBreaking
from mimo_tpu_torch.distributions.niw import GaussParams, NIW, mode_params
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.models.mixture import kernel_xts
from mimo_tpu_torch.ops import _build, cuda_estep, cuda_gibbs, cuda_predict
from mimo_tpu_torch.ops.cuda_estep import assemble_features, pad_theta
from mimo_tpu_torch.ops.family_estep import gaussian_spec

N_MAIN, K_MAIN, D_MAIN = 10_000_000, 50, 2
N_CHECK = 1_000_003            # a ragged tail for the 128-point tiles


def fail(msg):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(cond, msg):
    if not cond:
        fail(msg)


def allclose_report(got, want, rtol, atol):
    """(ok, max |got - want|) under |got - want| <= atol + rtol |want|."""
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, by CUDA events, after
    two warm-up runs."""
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


def random_posterior(gen, k, d, dev):
    """A random NIW posterior with the scales of a fit at N ~ 1e6."""
    a = torch.randn((k, d, d), generator=gen, device=dev)
    psi = (a @ a.transpose(-1, -2) / d + torch.eye(d, device=dev)) * 2e-4
    return NIW(mu=torch.randn((k, d), generator=gen, device=dev) * 4.0,
               kappa=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev),
               psi=psi,
               nu=d + 2.0 + 1e5 * torch.rand((k,), generator=gen, device=dev))


def ptxas_summary(log):
    """'file.cu kernel: R regs, S B spilled' for each kernel in nvcc's
    -Xptxas -v output."""
    out, name, spill = [], None, '?'
    for line in log.splitlines():
        m = re.search(r"entry function '.*?_([a-z]+)_cu_.*?\d+([a-z_]+)E",
                      line)
        if m:
            name = f'{m.group(1)}.cu {m.group(2)}'
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and name:
            spill = m.group(1)
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out.append(f'{name}: {m.group(1)} regs, {spill} B spilled')
            name, spill = None, '?'
    return '; '.join(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a card')
    torch.cuda.set_device(0)
    run(torch.device('cuda:0'), args.seed, N_MAIN, N_CHECK)


def run(dev, seed, n_main, n_check):
    spec = gaussian_spec()

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'card: torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} device(s) visible')

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    print(f'build: {time.perf_counter() - t0:.3f} s to load, nvcc '
          f'{lib.build_seconds:.3f} s, {lib.path}')
    if lib.log:
        print(f'build: ptxas {ptxas_summary(lib.log)}')

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {}

    # -- 3. B1 vs plain -----------------------------------------------------
    for n, k, d in ((n_check, K_MAIN, D_MAIN), (1000, 7, 3)):
        post = random_posterior(gen, k, d, dev)
        sb = StickBreaking(
            gamma=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev),
            delta=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev))
        log_pi = sb.expected_log_pi()
        xt = (torch.randn((d, n), generator=gen, device=dev) * 4.0
              + post.mu[0][:, None])
        theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
        acc, lse = cuda_estep.estep(xt, theta, n)
        acc2, lse2 = cuda_estep.estep(xt, theta, n)
        pacc, plse = cuda_estep.estep_plain(xt, theta, n)
        torch.cuda.synchronize()
        atol = 1e-3 * n / 1e6
        ok_s, err_s = allclose_report(acc, pacc, 1e-4, atol)
        ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
        bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
        print(f'B1 N={n} K={k} d={d}: stats max|err| {err_s:.6g} '
              f'(rtol 1e-4, atol {atol:.6g}) {"ok" if ok_s else "FAIL"}; '
              f'lse {float(lse):.9g} vs {float(plse):.9g}, |err| '
              f'{err_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}; '
              f'bitwise repeat {bitwise}')
        check(ok_s and ok_l and bitwise, f'B1 disagrees at N={n}')
        if d == D_MAIN:
            errs['B1'] = err_s
            b1_post, b1_log_pi, b1_xt = post, log_pi, xt

    # -- 4. B2 vs plain -----------------------------------------------------
    k, m8 = K_MAIN, 8
    theta, _ = pad_theta(spec.theta_plugin(mode_params(b1_post)), b1_log_pi,
                         torch.float32)
    sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
    labels, acc = cuda_gibbs.gibbs(b1_xt, theta, sweep_seed, n_check)
    plabels, _ = cuda_gibbs.gibbs_plain(b1_xt, theta, sweep_seed, n_check)
    f = assemble_features(b1_xt, m8).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    ref, mag = oh.T @ f.T, oh.T @ f.abs().T
    err = (acc.double() - ref).abs()
    ok_acc = bool((err <= 1e-5 * mag).all())
    in_range = int(labels.min()) >= 0 and int(labels.max()) < k
    mismatch = float((labels != plabels).double().mean())
    errs['B2'] = float(err.max())
    print(f'B2 N={n_check} K={k}: labels in [0, {k}) {in_range}; stats vs '
          f'one-hot sums of its labels max|err| {errs["B2"]:.6g} (<= 1e-5 x '
          f'summed magnitudes) {"ok" if ok_acc else "FAIL"}; label mismatch '
          f'vs plain Philox {mismatch:.3g} (<= 1e-4)')
    check(in_range and ok_acc and mismatch <= 1e-4, 'B2 disagrees')

    # frequencies need overlapping components: unit-scale plug-in params
    wide = GaussParams(
        mu=torch.randn((k, D_MAIN), generator=gen, device=dev),
        lmbda=0.5 * torch.eye(D_MAIN, device=dev).expand(k, D_MAIN, D_MAIN))
    th_f, _ = pad_theta(spec.theta_plugin(wide),
                        torch.full((k,), -math.log(k), device=dev),
                        torch.float32)
    xs = torch.tensor([[0.0, 0.0], [1.0, -1.0], [-0.5, 2.0], [0.3, 0.3]],
                      device=dev)
    reps = 1 << 18                                   # 2^20 points in all
    xf = xs.repeat_interleave(reps, 0).T.contiguous()
    lab, _ = cuda_gibbs.gibbs(xf, th_f, sweep_seed + 1, xf.shape[1])
    probs = torch.softmax(th_f.double() @ assemble_features(
        xs.T.contiguous(), m8).double(), 0).T         # (4, K)
    worst = 0.0
    for i in range(4):
        cnt = torch.bincount(lab[i * reps:(i + 1) * reps].long(),
                             minlength=k).double()
        sigma = torch.sqrt(reps * probs[i] * (1 - probs[i]))
        z = ((cnt - reps * probs[i]).abs() / torch.clamp(sigma, min=1e-12))
        worst = max(worst, float(z[probs[i] * reps >= 1].max()))
        check(bool(((cnt - reps * probs[i]).abs() <= 5 * sigma + 1).all()),
              f'B2 label frequencies at point {i} off the softmax')
    print(f'B2 frequencies: 2^20 draws at 4 points, worst |z| {worst:.3f} '
          f'over components with >= 1 expected draw (bound 5 sigma) ok')

    # -- 5. B3 vs plain -----------------------------------------------------
    log_w = torch.log_softmax(
        torch.randn((k,), generator=gen, device=dev), 0)
    errs['B3'] = 0.0
    for dist in ('studentt', 'gaussian'):
        thq, aux = cuda_predict.predictive_coefficients(
            b1_post, log_w, dist == 'studentt')
        out = cuda_predict.predict(b1_xt, thq, aux, n_check,
                                   dist == 'studentt')
        pout = cuda_predict.predict_plain(b1_xt, thq, aux, n_check,
                                          dist == 'studentt')
        ok, e = allclose_report(out, pout, 1e-5, 1e-4)
        errs['B3'] = max(errs['B3'], e)
        print(f'B3 {dist} N={n_check} K={k}: max|err| {e:.6g} nats '
              f'(rtol 1e-5, atol 1e-4) {"ok" if ok else "FAIL"}; finite '
              f'{bool(torch.isfinite(out).all())}')
        check(ok and bool(torch.isfinite(out).all()), f'B3 {dist} disagrees')

    # -- 6. main path -------------------------------------------------------
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    torch.cuda.synchronize()
    cuda_estep.launches = cuda_gibbs.launches = cuda_predict.launches = 0
    st, vlb = model.fit_vi_fused(x, key=1, maxiter=20)
    gs = model.fit_gibbs_fused(x, key=2, maxiter=20)
    lp = model.log_predictive(st, x)
    torch.cuda.synchronize()
    launches = {'B1': cuda_estep.launches, 'B2': cuda_gibbs.launches,
                'B3': cuda_predict.launches}
    print(f'main N={n_main} K={K_MAIN} d={D_MAIN}: launches {launches}')
    check(launches['B1'] == 20 and launches['B2'] == 20
          and launches['B3'] >= 1, 'the main path bypassed a kernel')

    v = vlb.double()
    rel_drop = float(((v[:-1] - v[1:]) / v[1:].abs()).max())
    print(f'main VI: ELBO {float(v[0]):.9g} -> {float(v[-1]):.9g}, worst '
          f'relative drop {rel_drop:.3g} (<= 1e-4)')
    check(bool(torch.isfinite(v).all()) and rel_drop <= 1e-4,
          'VI ELBO not finite or decreasing')
    leaves = (gs.components.mu, gs.components.psi, gs.components.nu,
              gs.gating.gamma, gs.gating.delta, gs.params.mu,
              gs.params.lmbda, gs.log_pi)
    check(all(bool(torch.isfinite(t).all()) for t in leaves)
          and gs.labels.shape == (n_main,)
          and 0 <= int(gs.labels.min()) and int(gs.labels.max()) < K_MAIN,
          'Gibbs state not finite or labels out of range')
    check(lp.shape == (n_main,) and bool(torch.isfinite(lp).all()),
          'log_predictive not finite')
    w_vi = st.gating.mean()
    top = torch.argsort(w_vi, descending=True)[:3]
    dist_mu = torch.cdist(mu, st.components.mu[top]).min(1).values
    counts = torch.bincount(gs.labels.long(), minlength=K_MAIN)
    print(f'main fit: VI top-3 weights {[round(float(w), 4) for w in w_vi[top]]}'
          f', true means within {float(dist_mu.max()):.4g}; Gibbs components '
          f'with >= 20% of points {int((counts >= 0.2 * n_main).sum())}; '
          f'mean log predictive {float(lp.mean()):.6g}')

    # the engines' kernel path against their plain path on a slice
    xs_ = x[:100_003]
    _, v_k = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    ok_p, e_p = allclose_report(model.log_predictive(st, xs_, backend='kernel'),
                                model.log_predictive(st, xs_, backend='torch'),
                                1e-5, 1e-4)
    print(f'main vs plain on 100,003 points: VI ELBO max|err| {e_v:.6g} '
          f'(rtol 1e-4) {"ok" if ok_v else "FAIL"}; log_predictive max|err| '
          f'{e_p:.6g} (rtol 1e-5, atol 1e-4) {"ok" if ok_p else "FAIL"}')
    check(ok_v and ok_p, 'kernel path disagrees with the plain path')

    # rates (warm: every kernel has run above); host clock around
    # synchronised runs, median of 5 with the range beside it
    def rate(work, fn, reps=5):
        rates = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates.append(work / (time.perf_counter() - t))
        return (f'{statistics.median(rates):.6g} (range {min(rates):.6g}-'
                f'{max(rates):.6g} over {reps} runs)')

    vi = rate(20, lambda: model.fit_vi_fused(x, maxiter=20, init_state=st,
                                             randomize=False))
    gibbs = rate(20, lambda: model.fit_gibbs_fused(x, key=3, maxiter=20))
    pred = rate(n_main, lambda: model.log_predictive(st, x))
    print(f'rates on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: VI {vi} '
          f'it/s (20 warm-started sweeps); Gibbs {gibbs} sweeps/s (20 '
          f'sweeps); predictive {pred} pts/s')

    # each kernel beside its plain version, same inputs, main-path shape
    xt = kernel_xts((x,))[0]
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    thq, aux = cuda_predict.predictive_coefficients(
        st.components, model.predictive_log_weights(st))
    sweep_seed = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = {
        'B1': (lambda: cuda_estep.estep(xt, th_vi, n_main),
               lambda: cuda_estep.estep_plain(xt, th_vi, n_main)),
        'B2': (lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n_main),
               lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n_main)),
        'B3': (lambda: cuda_predict.predict(xt, thq, aux, n_main),
               lambda: cuda_predict.predict_plain(xt, thq, aux, n_main)),
    }
    ms = {}
    for name, (kern, plain) in pairs.items():
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: '
              f'kernel {ms[name][0]:.6g} ms, plain PyTorch {ms[name][1]:.6g}'
              f' ms')

    meta = {
        'B1': ('B1 fused VI E-step', 'mimo_tpu_torch/csrc/estep.cu',
               'mimo_tpu/ops/pallas_estep.py:164'),
        'B2': ('B2 fused Gibbs label sweep', 'mimo_tpu_torch/csrc/gibbs.cu',
               'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B3': ('B3 Student-t mixture predictive',
               'mimo_tpu_torch/csrc/predict.cu',
               'mimo_tpu/ops/pallas_predict.py:39'),
    }
    print(json.dumps({'kernels': [
        {'name': meta[b][0], 'route': 'cuda', 'source': meta[b][1],
         'replaces': meta[b][2], 'launches': launches[b],
         'max_abs_err': errs[b], 'ms': ms[b][0], 'plain_ms': ms[b][1]}
        for b in ('B1', 'B2', 'B3')]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
