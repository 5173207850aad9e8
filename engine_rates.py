#!/usr/bin/env python3
"""Time the unsharded dense engines and the streamed VI sweep of one
checkout of mimo_tpu_torch on one CUDA card, and the host's cost of
issuing kernel B1 over one and four mesh positions.

    python3 engine_rates.py [--tree DIR] [--label NAME] [--host-cost]

mimo_tpu_torch is imported from DIR (default: this script's directory),
so that two checkouts, for example a parent commit unpacked with
`git archive` into build/ and this one, can be timed on the same card
one after the other (parent, change, change, parent). On
`chip_smoke.py`'s phase 6 data (seed 0, N=1e7, K=50, d=2):

  * fit_vi, fit_map, fit_em and fit_gibbs, 20 sweeps on the first 1e6
    points (phase 17's cut): sweeps per second of a whole fit, its start
    included, the median of 5 synchronised runs after a warm-up;
  * fit_vi_stream_full over all 1e7 points written to a file in the temp
    directory (deleted at the end) in blocks of 2^20, 5 sweeps from an
    in-memory VI state: ms a sweep, the median of 5 runs;
  * with --host-cost (a checkout with `ops.cuda_estep.BlockEStep`): the host's
    time to issue one B1 launch on a 262,144-point column view of a
    staged 2^20-point block (1000 launches, then the same with the
    device's time), and one streamed sweep's E-step over 10 such blocks
    (ops.cuda_estep.BlockEStep: begin, add a block, end) over one and
    over four positions of a mesh on the card.

Prints the card's name and power limit (nvidia-smi), then one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N, N_DENSE, K, BLOCK = 10_000_000, 1_000_000, 50, 1 << 20


def median_seconds(torch, fn, reps):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def host_cost(torch, model, x, dev):
    """(us to issue a B1 launch, us a launch with the device, {positions:
    (ms to issue a 10-block E-step, ms with the device)})."""
    from mimo_tpu_torch.ops import cuda_estep
    from mimo_tpu_torch.ops.cuda_estep import BlockEStep, kernel_xts
    from mimo_tpu_torch.parallel import make_mesh
    buf = kernel_xts((x[:BLOCK],))
    spec = model._estep_spec()
    st = model.fit_vi_fused(x, key=1, maxiter=3)[0]
    theta, _ = cuda_estep.pad_theta(spec.theta(st.components),
                                    st.gating.expected_log_pi(),
                                    torch.float32)
    s = BLOCK // 4
    view = buf[0][:, s:2 * s]
    for _ in range(20):
        cuda_estep.estep_packed(view, theta, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        cuda_estep.estep_packed(view, theta, s)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launch = (1e6 * (t1 - t0) / 1000, 1e6 * (t2 - t0) / 1000)
    sweeps = {}
    for npos in (1, 4):
        estep = BlockEStep(spec, True, 131072, torch.float32,
                            make_mesh(devices=[dev] * npos))
        w = BLOCK // npos
        shards = [(None, tuple(t[:, j * w:(j + 1) * w] for t in buf), w)
                  for j in range(npos)]

        def sweep():
            estep.begin(st.components, st.gating.expected_log_pi())
            for _ in range(10):
                estep.add(shards)
            return estep.end()

        for _ in range(5):
            sweep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            sweep()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sweeps[npos] = (1e3 * (t1 - t0) / 50, 1e3 * (t2 - t0) / 50)
    return launch, sweeps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parent))
    ap.add_argument('--label', default='this checkout')
    ap.add_argument('--host-cost', action='store_true')
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit('engine_rates: needs a CUDA device')
    import mimo_tpu_torch
    if not mimo_tpu_torch.__file__.startswith(str(Path(args.tree).resolve())):
        raise SystemExit(f'engine_rates: imported {mimo_tpu_torch.__file__}'
                         f', not the package under {args.tree}')
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.io import MmapDataset, write_bin
    from mimo_tpu_torch.models import BayesianGMM

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    dev = torch.device('cuda:0')
    kg = torch.Generator(device=dev).manual_seed(0)
    mu = torch.randn((3, 2), generator=kg, device=dev) * 4.0
    lm = torch.eye(2, device=dev).expand(3, 2, 2) * 2.0
    x = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3], N)[0]
    model = BayesianGMM.make(size=K, dim=2, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    x1 = x[:N_DENSE]
    out = {'label': args.label, 'card': card}
    for name, key in (('fit_vi', 1), ('fit_map', 1), ('fit_em', 0),
                      ('fit_gibbs', 2)):
        fit = getattr(model, name)
        out[f'{name}_it_s'] = 20 / median_seconds(
            torch, lambda: fit(x1, key=key, maxiter=20), 5)
    fd, path = tempfile.mkstemp(suffix='.bin')
    os.close(fd)
    try:
        write_bin(path, x.cpu().numpy())
        ds = MmapDataset(path)
        nb = -(-N // BLOCK)
        st = model.fit_vi_fused(x, key=1, maxiter=20)[0]
        out['stream_vi_ms_a_sweep'] = 1e3 * median_seconds(
            torch, lambda: model.fit_vi_stream_full(
                lambda i: ds.read_block(i * BLOCK, BLOCK), nb,
                init_state=st, maxiter=5), 5) / 5
        ds.close()
    finally:
        os.unlink(path)
    if args.host_cost:
        launch, sweeps = host_cost(torch, model, x, dev)
        out['b1_issue_us'], out['b1_with_device_us'] = launch
        for npos, (issue, total) in sweeps.items():
            out[f'estep_10_blocks_{npos}_positions_issue_ms'] = issue
            out[f'estep_10_blocks_{npos}_positions_ms'] = total
    print(json.dumps(out))


if __name__ == '__main__':
    main()
