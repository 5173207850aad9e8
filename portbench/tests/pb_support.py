"""What the benchmark's CPU tests share: the import paths, and a copy of
the benchmark's folder with its configurations cut to sizes a test can
hold (the limits, metrics and work counts as committed)."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {'gmm_d2_k50': dict(n=20000, size=8, dim=2),
         'gmm_d32_k256': dict(n=6000, size=12, dim=6)}


def spec():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def small_bench(tmp, dtype='float64', sizes=SMALL):
    """A copy of the benchmark folder under `tmp` whose configurations are
    cut to `sizes` and run in `dtype`; the serving mix scores 2^10-2^13
    points a request from a pool of 2^14."""
    dst = Path(tmp) / 'portbench'
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        'tests', '__pycache__'))
    for name, size in sizes.items():
        path = dst / 'configs' / f'{name}.json'
        c = json.loads(path.read_text())
        c['data']['n'] = size['n']
        c['make']['size'], c['make']['dim'] = size['size'], size['dim']
        c['dtype'] = dtype
        path.write_text(json.dumps(c))
    path = dst / 'traffic' / 'serve_closed.json'
    t = json.loads(path.read_text())
    t.update(pool_log2=14, log2_n=[10, 13], sizes=8)
    path.write_text(json.dumps(t))
    return dst


def run_small(bench, workload, seed=2 ** 33 + 7, seconds=0.2, trace=False,
              control=False):
    import time
    import torch
    from harness import main
    result, _ = main.run_cell(workload, seed, seconds, trace,
                              torch.device('cpu'), time.perf_counter(),
                              spec=spec(), bench=bench, log=lambda m: None,
                              control=control)
    return result
