#!/usr/bin/env python3
"""Readings behind the limits of limits/<workload>.json, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,...
        [--control-seeds 21,22,23] [--fault mode_draws] [--seconds 1]
        [--out FILE]

In one process, runs the cell once a seed as run.py would (a short
window at the cell's own load) and prints each run's compared numbers:
the port's (the lower readings) and, for each control seed, the
control's (the reference in TF32 put in the port's place: the upper
readings). With --fault, the port runs with that fault planted (one
of the FAULTS of the cell's model adapter, on the kernels' path), for
the upper reading of a number that the control does not move.

One JSON line a run, also appended to FILE. The benchmark's own runs do
not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import env  # noqa: E402

env.set_cache_dirs()

from harness import cells, main  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(',') if s]


def run(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=seeds, required=True)
    ap.add_argument('--control-seeds', type=seeds, default=[])
    ap.add_argument('--fault', help="one of the cell's adapter's FAULTS")
    ap.add_argument('--seconds', type=float, default=1.0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    cell = cells.find_cell(args.workload)
    faults = cells.adapter(cell.config['model'], cell.bench).FAULTS
    if args.fault and args.fault not in faults:
        ap.error(f'--fault: one of {sorted(faults)}')
    device = main.device_for(1)
    if args.fault:
        faults[args.fault]()      # planted for the rest of the process
    runs = [(s, False) for s in args.seeds] + [(s, True)
                                               for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        result, _ = main.run_cell(args.workload, seed, args.seconds, False,
                                  device, t0, control=control)
        line = json.dumps({
            'workload': args.workload, 'seed': seed,
            'side': 'control' if control else args.fault or 'port',
            'correct': result['correct'], 'attempted': result['attempted'],
            'numbers': {k: v['value'] for k, v in result['checks'].items()},
            'metrics': result['metrics'], 'device': result['device'],
            'seconds': time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(run())
