"""One run of one cell: set up, measure whole calls for `seconds`, trace a
short segment (with --trace 1), check the window's outputs against the
reference, print the result line."""

import argparse
import json
import math
import sys
import time

import torch

from harness import cells, checks, env, gen, trace, traffic

TRACE_SECONDS = 1.0        # the traced segment's least length
TRACE_CALLS = 2            # and its least number of calls


class Context:
    """What a metric reader sees (metrics/<name>.py read(ctx))."""

    def __init__(self, cell, drv, window, setup_s, segment, summary, peaks):
        self.cell, self.traffic = cell, cell.traffic
        self.kind = cell.traffic['kind']
        self.window, self.setup_s = window, setup_s
        self.trace, self.segment, self.peaks = summary, segment, peaks
        self.shape = drv.shape()
        self._drv = drv

    def work(self):
        """(MACs, bytes) the algorithm needs for the traced segment's calls,
        from work/<kernel>.py, and that module."""
        w = cells.work_count(self.traffic['kernel'], self.cell.bench)
        macs = nbytes = 0.0
        seg = self.segment
        for i in range(seg.first, seg.first + seg.calls):
            shape = dict(self.shape)
            if self.kind == 'serve':
                shape['n'] = self._drv.points(i)
            m, b = w.count(shape)
            macs += m * self._drv.units(i)
            nbytes += b * self._drv.units(i)
        return macs, nbytes, w


def device_for(chips):
    env.require_cards(chips)
    return torch.device('cuda', 0)


def read_metrics(entries, ctx):
    out = {}
    for m in entries:
        value = cells.metric_reader(m['name'], ctx.cell.bench)(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def traced_segment(drv, sync, first, log):
    """Profile whole calls after the window; one retry when the profiler
    records no device event. Returns (segment Window, Trace or None)."""
    for attempt in (1, 2):
        seg, events = trace.profile(lambda: traffic.run(
            drv, TRACE_SECONDS, sync, first=first, min_calls=TRACE_CALLS,
            keep=False, spans=True))
        summary = trace.summarize(events)
        if summary is not None:
            return seg, summary
        log(f'portbench: profiler session {attempt} recorded no device '
            'event')
        first += seg.calls
    log('portbench: no device event in two profiler sessions: the traced '
        'metrics are left out')
    return seg, None


def set_up(cell, seed, device):
    """The cell's traffic driver: the cell's model adapter loaded (the
    first import of the port), the fit data from the seed, the model
    built over it, the traffic's set-up."""
    adapter = cells.adapter(cell.config['model'], cell.bench)
    data = adapter.data(cell.config, seed, device)
    model = adapter.make(cell.config, data, device)
    return traffic.driver(cell, adapter, model, data, seed, device)


def run_cell(workload, seed, seconds, trace_on, device, t_start,
             spec=None, bench=env.BENCH, log=None, control=False):
    """Run one cell on `device`. Returns (result dict, check rows). With
    `control`, the numbers are the control's (the reference in the
    control's precision in the port's place), for calibration."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = cells.find_cell(workload, spec, bench)
    sync = traffic.synchronizer(device)
    if device.type == 'cuda':
        sync()                       # the context exists before the reset
        torch.cuda.reset_peak_memory_stats(device)
    drv = set_up(cell, seed, device)
    drv.warm()
    sync()
    setup_s = time.perf_counter() - t_start
    window = traffic.run(drv, seconds, sync)
    lat = sorted(window.latencies)
    log(f'portbench: window {window.elapsed:.3f} s, {window.calls} calls, '
        f'latency min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max '
        f'{lat[-1]:.4f} s')
    if window.calls <= 64:
        log('portbench: call latencies (s) '
            + ' '.join(f'{t:.3f}' for t in window.latencies))
    segment, summary = None, None
    if trace_on:
        segment, summary = traced_segment(drv, sync, window.calls, log)
    sync()
    record = env.device_record(device, cell.chips)
    ctx = Context(cell, drv, window, setup_s, segment, summary,
                  cells.peaks(bench))
    metrics = read_metrics(cell.per_layer if trace_on else cell.end_to_end,
                           ctx)
    if summary is not None:
        record['busy_s'] = summary.busy_s
        record['window_s'] = summary.window_s
    failed = checks.finite_outputs(drv)
    del drv.model
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    found = drv.numbers(control, gen.generator(seed, device, 'control'))
    ok, rows = checks.judge(found, cell.limits)
    result = {'correct': bool(ok and failed == 0), 'attempted': window.calls,
              'failed': failed, 'metrics': metrics, 'device': record}
    if summary is not None:
        result['breakdown'] = summary.breakdown()
    result['checks'] = {name: {'value': number(value), 'limit': limit}
                        for name, value, limit in rows}
    return result, rows


def number(v):
    """v, or None where it is missing or not finite (JSON has no NaN)."""
    return v if v is not None and math.isfinite(v) else None


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find_cell(args.workload)
    try:
        device = device_for(cell.chips)
    except env.NoCard as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 2
    result, rows = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, t_start)
    bad = env.forbidden_modules()
    if bad:
        print('portbench: the process holds forbidden modules: '
              + ', '.join(bad), file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f'check {name} {number(value)!r} limit {limit!r}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
