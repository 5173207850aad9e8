"""The port's own layer spans, read from one more profiled segment.

After the harness's traced segment, the first reader of a span metric
runs one more segment of whole calls (at least SECONDS and CALLS, outputs
not kept) under torch.profiler with the port's spans on
(mimo_tpu_torch.utils.logging.spans): each of the port's layers marks its
host work as a `mimo.<layer>.<name>` range on the same timeline as the
card's events. Inside the benchmark's own `portbench.*` window:

  idle  each interval in which the card runs nothing goes to the
        innermost `mimo.` span open while it lasts, split wherever a span
        opens or closes; what no span covers goes to REMAINDER;
  ops   each device event goes to the innermost span open at its launch
        (the `cuda_runtime` or `cuda_driver` event of the same
        `args.correlation`);
  layouts  the change of ops/cuda_predict.layouts over the segment.

The result is cached on the reader's Context, so every span metric reads
one segment. A port without spans (no `spans` in its logging module) or a
segment without a `mimo.` span gives every reader None."""

import bisect
import importlib
import json
import sys
import time
from typing import NamedTuple, Optional

from harness import trace, traffic
from harness.port import import_port

SECONDS = 1.0             # the segment's least length
CALLS = 2                 # and its least number of calls
PREFIX = 'mimo.'          # the port's spans
REMAINDER = '(no span)'   # idle or ops under no span of the port
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


class Spans(NamedTuple):
    wall_s: float          # the portbench.* window of the segment
    busy_s: float          # union of device events inside it
    idle: dict             # innermost span name (or REMAINDER) -> seconds
    ops: dict              # innermost span at launch (or REMAINDER) -> ops
    spans: int             # mimo. spans that overlap the window
    units: int = 0         # sweeps or requests the segment ran
    layouts: Optional[dict] = None   # cuda_predict.layouts' change

    def layer_idle_s(self, layer):
        return sum(t for name, t in self.idle.items()
                   if name.startswith(f'{PREFIX}{layer}.'))

    def layer_ops(self, layer):
        return sum(n for name, n in self.ops.items()
                   if name.startswith(f'{PREFIX}{layer}.'))

    def closure(self):
        """(idle attributed, spans and remainder) - (1 - busy / wall), as
        a share of the window: 0 when no idle is lost or counted twice."""
        return sum(self.idle.values()) / self.wall_s - (
            1.0 - self.busy_s / self.wall_s)


def _x(events, cats):
    return [e for e in events if e.get('ph') == 'X' and e.get('cat') in cats]


def _interval(e):
    a = float(e['ts'])
    return a, a + float(e.get('dur', 0))


def innermost(spans, lo, hi):
    """The innermost span over [lo, hi] as consecutive pieces (a, b,
    name or None): spans (start, end, name), the innermost the latest
    started of those open (the shorter on a tie)."""
    cuts = sorted({lo, hi} | {t for a, b, _ in spans for t in (a, b)
                              if lo < t < hi})
    order = sorted(spans)
    pieces, active, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(order) and order[k][0] <= a:
            active.append(order[k])
            k += 1
        active = [s for s in active if s[1] > a]
        top = max(active, key=lambda s: (s[0], -s[1]), default=None)
        pieces.append((a, b, None if top is None else top[2]))
    return pieces


def attribute(events, window_prefix='portbench.', prefix=PREFIX):
    """Spans of chrome-trace events (ts, dur in microseconds), or None
    when the window holds no device event."""
    notes = _x(events, ('user_annotation',))
    window = [_interval(e) for e in notes
              if e.get('name', '').startswith(window_prefix)]
    if not window:
        return None
    lo, hi = min(a for a, _ in window), max(b for _, b in window)
    dev = []
    for e in _x(events, trace.DEVICE_CATS):
        a, b = _interval(e)
        if min(hi, b) > max(lo, a):
            dev.append((max(lo, a), min(hi, b), e))
    if not dev:
        return None
    spans = [_interval(e) + (e['name'],) for e in notes
             if e.get('name', '').startswith(prefix)]
    spans = [s for s in spans if s[1] > lo and s[0] < hi]
    pieces = innermost(spans, lo, hi)
    busy = trace.union([(a, b) for a, b, _ in dev])
    idle, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    by_idle, j = {}, 0
    for a, b in idle:
        while pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            pa, pb, name = pieces[k]
            t = min(b, pb) - max(a, pa)
            if t > 0:
                key = name or REMAINDER
                by_idle[key] = by_idle.get(key, 0.0) + t * 1e-6
            k += 1
    launch = {}
    for e in _x(events, LAUNCH_CATS):
        c = (e.get('args') or {}).get('correlation')
        if c is not None:
            launch[c] = float(e['ts'])
    starts = [p[0] for p in pieces]
    by_ops = {}
    for _, _, e in dev:
        t = launch.get((e.get('args') or {}).get('correlation'))
        name = None
        if t is not None and lo <= t <= hi:
            name = pieces[max(0, bisect.bisect_right(starts, t) - 1)][2]
        key = name or REMAINDER
        by_ops[key] = by_ops.get(key, 0) + 1
    return Spans(wall_s=(hi - lo) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 idle=by_idle, ops=by_ops, spans=len(spans))


def _log(msg):
    print(f'portbench: spans: {msg}', file=sys.stderr, flush=True)


def port_hooks():
    """(the port's logging module, its cuda_predict.layouts or None), or
    None when the port has no spans."""
    import_port()
    logging = importlib.import_module('mimo_tpu_torch.utils.logging')
    if not hasattr(logging, 'spans'):
        return None
    predict = importlib.import_module('mimo_tpu_torch.ops.cuda_predict')
    return logging, getattr(predict, 'layouts', None)


def run_segment(drv, sync, first, hooks):
    """One profiled segment of whole calls from call `first` with the
    port's spans on: its Spans, or None after two sessions without a
    device event or a span."""
    logging, layouts = hooks
    for attempt in (1, 2):
        before = dict(layouts) if layouts is not None else None
        t0 = time.perf_counter()
        with logging.spans():
            seg, events = trace.profile(lambda: traffic.run(
                drv, SECONDS, sync, first=first, min_calls=CALLS,
                keep=False, spans=True))
        export_s = time.perf_counter() - t0 - seg.elapsed
        found = attribute(events)
        if found is not None and found.spans:
            change = (None if before is None else
                      {k: layouts[k] - before.get(k, 0) for k in layouts})
            _log(f'segment {seg.elapsed:.4f} s, {seg.calls} calls, '
                 f'profiler stop and export {export_s:.4f} s')
            return found._replace(units=seg.units, layouts=change)
        _log(f'session {attempt}: no device event or no {PREFIX} span')
        first += seg.calls
    return None


def segment(ctx):
    """The Spans of ctx's cell, from one more segment after the harness's
    traced one (run once a Context), or None: no traced device event, a
    port without spans, or none recorded."""
    if hasattr(ctx, '_port_spans'):
        return ctx._port_spans
    ctx._port_spans = None
    if ctx.trace is None or ctx.segment is None:
        return None
    hooks = port_hooks()
    if hooks is None:
        _log('the port has no layer spans')
        return None
    drv = ctx._drv
    found = run_segment(drv, traffic.synchronizer(drv.device),
                        ctx.segment.first + ctx.segment.calls, hooks)
    if found is not None:
        report(found, ctx.trace)
    ctx._port_spans = found
    return found


def report(s, own):
    """The segment's idle by span, its closure, and the harness's own
    segment beside it, on standard error."""
    top = sorted(s.idle.items(), key=lambda kv: -kv[1])
    _log(json.dumps({
        'wall_s': s.wall_s, 'busy_s': s.busy_s,
        'idle_share': 1.0 - s.busy_s / s.wall_s, 'closure': s.closure(),
        'units': s.units, 'spans': s.spans, 'layouts': s.layouts,
        'own_segment': {'wall_s': own.window_s, 'busy_s': own.busy_s,
                        'idle_share': 1.0 - own.busy_s / own.window_s},
        'idle_ms_by_span': {k: 1e3 * v for k, v in top},
        'ops_by_span': dict(sorted(s.ops.items(), key=lambda kv: -kv[1]))}))


def idle_ms_per_unit(ctx, kind, layer):
    """Device idle ms a sweep (fit) or request (serve) under `layer`'s
    spans, innermost."""
    s = segment(ctx) if ctx.kind == kind else None
    if s is None or not s.units:
        return None
    return 1e3 * s.layer_idle_s(layer) / s.units


def ops_per_unit(ctx, kind, layer):
    """Device ops a unit launched under `layer`'s spans, innermost."""
    s = segment(ctx) if ctx.kind == kind else None
    if s is None or not s.units:
        return None
    return s.layer_ops(layer) / s.units


def layout_builds_per_unit(ctx, kind):
    """cached_layout's builds a unit in the segment."""
    s = segment(ctx) if ctx.kind == kind else None
    if s is None or not s.units or s.layouts is None:
        return None
    return s.layouts.get('built', 0) / s.units
