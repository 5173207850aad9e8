"""The traced segment: torch.profiler over a few whole calls after the
window, its chrome trace written under $TMPDIR and read back. The
arithmetic is profile_port.py's: device busy is the union of the device
events (kernels, copies, sets) inside the segment, idle = 1 - busy /
segment, kernel time by name."""

import bisect
import json
import os
import re
import tempfile
from typing import NamedTuple

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Trace(NamedTuple):
    window_s: float        # first span start to last span end
    busy_s: float          # union of device events inside the window
    device_s: float        # sum of device event durations inside it
    ops: int               # device events inside it
    by_name: dict          # device event name -> seconds
    gaps: dict             # host activity during idle gaps -> seconds

    def kernel_s(self, pattern):
        """Seconds of device events whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(t for name, t in self.by_name.items() if rx.search(name))

    def breakdown(self, top=10):
        def best(d):
            return [[name[:160], seconds] for name, seconds in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': best(self.by_name), 'idle_gaps': best(self.gaps)}


def union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_at(host, starts, t, reach=4096):
    """The innermost host op running at time t: of the ops (start, end,
    name) sorted by start, the latest started that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][1] >= t:
            return host[j][2]
    return 'host (no op)'


def summarize(events, span_prefix='portbench.'):
    """A Trace from chrome-trace events (ts, dur in microseconds), or None
    when the segment holds no device event."""
    spans = [e for e in events if e.get('ph') == 'X'
             and e.get('cat') == 'user_annotation'
             and e.get('name', '').startswith(span_prefix)]
    dev = [e for e in events if e.get('ph') == 'X'
           and e.get('cat') in DEVICE_CATS]
    if not spans or not dev:
        return None
    lo = min(float(e['ts']) for e in spans)
    hi = max(float(e['ts']) + float(e.get('dur', 0)) for e in spans)
    clipped, by_name = [], {}
    for e in dev:
        a = max(lo, float(e['ts']))
        b = min(hi, float(e['ts']) + float(e.get('dur', 0)))
        if b <= a:
            continue
        clipped.append((a, b))
        name = e.get('name', '?')
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    if not clipped:
        return None
    busy = union(clipped)
    host = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
                   e.get('name', '?')) for e in events
                  if e.get('ph') == 'X' and e.get('cat') == 'cpu_op')
    starts = [h[0] for h in host]
    gaps, prev = {}, lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            name = host_at(host, starts, 0.5 * (a + prev))
            gaps[name] = gaps.get(name, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    return Trace(window_s=(hi - lo) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device_s=sum(by_name.values()), ops=len(clipped),
                 by_name=by_name, gaps=gaps)


def profile(fn):
    """Run fn() under torch.profiler (CPU and CUDA activity) and return
    (fn's result, its chrome-trace events). The trace file is written
    under $TMPDIR and removed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        result = fn()
    fd, path = tempfile.mkstemp(suffix='.json', prefix='portbench_trace_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    return result, events
