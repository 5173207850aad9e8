"""The arithmetic the metric readers share (metrics/<name>.py are each a
line over these). Each returns None where its cell gives it nothing to
read: another traffic kind, another kernel, or no traced device event."""

import statistics


def rate(ctx, kind):
    """Work units (points) of the window over its elapsed seconds."""
    if ctx.kind != kind:
        return None
    return ctx.window.points / ctx.window.elapsed


def p95_ms(ctx):
    """The 95th percentile of every request's latency in the window."""
    lat = ctx.window.latencies
    if ctx.kind != 'serve' or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method='inclusive')[18] * 1e3


def _traced(ctx, kind):
    return ctx.trace is not None and ctx.kind == kind


def bound_s(ctx, macs, nbytes):
    """The least time the card could take: the larger of the products at
    the TF32 peak and the bytes at the HBM bandwidth."""
    return max(2.0 * macs / ctx.peaks['tf32_flop_per_s'],
               nbytes / ctx.peaks['hbm_byte_per_s'])


def roofline(ctx, kernel):
    """The kernel's share (%) of its bound: the work the algorithm needs
    for the traced calls over the kernel's device time."""
    if ctx.trace is None or ctx.traffic['kernel'] != kernel:
        return None
    macs, nbytes, work = ctx.work()
    seconds = ctx.trace.kernel_s(work.KERNELS)
    if seconds <= 0.0:
        return None
    return 100.0 * bound_s(ctx, macs, nbytes) / seconds


def mfu(ctx, kind):
    """The traced calls' algorithmic FLOPs over the traced wall time at
    the TF32 peak (%)."""
    if not _traced(ctx, kind):
        return None
    macs, _, _ = ctx.work()
    return (100.0 * 2.0 * macs
            / (ctx.trace.window_s * ctx.peaks['tf32_flop_per_s']))


def idle(ctx, kind):
    """1 - device busy / traced wall time (%)."""
    if not _traced(ctx, kind):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def ops_per_unit(ctx, kind):
    """Device events a sweep (fit) or a request (serve)."""
    if not _traced(ctx, kind):
        return None
    return ctx.trace.ops / ctx.segment.units


def other_ms_per_unit(ctx, kind):
    """Device ms a unit in events other than the traffic's kernel."""
    if not _traced(ctx, kind):
        return None
    _, _, work = ctx.work()
    other = ctx.trace.device_s - ctx.trace.kernel_s(work.KERNELS)
    return 1e3 * other / ctx.segment.units
