"""The 95th percentile of every request's latency in the window (ms)."""

from harness.readers import p95_ms


def read(ctx):
    return p95_ms(ctx)
