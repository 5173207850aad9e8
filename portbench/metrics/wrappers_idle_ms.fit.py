"""Device idle ms a sweep of the spans segment's fit calls while the
innermost open span of the port is a kernel wrapper's (mimo.wrappers.b1,
.b2: host preparation, launch, reduction)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, 'fit', 'wrappers')
