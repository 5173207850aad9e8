"""Device idle ms a sweep of the spans segment's fit calls while the
innermost open span of the port is an engine's (mimo.engines.*: set-up,
start and a sweep's own glue)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, 'fit', 'engines')
