"""Device idle ms a request of the spans segment while the innermost open
span of the port is kernel B3's wrapper (mimo.wrappers.b3)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, 'serve', 'wrappers')
