"""Device idle ms a request of the spans segment while the innermost open
span of the port is one of its K-sized algebra's
(mimo.algebra.coefficients)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, 'serve', 'algebra')
