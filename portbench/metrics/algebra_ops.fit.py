"""Device ops a sweep of the spans segment's fit calls launched while the
innermost open span of the port is one of its K-sized algebra's
(mimo.algebra.*)."""

from harness.spans import ops_per_unit


def read(ctx):
    return ops_per_unit(ctx, 'fit', 'algebra')
