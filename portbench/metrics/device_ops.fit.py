"""Device operations a sweep in the traced fit calls."""

from harness.readers import ops_per_unit


def read(ctx):
    return ops_per_unit(ctx, 'fit')
