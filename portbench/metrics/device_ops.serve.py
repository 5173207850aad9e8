"""Device operations a request in the traced requests."""

from harness.readers import ops_per_unit


def read(ctx):
    return ops_per_unit(ctx, 'serve')
