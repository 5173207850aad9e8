"""Points x chains x sweeps of the window's fit calls over its elapsed seconds."""

from harness.readers import rate


def read(ctx):
    return rate(ctx, 'fit')
