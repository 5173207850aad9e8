"""The traced fit calls' algorithmic FLOPs over their wall time at the TF32 peak (%)."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx, 'fit')
