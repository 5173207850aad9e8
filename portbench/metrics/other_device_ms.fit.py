"""Device ms a sweep outside the fit kernel (B1 or B2)."""

from harness.readers import other_ms_per_unit


def read(ctx):
    return other_ms_per_unit(ctx, 'fit')
