"""B3's share of its algorithmic bound in the traced requests (%)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, 'b3')
