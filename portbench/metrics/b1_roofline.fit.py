"""B1's share of its algorithmic bound in the traced fit calls (%)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, 'b1')
