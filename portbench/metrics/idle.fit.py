"""The card's idle share of the traced fit calls (%)."""

from harness.readers import idle


def read(ctx):
    return idle(ctx, 'fit')
