"""The card's idle share of the traced requests (%)."""

from harness.readers import idle


def read(ctx):
    return idle(ctx, 'serve')
