"""Query points scored in the window over its elapsed seconds."""

from harness.readers import rate


def read(ctx):
    return rate(ctx, 'serve')
