"""Process start to the first timed call (s)."""


def read(ctx):
    return ctx.setup_s
