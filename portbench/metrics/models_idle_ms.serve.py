"""Device idle ms a request of the spans segment while the innermost open
span of the port is a model's (mimo.models.predictive_parts: the
predictive glue)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, 'serve', 'models')
