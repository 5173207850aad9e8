"""Coefficient layouts B3 built (ops/cuda_predict.layouts 'built') a request
of the spans segment."""

from harness.spans import layout_builds_per_unit


def read(ctx):
    return layout_builds_per_unit(ctx, 'serve')
