"""Device ops a sweep of the spans segment's fit calls launched while the
innermost open span of the port is the hierarchical family's inner rounds
(mimo.algebra.hyper); None where the port has no such span."""

from harness.spans import segment

SPAN = 'mimo.algebra.hyper'


def read(ctx):
    s = segment(ctx) if ctx.kind == 'fit' else None
    if s is None or not s.units or (SPAN not in s.idle
                                    and SPAN not in s.ops):
        return None
    return s.ops.get(SPAN, 0) / s.units
