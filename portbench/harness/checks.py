"""Whether what the timed path produced is correct. The cell's model
adapter (adapters/<model>.py, `numbers`) holds the port's outputs kept
from the window against the plain reference, worked out again from the
benchmark's own inputs, or, for calibration, gives the control's
numbers; limits/<workload>.json gives each number its limit. The run is
correct when every kept output is finite and every number is finite and
within its limit."""

import torch


def finite_outputs(drv):
    """How many kept outputs hold a non-finite value."""
    bad = 0
    for k in drv.sampler.kept():
        out = k['out']
        leaves = (out.values() if isinstance(out, dict)
                  else out if isinstance(out, tuple) else [out])
        bad += any(t.is_floating_point() and not bool(torch.isfinite(t).all())
                   for t in leaves)
    return bad


def judge(found, limits):
    """(correct, [(name, value, limit)]): every limit's number present,
    finite and at most its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = found.get(name)
        good = (value is not None and value == value
                and abs(value) != float('inf') and value <= limit)
        ok &= good
        rows.append((name, value, limit))
    return ok, rows
