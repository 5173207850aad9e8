"""Metrics / observability (port of mimo_tpu/utils/logging.py): host-side
JSONL logging, wall-clock timing of a block, a torch.profiler hook, and
the port's layer spans.

Every fit already returns its metric traces as tensors; this module adds
durable logging and profiling. The records and their keys are the JAX
package's.

Spans. `span(layer, name)` marks a block of the port's host work as
`mimo.<layer>.<name>`: the layers are models (`fit_chains`, the
predictive glue), engines (a whole engine call and each sweep), algebra
(the K-sized posterior algebra) and wrappers (the host side of kernels
B1-B3). Off by default, a span is one shared null context and costs a
flag check; inside `spans()` (and `profile`) it is a
torch.profiler.record_function range, which a profiler session records
as a `user_annotation` event on the same timeline as the card's events.
Only `mimo.algebra.hyper` (distributions/hierarchical.py) opens inside
torch.func.vmap's mapped function, where chains batch the update: the
range takes no tensor, so vmap runs it once a call, as it runs the
function's Python.
"""

import json
import os
import time
from contextlib import contextmanager, nullcontext
from functools import wraps

from torch.profiler import record_function

_spans_on = False
_OFF = nullcontext()


class MetricsLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path):
        self.path = path
        self._t0 = time.time()

    def log(self, step=None, **metrics):
        rec = {'t': round(time.time() - self._t0, 4)}
        if step is not None:
            rec['step'] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        return rec

    def log_trace(self, name, trace, every=1):
        """One record a step of a trace (a tensor, array or list), every
        `every` steps; a tensor on the card is copied to the host once."""
        import numpy as np
        if hasattr(trace, 'detach'):
            trace = trace.detach().cpu().numpy()
        arr = np.asarray(trace)
        for i in range(0, arr.shape[0], every):
            self.log(step=i, **{name: arr[i]})


@contextmanager
def timed(label, logger=None):
    """Wall-clock a block; logs/prints '<label>: <dt>s'. Work queued on a
    CUDA card is not waited for: synchronise inside the block to time it."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    if logger is not None:
        logger.log(**{f'{label}_seconds': dt})
    else:
        print(f'{label}: {dt:.3f}s')


def span(layer, name, arg=None):
    """The range `mimo.<layer>.<name>` (with `arg`, e.g. a sweep index, as
    its argument) while spans are on; the shared null context otherwise."""
    if not _spans_on:
        return _OFF
    return record_function(f'mimo.{layer}.{name}',
                           None if arg is None else str(arg))


def spanned(layer, name=None):
    """Decorate a function so that each call is the span `mimo.<layer>.
    <name>`, by default the function's name."""
    def wrap(fn):
        label = name or fn.__name__

        @wraps(fn)
        def call(*args, **kw):
            with span(layer, label):
                return fn(*args, **kw)
        return call
    return wrap


@contextmanager
def spans():
    """Turn the layer spans on for a block; the previous setting comes
    back on exit."""
    global _spans_on
    before, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = before


@contextmanager
def profile(logdir):
    """torch.profiler trace of the host and, where there is one, the CUDA
    card around a block, with the layer spans on; on exit the trace is
    written to `<logdir>/trace.json` (chrome://tracing, Perfetto). Yields
    the profiler, whose `key_averages()` sums the time by operation."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, spans():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
