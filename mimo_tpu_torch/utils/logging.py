"""Metrics / observability (port of mimo_tpu/utils/logging.py): host-side
JSONL logging, wall-clock timing of a block, and a torch.profiler hook.

Every fit already returns its metric traces as tensors; this module adds
durable logging and profiling. The records and their keys are the JAX
package's.
"""

import json
import os
import time
from contextlib import contextmanager


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


@contextmanager
def profile(logdir):
    """torch.profiler trace of the host and, where there is one, the CUDA
    card around a block; on exit the trace is written to
    `<logdir>/trace.json` (chrome://tracing, Perfetto). Yields the
    profiler, whose `key_averages()` sums the time by operation."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
