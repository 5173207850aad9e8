"""The system under test: the port, mimo_tpu_torch, imported from the
checkout. This module and the model adapters (adapters/<model>.py,
which call import_port before they import any part of the port) are the
only modules of the benchmark that import it."""

import importlib

from harness.env import ROOT


def import_port():
    """Import mimo_tpu_torch and make sure it is the checkout's copy."""
    port = importlib.import_module('mimo_tpu_torch')
    path = getattr(port, '__file__', None) or ''
    if not path.startswith(str(ROOT) + '/'):
        raise ImportError(f'mimo_tpu_torch from {path!r}, not from the '
                          f'checkout at {ROOT}')
    return port
