"""The run's surroundings: cache directories inside the checkout, the card
check, the device record and the check that no JAX module was loaded."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / 'portbench'
CACHE = ROOT / 'build' / 'portbench'

# top-level module names the process must not hold once the window has
# closed: JAX, its libraries and the JAX package (compared whole, so the
# port, mimo_tpu_torch, is not one of them)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mimo_tpu')


def set_cache_dirs():
    """Fixed cache directories inside the checkout for every compiler a
    run could reach (the port's nvcc library has its own fixed
    build/mimo_tpu_torch)."""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_modules(modules=None):
    """The top-level names in `modules` (default sys.modules) that are
    forbidden, each compared whole."""
    names = {name.split('.', 1)[0] for name in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


class NoCard(RuntimeError):
    pass


def require_cards(chips):
    """Raise NoCard unless torch sees at least `chips` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard('no CUDA device: the benchmark measures the port on '
                     'an NVIDIA card and never falls back to the CPU')
    if torch.cuda.device_count() < chips:
        raise NoCard(f'the cell needs {chips} CUDA devices, '
                     f'{torch.cuda.device_count()} present')


def power_limit_w(index=0):
    """The card's power limit in watts from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--id={index}', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(device, chips):
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': chips,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device)),
            'power_limit_w': power_limit_w(device.index or 0)}
