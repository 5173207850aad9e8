"""Shared plumbing of the example drivers (the counterpart of
examples/_common.py): the command line, the device and dtype it selects,
and the figure's file. No compile cache: nothing is traced."""

import argparse
import os

import torch

from mimo_tpu_torch.models.mixture import model_device


def setup(description, argv=None, **extra):
    """Parse `argv` (sys.argv[1:] when None) for --seed, --plot, --cpu,
    --x64 and the driver's `extra` flags (name -> (type, default, help);
    a bool type is a switch). Returns (args, device): the card unless
    --cpu (raises without a card); `args.dtype` is float64 under --x64,
    else float32. Under --plot, matplotlib must import."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--seed', type=int, default=1337)
    parser.add_argument('--plot', action='store_true',
                        help='save a PNG into the working directory '
                             '(needs matplotlib)')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the CUDA card')
    parser.add_argument('--x64', action='store_true',
                        help='float64 instead of float32')
    for name, (typ, default, hlp) in extra.items():
        if typ is bool:
            parser.add_argument(f'--{name}', action='store_true',
                                default=default, help=hlp)
        else:
            parser.add_argument(f'--{name}', type=typ, default=default,
                                help=hlp)
    args = parser.parse_args(argv)
    if args.plot:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError('--plot needs matplotlib, which is not '
                              'installed; run without --plot') from e
        matplotlib.use('Agg')
    args.dtype = torch.float64 if args.x64 else torch.float32
    return args, model_device('cpu' if args.cpu else None)


def check(cond, msg):
    """A driver's own check: raise RuntimeError(msg) unless `cond`."""
    if not cond:
        raise RuntimeError(msg)


def generator(args, device):
    """A torch.Generator on `device` seeded by --seed, where the JAX
    driver draws from jax.random.PRNGKey(seed)."""
    return torch.Generator(device=device).manual_seed(args.seed)


def chain_keys(seed, count):
    """`count` int64 chain keys drawn from --seed on the host (the JAX
    driver's jax.random.split(key, count))."""
    return torch.randint(0, 2 ** 62, (count,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(seed))


def maybe_save_plot(args, name):
    """Under --plot, save the current figure as <name>.png in the working
    directory."""
    if not args.plot:
        return
    import matplotlib.pyplot as plt
    out = os.path.abspath(f'{name}.png')
    plt.savefig(out, dpi=120, bbox_inches='tight')
    plt.close('all')
    print(f'saved {out}')
