"""Loud non-finite detection for the engines (port of
mimo_tpu/utils/sanitize.py).

Opt-in through the same environment variable as the JAX package, since
the check syncs the host once at the end of a fit:

    MIMO_TPU_CHECK_FINITE=1      warn (RuntimeWarning)
    MIMO_TPU_CHECK_FINITE=raise  raise FloatingPointError
    unset / 0 / off              no check (default)
"""

import os
import warnings

import torch

__all__ = ['finite_report', 'check_mode']


def check_mode():
    v = os.environ.get('MIMO_TPU_CHECK_FINITE', '').lower()
    if v in ('', '0', 'off', 'false'):
        return None
    return 'raise' if v == 'raise' else 'warn'


def _bad_leaves(tree, path=''):
    if hasattr(tree, '_fields'):
        return [b for f in tree._fields
                for b in _bad_leaves(getattr(tree, f), f'{path}.{f}')]
    if isinstance(tree, (tuple, list)):
        return [b for i, t in enumerate(tree)
                for b in _bad_leaves(t, f'{path}[{i}]')]
    if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
            and not bool(torch.isfinite(tree).all())):
        n_bad = int((~torch.isfinite(tree)).sum())
        return [f'{path} ({n_bad}/{tree.numel()} non-finite)']
    return []


def finite_report(result, engine):
    """Check a fit engine's return value (state or (state, trace)) for
    non-finite values when MIMO_TPU_CHECK_FINITE is set. Reports the first
    bad sweep index of the trace (of each chain, for the chains' (C,
    maxiter) traces) and every non-finite state leaf."""
    mode = check_mode()
    if mode is None:
        return result
    state, trace = (result
                    if isinstance(result, tuple) and len(result) == 2
                    and not hasattr(result, '_fields')
                    else (result, None))
    msgs = []
    if trace is not None and trace.dim() == 2:      # (chains, sweeps)
        finite = torch.isfinite(trace)
        bad = [(c, int(torch.argmin(row.to(torch.int8))))
               for c, row in enumerate(finite) if not bool(row.all())]
        if bad:
            msgs.append('trace non-finite in ' + ', '.join(
                f'chain {c} from sweep {s}' for c, s in bad)
                + f' ({int((~finite).sum())}/{finite.numel()} entries)')
    elif trace is not None:
        finite = torch.isfinite(trace.reshape(-1))
        if not bool(finite.all()):
            first = int(torch.argmin(finite.to(torch.int8)))
            msgs.append(f'trace non-finite from sweep {first} '
                        f'({int((~finite).sum())}/{finite.numel()} entries)')
    bad = _bad_leaves(state)
    if bad:
        msgs.append('state leaves: ' + '; '.join(bad[:8])
                    + ('; ...' if len(bad) > 8 else ''))
    if msgs:
        msg = (f'mimo_tpu_torch.{engine}: NON-FINITE result — '
               + ' | '.join(msgs)
               + '. Common causes: degenerate prior scales (psi ~ 0), f32 '
               'overflow in xxT statistics, empty components with diffuse '
               'priors. Re-run at f64 or tighten the prior; '
               'MIMO_TPU_CHECK_FINITE=raise makes this fatal.')
        if mode == 'raise':
            raise FloatingPointError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return result
