"""Checkpoint / resume (port of mimo_tpu/utils/checkpoint.py): every
inference state is a tree of NamedTuples and tuples over tensors, so a
checkpoint is the tree's tensor leaves in field order.

File format: `path` holds one `torch.save` record {'leaves': [CPU
tensors in field order], 'iters': iterations done or None}, read back
with `torch.load(weights_only=True)`, which unpickles tensors, lists,
dicts and numbers only; the tree's structure comes from a `like` state,
as in the JAX package's npz fallback. Files are written to a temporary
name and renamed into place, so a process killed while saving leaves the
previous checkpoint whole. `fit_with_checkpoints` also writes
`path + '.meta.json'` ({'iters', 'fit'}) for readers; it resumes from the
count saved with the state itself, which a kill between the two writes
cannot part from the state.
"""

import json
import os

import torch

from mimo_tpu_torch.utils.tree import tree_leaves


def _unflatten(like, leaves):
    """`like`'s structure over the next leaves of the iterator."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    items = [_unflatten(t, leaves) for t in like]
    return type(like)(*items) if hasattr(like, '_fields') else type(like)(
        items)


def _replace_into(path, write):
    tmp = f'{path}.tmp{os.getpid()}'
    write(tmp)
    os.replace(tmp, path)


def _save(path, state, iters):
    record = {'leaves': [t.detach().cpu() for t in tree_leaves(state)],
              'iters': iters}
    _replace_into(path, lambda p: torch.save(record, p))


def _load(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def save_state(path, state):
    """Save any state tree (MFState, GibbsState, HMixState, priors, ...)."""
    _save(path, state, None)
    return path


def load_state(path, like):
    """Restore a state saved by `save_state`: `like` gives the tree's
    structure, and each leaf lands on the device of `like`'s leaf with
    its saved dtype. Raises if the file does not hold `like`'s leaves
    (their number or shapes)."""
    return _restore(_load(path)['leaves'], like, path)


def _restore(saved, like, path):
    want = tree_leaves(like)
    if len(saved) != len(want) or any(
            s.shape != w.shape for s, w in zip(saved, want)):
        raise ValueError(
            f'checkpoint {path}: leaves {[tuple(s.shape) for s in saved]} '
            f'do not fit the state {[tuple(w.shape) for w in want]}')
    return _unflatten(like, iter(s.to(w.device)
                                 for s, w in zip(saved, want)))


def exists(path):
    """True if a checkpoint written by save_state is present."""
    return os.path.exists(path)


def chunk_key(key, it):
    """The int seed of the chunk that starts after `it` iterations: a
    deterministic function of (key, it), as jax.random.fold_in(key, it)
    is, so a resumed run draws what an uninterrupted one does. `key` is an
    int seed or a torch.Generator (its initial seed)."""
    if isinstance(key, torch.Generator):
        key = key.initial_seed()
    if key is None:
        key = 0
    # splitmix64 of the pair, kept to 63 bits (a torch.Generator seed)
    z = (int(key) * 0x9E3779B97F4A7C15 + int(it) + 1) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) >> 1


def fit_with_checkpoints(model, fit_name, data, path, total_iters,
                         chunk_iters=100, key=0, resume=True, **fit_kwargs):
    """Preemption-tolerant driver: run `model.<fit_name>` in chunks of
    `chunk_iters`, saving the state and the iterations done after each
    chunk; with `resume=True` a restarted process continues from the last
    checkpoint, and a checkpoint that cannot be loaded raises. Works for
    every engine that takes `init_state` (fit_vi_fused, fit_vi, fit_svi,
    fit_gibbs; the nested fit_svi): warm chunks pass the state as
    `init_state` (and randomize=False but for fit_gibbs). Chunk i's key is
    `chunk_key(key, iterations done)`, so a resumed run equals an
    uninterrupted one.

    Returns (final_state, iterations_run_this_call)."""
    meta_path = path + '.meta.json'
    state, done = None, 0
    if resume and exists(path):
        rec = _load(path)
        if rec['iters'] is None:
            raise ValueError(f'checkpoint {path} was not written by '
                             'fit_with_checkpoints (no iteration count)')
        done = int(rec['iters'])
        # the structure: the engine's state at zero iterations (no sweep)
        probe = getattr(model, fit_name)(data, key=key, maxiter=0,
                                         **fit_kwargs)
        state = _restore(rec['leaves'], _state_of(probe), path)

    ran, it = 0, done
    while it < total_iters:
        this = min(chunk_iters, total_iters - it)
        kwargs = dict(fit_kwargs)
        if state is not None:
            kwargs['init_state'] = state
            if fit_name != 'fit_gibbs':
                kwargs.setdefault('randomize', False)
        out = getattr(model, fit_name)(data, key=chunk_key(key, it),
                                       maxiter=this, **kwargs)
        state = _state_of(out)
        it += this
        ran += this
        _save(path, state, it)
        _replace_into(meta_path, lambda p: _write_json(
            p, {'iters': it, 'fit': fit_name}))
    return state, ran


def _write_json(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f)


def _state_of(out):
    """Engines return either a state NamedTuple or (state, trace)."""
    if isinstance(out, tuple) and not hasattr(out, '_fields'):
        return out[0]
    return out
