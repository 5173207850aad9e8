"""Convert states between the JAX package and this one, leaf by leaf.

Both packages keep their states as NamedTuples with the same class and
field names, so a state converts by name: `state_from_numpy` takes a
state whose leaves are numpy arrays (or anything numpy can read, such as
JAX arrays) and returns this package's NamedTuples of tensors;
`state_to_numpy` goes back to numpy leaves. Dtypes are kept unless
`dtype` asks for a floating dtype.
"""

import numpy as np
import torch

from mimo_tpu_torch.distributions.affine import AffineStats, TiedAffine
from mimo_tpu_torch.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mng import MNG, DiagLinGaussParams
from mimo_tpu_torch.distributions.mnw import MNW, LinGaussParams, LinGaussStats
from mimo_tpu_torch.distributions.ng import NG, DiagGaussParams, DiagGaussStats
from mimo_tpu_torch.distributions.niw import NIW, GaussParams, GaussStats
from mimo_tpu_torch.models.hmix import (
    HMixEMState, HMixGibbsState, HMixState)
from mimo_tpu_torch.models.mixture import EMState, GibbsState, MFState
from mimo_tpu_torch.ops.family_estep import FusedEStep
from mimo_tpu_torch.utils.data import Standardizer

# product posteriors (ILR: (NIW or HierTied, MNW, MNG or TiedAffine)) are
# plain tuples and recurse; 0-d leaves (TiedAffine.nu) stay 0-d
_CLASSES = {c.__name__: c for c in (
    MFState, GibbsState, EMState, NIW, GaussStats, GaussParams, NG, DiagGaussStats,
    DiagGaussParams, MNW, LinGaussStats, LinGaussParams, MNG,
    DiagLinGaussParams, HierTied, TiedAffine, AffineStats, Dirichlet,
    StickBreaking, FusedEStep, Standardizer, HMixState, HMixGibbsState,
    HMixEMState)}


def state_from_numpy(tree, device=None, dtype=None):
    """Map a state tree with numpy leaves to this package's NamedTuples
    of tensors on `device`, matching classes and fields by name."""
    if hasattr(tree, '_fields'):
        name = type(tree).__name__
        cls = _CLASSES.get(name)
        if cls is None or cls._fields != tree._fields:
            raise TypeError(f'no counterpart for {name}{tree._fields}')
        return cls(*(state_from_numpy(getattr(tree, f), device, dtype)
                     for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_from_numpy(t, device, dtype) for t in tree)
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def state_to_numpy(tree):
    """This package's state tree (NamedTuples, tuples, lists, dicts) with
    its tensors as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, '_fields'):
        return type(tree)(*(state_to_numpy(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_to_numpy(t) for t in tree)
    return tree
