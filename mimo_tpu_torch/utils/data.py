"""Data helpers: one-hot labels, NaN masking, minibatch sampling and
standardization (port of mimo_tpu/utils/data.py), and `to_numpy`."""

from typing import NamedTuple

import numpy as np
import torch


def to_numpy(a):
    """A tensor on any device, or anything array-like, as a NumPy array
    (the example drivers' and the plotting helpers' way to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def one_hot(labels, num_classes, dtype=torch.float32):
    """(N,) int labels -> (N, K) one-hot in `dtype`."""
    return torch.nn.functional.one_hot(labels.long(), num_classes).to(dtype)


def nan_mask(*arrays):
    """Static-shape NaN handling: returns (clean_arrays, weights) where
    rows holding a NaN in ANY array get weight 0 and are zero-filled. Pass
    the weights as the engines' `point_weights`, which make masked rows
    exact no-ops. A single array comes back bare, as in the JAX package."""
    bad = None
    for a in arrays:
        b = torch.isnan(a).reshape(a.shape[0], -1).any(-1)
        bad = b if bad is None else (bad | b)
    weights = torch.where(bad, 0.0, 1.0).to(arrays[0].dtype)
    clean = tuple(torch.nan_to_num(a, nan=0.0) for a in arrays)
    return clean if len(clean) > 1 else clean[0], weights


def sample_batch_indices(gen, data_size, batch_size, replace=None):
    """One random minibatch of indices per call, on the generator's
    device. Where the batch is a small fraction of the data
    (N > max(2^16, 32 B)) it samples WITH replacement, O(B) and still an
    unbiased minibatch; else a without-replacement draw (a permutation of
    N). Pass `replace` to force either."""
    if replace is None:
        replace = data_size > max(1 << 16, 32 * batch_size)
    if replace:
        return torch.randint(0, data_size, (batch_size,), generator=gen,
                             device=gen.device)
    return torch.randperm(data_size, generator=gen,
                          device=gen.device)[:batch_size]


class Standardizer(NamedTuple):
    """StandardScaler as a NamedTuple of tensors (mean and population
    standard deviation over axis 0), so it converts leaf by leaf with the
    JAX package's `Standardizer`."""
    mean: torch.Tensor
    scale: torch.Tensor  # standard deviation

    @staticmethod
    def fit(x):
        mean = torch.mean(x, 0)
        scale = torch.std(x, 0, correction=0)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        return Standardizer(mean=mean, scale=scale)

    @staticmethod
    def identity(dim, dtype=torch.float32, device=None):
        return Standardizer(mean=torch.zeros(dim, dtype=dtype, device=device),
                            scale=torch.ones(dim, dtype=dtype, device=device))

    def transform(self, x):
        return (x - self.mean) / self.scale

    def inverse_transform(self, x):
        return x * self.scale + self.mean

    def scale_cov(self, cov):
        """Map covariance matrices back to the original output scale."""
        return cov * (self.scale[:, None] * self.scale[None, :])
