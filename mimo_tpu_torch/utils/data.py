"""Data helpers (port of the `Standardizer` of mimo_tpu/utils/data.py).

`one_hot`, `nan_mask` and `sample_batch_indices` arrive with the SVI
engine that uses them (ROADMAP A14).
"""

from typing import NamedTuple

import torch


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
