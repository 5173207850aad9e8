"""Dataclass configs mirroring the reference's hyperparameter vocabulary
(port of mimo_tpu/config.py). `build` builds on the CUDA card unless
given a device (device='cpu' for the CPU). `TrainConfig` and
`flagship_fit` need the dense engines and SVI, and arrive with them
(ROADMAP A13/A14).
"""

from dataclasses import dataclass, field

import torch


@dataclass
class GatingConfig:
    kind: str = 'stick-breaking'     # 'dirichlet' | 'stick-breaking'
    alpha: float = 1.0               # concentration


@dataclass
class MixtureConfig:
    """DP-GMM / GMM configuration: full-covariance, diagonal or (with
    `hierarchical`) hierarchically-tied components, `tied` scales."""
    size: int = 50                   # truncation level
    dim: int = 2
    gating: GatingConfig = field(default_factory=GatingConfig)
    diag: bool = False
    tied: bool = False
    hierarchical: bool = False
    kappa: float = 1e-2
    psi_scale: float = 1.0
    maxsubiter: int = 25             # inner iterations (hierarchical only)

    def build(self, dtype=None, device=None):
        from mimo_tpu_torch.models.gmm import BayesianGMM
        return BayesianGMM.make(
            size=self.size, dim=self.dim, gating=self.gating.kind,
            alpha=self.gating.alpha, diag=self.diag, tied=self.tied,
            hierarchical=self.hierarchical, kappa=self.kappa,
            psi_scale=self.psi_scale, maxsubiter=self.maxsubiter,
            dtype=dtype or torch.float32, device=device)


@dataclass
class ILRConfig:
    """Infinite-mixture-of-linear-regressions configuration."""
    size: int = 50
    input_dim: int = 1
    output_dim: int = 1
    gating: GatingConfig = field(default_factory=GatingConfig)
    affine: bool = True
    diag: bool = False
    tied_affine: bool = False
    hier_basis: bool = False
    kappa: float = 1e-2
    K_scale: float = 1e-2
    psi_scale: float = 1.0
    maxsubiter: int = 25

    def build(self, dtype=None, device=None):
        from mimo_tpu_torch.models.ilr import BayesianILR
        return BayesianILR.make(
            size=self.size, input_dim=self.input_dim,
            output_dim=self.output_dim, gating=self.gating.kind,
            alpha=self.gating.alpha, affine=self.affine, diag=self.diag,
            tied_affine=self.tied_affine, hier_basis=self.hier_basis,
            kappa=self.kappa, K_scale=self.K_scale,
            psi_scale=self.psi_scale, maxsubiter=self.maxsubiter,
            dtype=dtype or torch.float32, device=device)
