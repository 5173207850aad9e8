"""Dataclass configs mirroring the reference's hyperparameter vocabulary
(port of mimo_tpu/config.py). `build` builds on the CUDA card unless
given a device (device='cpu' for the CPU). `TrainConfig` and
`flagship_fit` are the flagship recipe's loop: Gibbs init, then
super-iterations of SVI and/or VI with prior <- posterior re-anchoring.
"""

from dataclasses import dataclass, field
from typing import Optional

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


@dataclass
class TrainConfig:
    """The flagship recipe's loop structure: Gibbs init -> super-iterations
    of SVI/VI with prior <- posterior re-anchoring."""
    super_iters: int = 2             # --super_iters
    gibbs_iters: int = 10            # --gibbs_iters
    vi_iters: int = 500              # --meanfield_iters
    svi_iters: int = 500             # --svi_iters
    svi_step_size: float = 5e-1      # --svi_stepsize
    svi_batch_size: int = 256        # --svi_batchsize
    svi_forgetting: Optional[float] = None  # Robbins-Monro exponent; the
    svi_delay: float = 1.0                  # reference uses fixed rho
    prediction: str = 'average'      # --prediction: 'average' | 'mode'
    tol: float = 1e-2                # --early_stop (VI |dELBO| rule)
    seed: int = 1337
    engine: str = 'svi'              # 'svi' (default) | 'vi' (full-batch;
                                     # small N) | 'svi+vi' (both per
                                     # super-iteration)


def flagship_fit(model, data, cfg: TrainConfig):
    """Gibbs init, then super-iterations of SVI and/or full-batch VI with
    prior <- posterior re-anchoring, all warm-started (`cfg.engine`
    selects the engines, `cfg.tol` is the VI stopping rule). Returns
    (model, MFState)."""
    from mimo_tpu_torch.models.mixture import MFState
    engines = cfg.engine.split('+')
    bad = [e for e in engines if e not in ('svi', 'vi')]
    if bad:
        raise ValueError(
            f"TrainConfig.engine={cfg.engine!r}: unknown engine(s) {bad}; "
            f"use 'svi', 'vi', or 'svi+vi'")
    g = model.fit_gibbs(data, key=cfg.seed, maxiter=cfg.gibbs_iters,
                        init_labels='random')
    state = MFState(g.components, g.gating)
    for it in range(cfg.super_iters):
        if 'svi' in engines:
            state, _ = model.fit_svi(
                data, key=cfg.seed + it + 1, maxiter=cfg.svi_iters,
                step_size=cfg.svi_step_size,
                batch_size=cfg.svi_batch_size,
                forgetting=cfg.svi_forgetting, delay=cfg.svi_delay,
                init_state=state, randomize=False)
        if 'vi' in engines:
            state, _ = model.fit_vi(
                data, key=cfg.seed + it + 1, maxiter=cfg.vi_iters,
                tol=cfg.tol, init_state=state, randomize=False)
        model = model.with_priors(state)
    return model, state
