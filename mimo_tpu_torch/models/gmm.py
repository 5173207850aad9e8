"""Bayesian (DP-)GMM with full-covariance (NIW) or diagonal (NG)
components (port of the main-path slice of mimo_tpu/models/gmm.py)."""

import torch

from mimo_tpu_torch.conjugate.families import (
    diag_gaussian_family, gaussian_family)
from mimo_tpu_torch.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW, GaussParams
from mimo_tpu_torch.models.mixture import BayesianMixture, _as_generator
from mimo_tpu_torch.utils.linalg import cholesky, inv_psd


class BayesianGMM(BayesianMixture):
    """Bayesian mixture of Gaussians with conjugate priors: full
    covariance (NIW) or diagonal (NG) components, and a Dirichlet or
    stick-breaking (DP) gating prior."""

    def __init__(self, gating_prior, components_prior):
        if isinstance(components_prior, NIW):
            family = gaussian_family()
        elif isinstance(components_prior, NG):
            family = diag_gaussian_family()
        else:
            raise TypeError('unsupported component prior: '
                            f'{type(components_prior).__name__}')
        super().__init__(gating_prior, components_prior, family)

    @staticmethod
    def make(size, dim, gating='dirichlet', alpha=1.0, diag=False, mean=None,
             kappa=1e-2, psi_scale=1.0, nu=None, dtype=torch.float32,
             device=None):
        """Convenience constructor: `gating` is 'dirichlet' or
        'dp' / 'stick-breaking'; `diag` builds NG components (whose
        standard prior has no psi_scale or nu); the priors live on
        `device`."""
        if gating == 'dirichlet':
            g = Dirichlet.standard(size, alpha, dtype, device)
        elif gating in ('stick-breaking', 'dp'):
            g = StickBreaking.standard(size, alpha, dtype, device)
        else:
            raise ValueError(gating)
        if diag:
            c = NG.standard(size, dim, mean=mean, kappa=kappa, dtype=dtype,
                            device=device)
        else:
            c = NIW.standard(size, dim, mean=mean, kappa=kappa,
                             psi_scale=psi_scale, nu=nu, dtype=dtype,
                             device=device)
        return BayesianGMM(g, c)

    def _estep_spec(self):
        from mimo_tpu_torch.ops.family_estep import (
            diag_gaussian_spec, gaussian_spec)
        if isinstance(self.components_prior, NG):
            return diag_gaussian_spec()
        return gaussian_spec()

    @staticmethod
    def generate(key, params: GaussParams, weights, n):
        """Draw (obs (n, d), labels (n,)) from a known mixture, on the
        device of `params`. `key`: an int seed or a torch.Generator."""
        mu = params.mu
        gen = _as_generator(key, mu.device)
        weights = torch.as_tensor(weights, dtype=mu.dtype, device=mu.device)
        labels = torch.multinomial(weights, n, replacement=True,
                                   generator=gen)
        chol = cholesky(inv_psd(params.lmbda))
        z = torch.randn((n, mu.shape[-1]), generator=gen, dtype=mu.dtype,
                        device=mu.device)
        x = mu[labels] + torch.einsum('nde,ne->nd', chol[labels], z)
        return x, labels
