"""Gaussian mixture models (port of mimo_tpu/models/gmm.py): the Bayesian
(DP-)GMM with full-covariance (NIW), diagonal (NG) or hierarchically-tied
components, optionally with a scale tied across components, and the
maximum-likelihood `GMM` fitted by EM."""

import torch

from mimo_tpu_torch.conjugate.families import (
    diag_gaussian_family, gaussian_family, hier_gaussian_family, tied_family)
from mimo_tpu_torch.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW, GaussParams
from mimo_tpu_torch.models.mixture import (
    BayesianMixture, EMState, _as_generator, _random_resp, _stack,
    model_device)
from mimo_tpu_torch.ops.family_estep import (
    diag_gaussian_spec, gaussian_spec, hier_gaussian_spec)
from mimo_tpu_torch.utils.linalg import cholesky, inv_psd, symmetrize
from mimo_tpu_torch.utils.stats import mvn_logpdf, normalize_log


class BayesianGMM(BayesianMixture):
    """Bayesian mixture of Gaussians with conjugate priors: full
    covariance (NIW), diagonal (NG) or hierarchically-tied (HierTied)
    components, and a Dirichlet or stick-breaking (DP) gating prior.
    `tied` shares the covariance scale of NIW or NG components across K
    (the reference's tgmm / tdgmm); `maxsubiter` is the HierTied update's
    number of inner rounds."""

    def __init__(self, gating_prior, components_prior, tied=False,
                 maxsubiter=25):
        if isinstance(components_prior, NIW):
            family = gaussian_family()
        elif isinstance(components_prior, NG):
            family = diag_gaussian_family()
        elif isinstance(components_prior, HierTied):
            if tied:
                raise ValueError('HierTied is already precision-tied')
            family = hier_gaussian_family(maxsubiter)
        else:
            raise TypeError('unsupported component prior: '
                            f'{type(components_prior).__name__}')
        if tied:
            family = tied_family(family)
        self.tied = tied
        super().__init__(gating_prior, components_prior, family)

    @staticmethod
    def make(size, dim, gating='dirichlet', alpha=1.0, diag=False, tied=False,
             hierarchical=False, mean=None, kappa=1e-2, psi_scale=1.0,
             nu=None, maxsubiter=25, dtype=torch.float32, device=None):
        """Convenience constructor: `gating` is 'dirichlet' or
        'dp' / 'stick-breaking'; `diag` builds NG components (whose
        standard prior has no psi_scale or nu); `hierarchical` builds
        HierTied components with unit kappa_k under a hyper-prior of
        precision `kappa`; the priors live on `device`, by default the
        CUDA card (raises without one: pass device='cpu')."""
        device = model_device(device)
        if gating == 'dirichlet':
            g = Dirichlet.standard(size, alpha, dtype, device)
        elif gating in ('stick-breaking', 'dp'):
            g = StickBreaking.standard(size, alpha, dtype, device)
        else:
            raise ValueError(gating)
        if hierarchical:
            c = HierTied.standard(size, dim, kappa=1.0, hyper_kappa=kappa,
                                  psi_scale=psi_scale, nu=nu, dtype=dtype,
                                  device=device)
        elif diag:
            c = NG.standard(size, dim, mean=mean, kappa=kappa, dtype=dtype,
                            device=device)
        else:
            c = NIW.standard(size, dim, mean=mean, kappa=kappa,
                             psi_scale=psi_scale, nu=nu, dtype=dtype,
                             device=device)
        return BayesianGMM(g, c, tied=tied, maxsubiter=maxsubiter)

    def _estep_spec(self):
        """The component family's spec; a tied GMM keeps its base spec,
        over the pooled posterior."""
        if isinstance(self.components_prior, NG):
            return diag_gaussian_spec()
        if isinstance(self.components_prior, HierTied):
            return hier_gaussian_spec()
        return gaussian_spec()

    def sample(self, state, key=None, n=1, params='mode'):
        """Draw (obs, labels) from the FITTED model. `params`: 'mode' (the
        MAP plug-in), 'mean', or 'draw' (params sampled from the posterior
        first: the full posterior predictive). `key`: an int seed or a
        torch.Generator on the state's device."""
        comp = state.components
        gen = _as_generator(key, state.gating.mean().device)
        if params == 'draw':
            p = self.family.sample_params(gen, comp)
        elif params == 'mean':
            p = self.family.mean_params(comp)
        else:
            p = self.family.mode_params(comp)
        if hasattr(p, 'lmbda_diag'):   # diagonal family -> full precision
            p = GaussParams(mu=p.mu, lmbda=torch.diag_embed(p.lmbda_diag))
        return BayesianGMM.generate(gen, p, state.gating.mean(), n)

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


class GMM:
    """Maximum-likelihood GMM via EM. Stateless: `fit_em` returns
    (EMState, loglik trace)."""

    def __init__(self, size, dim):
        self.size = size
        self.dim = dim

    def log_complete_likelihood(self, state: EMState, x):
        return (mvn_logpdf(x, state.params.mu, state.params.lmbda)
                + state.log_pi[None, :])

    def log_likelihood(self, state: EMState, x):
        return torch.logsumexp(self.log_complete_likelihood(state, x), -1)

    def responsibilities(self, state: EMState, x):
        resp, _ = normalize_log(self.log_complete_likelihood(state, x))
        return resp

    def sample(self, state: EMState, key=None, n=1):
        """Draw (obs, labels) from the fitted ML model."""
        return BayesianGMM.generate(key, state.params,
                                    torch.softmax(state.log_pi, -1), n)

    def _m_step(self, x, resp, jitter=1e-6):
        """Closed-form weighted ML over K."""
        n, d = x.shape
        counts = torch.sum(resp, 0)
        safe = torch.clamp(counts, min=1e-8)           # empty component
        mu = (resp.T @ x) / safe[:, None]
        xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
        exx = (resp.T @ xx).reshape(-1, d, d) / safe[:, None, None]
        sigma = (symmetrize(exx - mu[:, :, None] * mu[:, None, :])
                 + jitter * torch.eye(d, dtype=x.dtype, device=x.device))
        return EMState(params=GaussParams(mu=mu, lmbda=inv_psd(sigma)),
                       log_pi=torch.log(torch.clamp(counts, min=1e-37) / n))

    def fit_em(self, x, key=None, maxiter=250):
        """EM from random responsibilities. `key`: an int seed or a
        torch.Generator on x's device. Returns (EMState, loglik trace)."""
        resp = _random_resp(_as_generator(key, x.device), x.shape[0],
                            self.size, x.dtype, x.device)
        state, trace = None, []
        for _ in range(maxiter):
            state = self._m_step(x, resp)
            resp, lognorm = normalize_log(
                self.log_complete_likelihood(state, x))
            trace.append(torch.sum(lognorm))
        return state, _stack(trace, x)
