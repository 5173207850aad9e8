"""Infinite mixture of linear regressions (ILR): a Bayesian mixture of
linear-Gaussian experts with Gaussian basis functions (port of
mimo_tpu/models/ilr.py: NIW or hierarchically-tied bases, MNW, MNG or
tied-affine experts).

The joint density p(x, y, z=k) = gating(k) basis_k(x) model_k(y | x) is
a product conjugate family, so the fused engines of `BayesianMixture`
run it (kernels B1/B2 over the ILR feature map on CUDA); this class adds
the standardization round trip and the prediction machinery
(posterior-predictive weights, per-expert Student-t moments, the
moment-matched mixture prediction and the NLPD; kernels B5/B6 on CUDA)
and `sample`. Every engine but the dense `fit_map` fits standardized
(x, y) once `init_transform` has run; `fit_map` fits the data it is
given, as the JAX package's does.
"""

from typing import Optional

import torch

from mimo_tpu_torch.conjugate.families import ilr_family
from mimo_tpu_torch.distributions import affine as _aff
from mimo_tpu_torch.distributions import hierarchical as _hier
from mimo_tpu_torch.distributions import mng as _mng
from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.affine import TiedAffine
from mimo_tpu_torch.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.distributions.mnw import MNW, LinGaussParams, augment
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models.mixture import (
    BayesianMixture, MFState, _as_generator, from_kernel, model_device,
    resolve_backend, serve_sharded, transform_points)
from mimo_tpu_torch.ops.cuda_ilr_predict import (
    ilr_p_predict_cuda_sharded, ilr_predict_cuda_sharded)
from mimo_tpu_torch.ops.family_estep import ilr_spec
from mimo_tpu_torch.utils.data import Standardizer
from mimo_tpu_torch.utils.linalg import cholesky, inv_psd
from mimo_tpu_torch.utils.stats import normalize_log


class BayesianILR(BayesianMixture):
    """Bayesian mixture of linear-Gaussian experts.

    components_prior = (basis_prior: NIW | HierTied, models_prior: MNW |
    MNG | TiedAffine); the experts are affine by default (ones column
    appended to x). MNG experts (`diag`) have diagonal noise: per-output
    Gamma precisions. Tied-affine experts share one slope and noise and
    are affine by construction; with a HierTied basis they are the
    reference's mixture of linear Gaussians with tied activation.
    `maxsubiter` is the inner rounds of the HierTied and tied-affine
    updates."""

    def __init__(self, gating_prior, basis_prior, models_prior, affine=True,
                 maxsubiter=25):
        if not isinstance(basis_prior, (NIW, HierTied)):
            raise TypeError('unsupported basis prior: '
                            f'{type(basis_prior).__name__}')
        if not isinstance(models_prior, (MNW, MNG, TiedAffine)):
            raise TypeError('unsupported models prior: '
                            f'{type(models_prior).__name__}')
        self.tied_affine = isinstance(models_prior, TiedAffine)
        self.hier_basis = isinstance(basis_prior, HierTied)
        self.affine = affine or self.tied_affine   # the offset is affine
        self.diag = isinstance(models_prior, MNG)
        self.input_dim = basis_prior.dim
        self.output_dim = models_prior.M.shape[-2]
        super().__init__(gating_prior, (basis_prior, models_prior),
                         ilr_family(affine=self.affine, diag=self.diag,
                                    tied_affine=self.tied_affine,
                                    hier_basis=self.hier_basis,
                                    maxsubiter=maxsubiter))
        self.input_transform: Optional[Standardizer] = None
        self.output_transform: Optional[Standardizer] = None

    @staticmethod
    def make(size, input_dim, output_dim, gating='stick-breaking', alpha=1.0,
             affine=True, diag=False, tied_affine=False, hier_basis=False,
             kappa=1e-2, K_scale=1e-2, psi_scale=1.0, basis_psi_scale=1.0,
             maxsubiter=25, dtype=torch.float32, device=None):
        """Convenience constructor, on `device` (by default the CUDA card;
        raises without one: pass device='cpu'): an NIW basis, or with
        `hier_basis` a HierTied one (unit kappa_k under a hyper-prior of
        precision `kappa`); MNW experts, MNG experts with `diag` (whose
        standard prior has no psi_scale), or tied-affine experts with
        `tied_affine` (offset precision `kappa`)."""
        device = model_device(device)
        if gating == 'dirichlet':
            g = Dirichlet.standard(size, alpha, dtype, device)
        else:
            g = StickBreaking.standard(size, alpha, dtype, device)
        if hier_basis:
            basis = HierTied.standard(size, input_dim, kappa=1.0,
                                      hyper_kappa=kappa,
                                      psi_scale=basis_psi_scale, dtype=dtype,
                                      device=device)
        else:
            basis = NIW.standard(size, input_dim, kappa=kappa,
                                 psi_scale=basis_psi_scale, dtype=dtype,
                                 device=device)
        q = input_dim + int(affine)
        if tied_affine:
            models = TiedAffine.standard(size, output_dim, input_dim,
                                         K_scale=K_scale, kappa=kappa,
                                         psi_scale=psi_scale, dtype=dtype,
                                         device=device)
        elif diag:
            models = MNG.standard(size, output_dim, q, K_scale=K_scale,
                                  dtype=dtype, device=device)
        else:
            models = MNW.standard(size, output_dim, q, K_scale=K_scale,
                                  psi_scale=psi_scale, dtype=dtype,
                                  device=device)
        return BayesianILR(g, basis, models, affine=affine,
                           maxsubiter=maxsubiter)

    def sample(self, state, key=None, n=1, params='mode'):
        """Draw (x, y, z) from the FITTED model, in ORIGINAL units (the
        standardization is inverted). `params`: 'mode' | 'mean' | 'draw'
        (a posterior draw of the likelihood params). `key`: an int seed or
        a torch.Generator on the state's device."""
        gen = _as_generator(key, state.gating.mean().device)
        if params == 'draw':
            bp, ep = self.family.sample_params(gen, state.components)
        elif params == 'mean':
            bp, ep = self.family.mean_params(state.components)
        else:
            bp, ep = self.family.mode_params(state.components)
        if hasattr(ep, 'lmbda_diag'):  # diagonal experts -> full precision
            ep = LinGaussParams(A=ep.A, lmbda=torch.diag_embed(ep.lmbda_diag))
        x, y, z = BayesianILR.generate(gen, bp, ep, state.gating.mean(), n,
                                       affine=self.affine)
        if self.input_transform is not None:
            x = self.input_transform.inverse_transform(x)
        if self.output_transform is not None:
            y = self.output_transform.inverse_transform(y)
        return x, y, z

    @staticmethod
    def generate(key, basis_params, expert_params, weights, n, affine=True):
        """Draw (x, y, z) from a known mixture of linear experts, on the
        device of the params. `key`: an int seed or a torch.Generator."""
        mu = basis_params.mu
        gen = _as_generator(key, mu.device)
        weights = torch.as_tensor(weights, dtype=mu.dtype, device=mu.device)
        z = torch.multinomial(weights, n, replacement=True, generator=gen)
        bx_chol = cholesky(inv_psd(basis_params.lmbda))
        ex = torch.randn((n, mu.shape[-1]), generator=gen, dtype=mu.dtype,
                         device=mu.device)
        x = mu[z] + torch.einsum('nde,ne->nd', bx_chol[z], ex)
        xa = augment(x, affine)
        mean_y = torch.einsum('npq,nq->np', expert_params.A[z], xa)
        ey_chol = cholesky(inv_psd(expert_params.lmbda))
        ey = torch.randn((n, expert_params.A.shape[-2]), generator=gen,
                         dtype=mu.dtype, device=mu.device)
        y = mean_y + torch.einsum('npr,nr->np', ey_chol[z], ey)
        return x, y, z

    # -- standardization ----------------------------------------------------

    def init_transform(self, x, y):
        self.input_transform = Standardizer.fit(x)
        self.output_transform = Standardizer.fit(y)

    def _tx(self, x):
        return transform_points(self.input_transform, x)

    def _ty(self, y):
        return transform_points(self.output_transform, y)

    def _estep_spec(self):
        return ilr_spec(self.input_dim, self.output_dim, affine=self.affine,
                        diag_expert=self.diag, hier_basis=self.hier_basis,
                        tied_affine=self.tied_affine)

    def _std(self, data):
        """(x, y) standardized by the one shared transform; with a leading
        chain axis, (C, N, .) each chain's own data (the dense engines'
        `chains=True`), the transform broadcasts over it."""
        x, y = data
        return self._tx(x), self._ty(y)

    def fit_vi(self, data, **kw):
        return super().fit_vi(self._std(data), **kw)

    def fit_svi(self, data, **kw):
        return super().fit_svi(self._std(data), **kw)

    def fit_gibbs(self, data, **kw):
        return super().fit_gibbs(self._std(data), **kw)

    def fit_em(self, data, **kw):
        """Likelihood-only EM of the mixture of linear experts."""
        return super().fit_em(self._std(data), **kw)

    def fit_vi_fused(self, data, **kw):
        """Fused VI over standardized (x, y): the N x K responsibilities
        and the expert statistics tensors never exist (B1 on CUDA)."""
        return super().fit_vi_fused(self._std(data), **kw)

    def fit_gibbs_fused(self, data, **kw):
        """Fused blocked Gibbs over standardized (x, y) (B2 on CUDA)."""
        return super().fit_gibbs_fused(self._std(data), **kw)

    def fit_em_fused(self, data, **kw):
        """Fused likelihood-only EM (plug-in softmax E-step, B1 on CUDA)."""
        return super().fit_em_fused(self._std(data), **kw)

    def fit_map_fused(self, data, **kw):
        """Fused MAP-EM (plug-in softmax at the posterior mode, B1 on
        CUDA)."""
        return super().fit_map_fused(self._std(data), **kw)

    # -- prediction -----------------------------------------------------------

    def _kernel_predict(self, state, xs, ys, prediction, incremental):
        """predict's kernel path over the parts xs (and ys, or None): B5
        (p = 1) or B6 (p > 1) once a part with the coefficients built once;
        one (mean, var, std, nlpd) a part, in original units."""
        basis_post, models_post = state.components
        serve = (ilr_predict_cuda_sharded if self.output_dim == 1
                 else ilr_p_predict_cuda_sharded)
        outs = serve(basis_post, models_post,
                     self.predictive_log_weights(state),
                     [self._tx(x) for x in xs],
                     None if ys is None else [self._ty(y) for y in ys],
                     self.affine, prediction)
        return [from_kernel(self.output_transform, x, *out, incremental)
                for x, out in zip(xs, outs)]

    def predictive_weights(self, state: MFState, x, dist='studentt'):
        """Input-conditional expert weights:
        softmax_k [ log E[pi_k] + log basis-predictive_k(x) ] -> (N, K)."""
        basis_post, _ = state.components
        mod = _hier if self.hier_basis else _niw
        log_basis = (mod.log_predictive_studentt(basis_post, x)
                     if dist == 'studentt'
                     else mod.log_predictive_gaussian(basis_post, x))
        weights, _ = normalize_log(
            log_basis + self.predictive_log_weights(state)[None, :])
        return weights

    def predictive_activation(self, state: MFState, x):
        """Normalized basis activations (for plotting): the Gaussian
        posterior-predictive basis responsibilities of x -> (N, K)."""
        return self.predictive_weights(state, self._tx(x), dist='gaussian')

    def _experts(self, state):
        """(the experts' module, their posterior): tied-affine experts as
        their block-diagonal MNW."""
        _, models_post = state.components
        if self.tied_affine:
            return _mnw, _aff.to_packed_mnw(models_post)
        return (_mng if self.diag else _mnw), models_post

    def predictive_moments(self, state: MFState, x, dist='studentt'):
        """Per-expert predictive mean (N, K, p) and covariance
        (N, K, p, p), or its diagonal (N, K, p) for MNG experts."""
        mod, models_post = self._experts(state)
        fn = (mod.predictive_moments_studentt if dist == 'studentt'
              else mod.predictive_moments_gaussian)
        return fn(models_post, augment(x, self.affine))

    @staticmethod
    def mixture_moments(mus, covars, weights, diag=False):
        """Moment matching of a mixture of predictives with full (N, K, p,
        p) or, with `diag`, diagonal (N, K, p) covariances; weights
        (N, K). The covariance in the centred form sum_k w_k (cov_k +
        (mu_k - mu)(mu_k - mu)'), which does not cancel where the means
        sit far from 0 against their spread as E[cov + mu mu'] - mu mu'
        does (the kernels' plain versions take the same form)."""
        mu = torch.einsum('nkp,nk->np', mus, weights)
        dev = mus - mu[:, None]
        if diag:
            return mu, torch.einsum('nkp,nk->np', covars + torch.square(dev),
                                    weights)
        second = covars + dev[..., :, None] * dev[..., None, :]
        return mu, torch.einsum('nkpr,nk->npr', second, weights)

    def log_predictive_likelihood(self, state: MFState, x, y,
                                  dist='studentt'):
        """Per-expert log p(y | x) under the posterior predictive
        -> (N, K)."""
        mod, models_post = self._experts(state)
        fn = (mod.log_predictive_studentt if dist == 'studentt'
              else mod.log_predictive_gaussian)
        return fn(models_post, augment(x, self.affine), y)

    def predict(self, state: MFState, x, y=None, prediction='average',
                dist='studentt', incremental=False, backend='auto',
                mesh=None):
        """Posterior-predictive regression. Returns (mean, var_diag, std,
        nlpd) with nlpd None unless y is given, in original units (the
        standardization is inverted and the NLPD carries the Jacobian
        sum(log scale)). `incremental` adds the input back onto the
        prediction (delta-dynamics models).

        `backend`: 'auto' serves Student-t predictions of CUDA data
        through the fused kernels (B5 for p = 1, B6 for p > 1: weights,
        moment matching and NLPD in one pass, no (N, K) intermediates) and
        everything else through the dense path; 'kernel' requires the
        kernels (raising for CPU data and for dist='gaussian', which stays
        dense); 'torch' forces the dense path.

        With `mesh` (a one-row mesh) every shard of x (and y) is served
        on its device, one B5 or B6 launch a shard on CUDA shards with the
        coefficients built once, no collective; each of the four results
        comes back as a parallel.mesh.Sharded (nlpd None without y)."""
        if dist not in ('studentt', 'gaussian'):
            raise ValueError(f'unknown dist: {dist!r}')
        if backend == 'kernel' and dist != 'studentt':
            raise NotImplementedError(
                "fused serving needs studentt predictives; use "
                "backend='torch' (dense) for this config")
        if mesh is not None:
            return serve_sharded(
                mesh, x, y, backend, dist,
                lambda xs, ys: self._kernel_predict(
                    state, xs, ys, prediction, incremental),
                lambda xj, yj: self.predict(state, xj, yj, prediction, dist,
                                            incremental, backend))
        use_kernel = resolve_backend(backend, x)
        if use_kernel and dist == 'studentt':
            return self._kernel_predict(state, [x], None if y is None
                                        else [y], prediction,
                                        incremental)[0]
        xx = self._tx(x)

        weights = self.predictive_weights(state, xx, dist)
        mus, covars = self.predictive_moments(state, xx, dist)
        if prediction == 'mode':
            k = torch.argmax(weights, -1)        # first occurrence on ties
            idx = torch.arange(x.shape[0], device=x.device)
            mu, cov = mus[idx, k], covars[idx, k]
        else:
            mu, cov = self.mixture_moments(mus, covars, weights, self.diag)

        nlpd = None
        if y is not None:
            log_pl = self.log_predictive_likelihood(state, xx, self._ty(y),
                                                    dist)
            nlpd = -torch.logsumexp(log_pl + torch.log(weights + 1e-37), -1)
            if self.output_transform is not None:
                # change of variables: p(y) = p(y_std) / prod(scale)
                nlpd = nlpd + torch.sum(torch.log(self.output_transform.scale))

        if self.output_transform is not None:
            mu = self.output_transform.inverse_transform(mu)
            cov = (cov * torch.square(self.output_transform.scale)
                   if self.diag else self.output_transform.scale_cov(cov))
        if incremental:
            mu = mu + x[:, :mu.shape[-1]]
        var = cov if self.diag else torch.diagonal(cov, dim1=-2, dim2=-1)
        return mu, var, torch.sqrt(var), nlpd
