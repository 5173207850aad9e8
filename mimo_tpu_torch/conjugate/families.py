"""Conjugate-family protocol (port of mimo_tpu/conjugate/families.py).

A Family is a bundle of pure functions. `data` is a tuple of tensors with
leading axis N; `resp` is (N, K); per-point outputs are (N, K). This
package ports the full-covariance (NIW) and diagonal (NG) Gaussian
families, the hierarchically-tied Gaussians, the linear-Gaussian families
with full (MNW) and diagonal (MNG) noise, the tied-affine experts, the
scale-tied variants of the four base families, and the product that joins
a basis and an expert into the ILR family, each with its SVI blend and
(but the hierarchical families) its maximum-likelihood update.
"""

from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from mimo_tpu_torch.distributions import affine as _aff
from mimo_tpu_torch.distributions import hierarchical as _hier
from mimo_tpu_torch.distributions import mng as _mng
from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions import ng as _ng
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.mnw import augment
from mimo_tpu_torch.distributions.tied_gibbs import tied_gibbs_update
from mimo_tpu_torch.utils.linalg import inv_psd


class Family(NamedTuple):
    """Functional interface of a conjugate pair."""
    suff_stats: Callable[[Any, torch.Tensor], Any]   # (data, resp) -> stats
    update: Callable[[Any, Any], Any]                # (prior, stats) -> post
    ell: Callable[[Any, Any], torch.Tensor]          # (post, data) -> (N, K)
    loglik: Callable[[Any, Any], torch.Tensor]       # (params, data) -> (N, K)
    kl: Callable[[Any, Any], torch.Tensor]           # (q, p) -> (K,)
    sample_params: Callable[[Any, Any], Any]         # (gen, post) -> params
    mode_params: Callable[[Any], Any]
    mean_params: Callable[[Any], Any]
    log_predictive: Callable[[Any, Any], torch.Tensor]   # Student-t (N, K)
    log_predictive_gaussian: Callable[[Any, Any], torch.Tensor]
    # Optional override for families whose Gibbs step is not plain
    # update + sample (the exact tied, hierarchical and tied-affine
    # draws): (gen, prior, stats) -> (posterior, params)
    gibbs_update: Any = None
    # natural-gradient SVI step (post, prior, stats, scale, step) -> post;
    # tied-affine experts set one that raises, as the reference does
    svi_blend: Any = None
    # weighted maximum-likelihood update stats -> params for the
    # likelihood-only EM engines; None = EM unsupported (the hierarchical
    # families)
    ml_update: Any = None
    # The fixed prior's per-fit constants, prior -> consts, where the
    # family factors each matrix once a sweep (NIW only); None = it does
    # not. Given them, `update(prior, stats, consts, with_aux=True)` also
    # returns the posterior's aux (its inverse scale and log-determinant),
    # `kl(q, prior, consts, aux)` reads both in place of factoring, and
    # `psi_aux(post)` builds the aux of a posterior no update made.
    prior_consts: Any = None
    psi_aux: Any = None


def gaussian_family() -> Family:
    """Full-covariance Gaussian | Normal-Wishart."""
    return Family(
        suff_stats=lambda data, resp: _niw.suff_stats(data[0], resp),
        update=_niw.posterior_update,
        ell=lambda post, data: _niw.expected_log_likelihood(post, data[0]),
        loglik=lambda params, data: _niw.log_likelihood(params, data[0]),
        kl=_niw.kl_divergence,
        sample_params=_niw.sample_params,
        mode_params=_niw.mode_params,
        mean_params=_niw.mean_params,
        log_predictive=lambda post, data: _niw.log_predictive_studentt(
            post, data[0]),
        log_predictive_gaussian=lambda post, data:
            _niw.log_predictive_gaussian(post, data[0]),
        svi_blend=_niw.svi_blend,
        ml_update=_niw.ml_params,
        prior_consts=_niw.prior_constants,
        psi_aux=_niw.psi_aux,
    )


def diag_gaussian_family() -> Family:
    """Diagonal Gaussian | Normal-Gamma."""
    return Family(
        suff_stats=lambda data, resp: _ng.suff_stats(data[0], resp),
        update=_ng.posterior_update,
        ell=lambda post, data: _ng.expected_log_likelihood(post, data[0]),
        loglik=lambda params, data: _ng.log_likelihood(params, data[0]),
        kl=_ng.kl_divergence,
        sample_params=_ng.sample_params,
        mode_params=_ng.mode_params,
        mean_params=_ng.mean_params,
        log_predictive=lambda post, data: _ng.log_predictive_studentt(
            post, data[0]),
        log_predictive_gaussian=lambda post, data:
            _ng.log_predictive_gaussian(post, data[0]),
        svi_blend=_ng.svi_blend,
        ml_update=_ng.ml_params,
    )


def linear_family(affine: bool = True) -> Family:
    """Linear Gaussian y|x | Matrix-Normal-Wishart. data = (x, y); x is
    augmented with a ones column internally when affine."""
    def aug(x):
        return augment(x, affine)

    return Family(
        suff_stats=lambda data, resp: _mnw.suff_stats(aug(data[0]), data[1],
                                                      resp),
        update=_mnw.posterior_update,
        ell=lambda post, data: _mnw.expected_log_likelihood(
            post, aug(data[0]), data[1]),
        loglik=lambda params, data: _mnw.log_likelihood(
            params, aug(data[0]), data[1]),
        kl=_mnw.kl_divergence,
        sample_params=_mnw.sample_params,
        mode_params=_mnw.mode_params,
        mean_params=_mnw.mean_params,
        log_predictive=lambda post, data: _mnw.log_predictive_studentt(
            post, aug(data[0]), data[1]),
        log_predictive_gaussian=lambda post, data:
            _mnw.log_predictive_gaussian(post, aug(data[0]), data[1]),
        svi_blend=_mnw.svi_blend,
        ml_update=_mnw.ml_params,
    )


def diag_linear_family(affine: bool = True) -> Family:
    """Linear Gaussian y|x with diagonal noise | Matrix-Normal-Gamma. The
    statistics are MNW's (the MNG update reads their diagonal)."""
    def aug(x):
        return augment(x, affine)

    return Family(
        suff_stats=lambda data, resp: _mnw.suff_stats(aug(data[0]), data[1],
                                                      resp),
        update=_mng.posterior_update,
        ell=lambda post, data: _mng.expected_log_likelihood(
            post, aug(data[0]), data[1]),
        loglik=lambda params, data: _mng.log_likelihood(
            params, aug(data[0]), data[1]),
        kl=_mng.kl_divergence,
        sample_params=_mng.sample_params,
        mode_params=_mng.mode_params,
        mean_params=_mng.mean_params,
        log_predictive=lambda post, data: _mng.log_predictive_studentt(
            post, aug(data[0]), data[1]),
        log_predictive_gaussian=lambda post, data:
            _mng.log_predictive_gaussian(post, aug(data[0]), data[1]),
        svi_blend=_mng.svi_blend,
        ml_update=_mng.ml_params,
    )


def product_family(families, data_slices) -> Family:
    """Joint family over independent data blocks sharing the labels.

    `families`: tuple of Family; `data_slices`: tuple of index tuples —
    data_slices[i] selects which elements of the joint data tuple feed
    family i. Priors, posteriors, stats and params become tuples. ILR
    experts are built this way: p(x, y | z=k) = basis_k(x) model_k(y | x).
    Member samplers draw from the one generator in member order."""
    def pick(data, sl):
        return tuple(data[i] for i in sl)

    def member_gibbs(f: Family):
        if f.gibbs_update is not None:
            return f.gibbs_update

        def plain(gen, prior, stats):
            post = f.update(prior, stats)
            return post, f.sample_params(gen, post)
        return plain

    if any(f.gibbs_update is not None for f in families):
        def product_gibbs(gen, prior, stats):
            outs = tuple(member_gibbs(f)(gen, p, s)
                         for f, p, s in zip(families, prior, stats))
            return tuple(o[0] for o in outs), tuple(o[1] for o in outs)
    else:
        product_gibbs = None

    return Family(
        gibbs_update=product_gibbs,
        suff_stats=lambda data, resp: tuple(
            f.suff_stats(pick(data, sl), resp)
            for f, sl in zip(families, data_slices)),
        update=lambda prior, stats: tuple(
            f.update(p, s) for f, p, s in zip(families, prior, stats)),
        ell=lambda post, data: sum(
            f.ell(q, pick(data, sl))
            for f, q, sl in zip(families, post, data_slices)),
        loglik=lambda params, data: sum(
            f.loglik(p, pick(data, sl))
            for f, p, sl in zip(families, params, data_slices)),
        kl=lambda q, p: sum(
            f.kl(qq, pp) for f, qq, pp in zip(families, q, p)),
        sample_params=lambda gen, post: tuple(
            f.sample_params(gen, q) for f, q in zip(families, post)),
        mode_params=lambda post: tuple(
            f.mode_params(q) for f, q in zip(families, post)),
        mean_params=lambda post: tuple(
            f.mean_params(q) for f, q in zip(families, post)),
        log_predictive=lambda post, data: sum(
            f.log_predictive(q, pick(data, sl))
            for f, q, sl in zip(families, post, data_slices)),
        log_predictive_gaussian=lambda post, data: sum(
            f.log_predictive_gaussian(q, pick(data, sl))
            for f, q, sl in zip(families, post, data_slices)),
        svi_blend=lambda post, prior, stats, scale, step: tuple(
            f.svi_blend(q, p, s, scale, step)
            for f, q, p, s in zip(families, post, prior, stats)),
        ml_update=(
            (lambda stats: tuple(f.ml_update(s)
                                 for f, s in zip(families, stats)))
            if all(f.ml_update is not None for f in families) else None),
    )


def hier_gaussian_family(nb_iter: int = 25) -> Family:
    """Hierarchically-tied Gaussians: a shared NW hyper-prior over the
    component means and one tied precision. The VI update runs `nb_iter`
    inner coordinate-ascent rounds (the reference's maxsubiter); the Gibbs
    step is the exact one-shot draw, which has no inner chain."""
    return Family(
        suff_stats=lambda data, resp: _niw.suff_stats(data[0], resp),
        update=lambda prior, stats: _hier.posterior_update(prior, stats,
                                                           nb_iter),
        ell=lambda post, data: _hier.expected_log_likelihood(post, data[0]),
        loglik=lambda params, data: _niw.log_likelihood(params, data[0]),
        kl=_hier.kl_divergence,
        sample_params=_hier.sample_params,
        mode_params=_hier.mode_params,
        mean_params=_hier.mean_params,
        log_predictive=lambda post, data: _hier.log_predictive_studentt(
            post, data[0]),
        log_predictive_gaussian=lambda post, data:
            _hier.log_predictive_gaussian(post, data[0]),
        gibbs_update=_hier.gibbs_update_exact,
        svi_blend=lambda post, prior, stats, scale, step: _hier.svi_blend(
            post, prior, stats, scale, step, nb_iter=1),
    )


def _no_svi(*args, **kwargs):
    raise NotImplementedError(
        'meanfield_sgd is not implemented for tied-affine experts '
        '(the reference raises as well)')


def tied_affine_family(nb_iter: int = 25) -> Family:
    """Tied-affine experts: one shared slope and noise, per-component
    offsets. data = (x, y), x not augmented. The VI update runs `nb_iter`
    inner coordinate-ascent rounds; the Gibbs step is the exact one-shot
    draw; the SVI blend raises."""
    def aug(x):
        return augment(x, True)

    return Family(
        suff_stats=lambda data, resp: _aff.suff_stats(data[0], data[1],
                                                      resp),
        update=lambda prior, stats: _aff.posterior_update(prior, stats,
                                                          nb_iter),
        ell=lambda post, data: _aff.expected_log_likelihood(
            post, aug(data[0]), data[1]),
        loglik=lambda params, data: _aff.log_likelihood(
            params, aug(data[0]), data[1]),
        kl=_aff.kl_divergence,
        sample_params=_aff.sample_params,
        mode_params=_aff.mode_params,
        mean_params=_aff.mean_params,
        log_predictive=lambda post, data: _aff.log_predictive_studentt(
            post, aug(data[0]), data[1]),
        log_predictive_gaussian=lambda post, data:
            _aff.log_predictive_gaussian(post, aug(data[0]), data[1]),
        gibbs_update=_aff.gibbs_update_exact,
        svi_blend=_no_svi,
    )


def ilr_family(affine: bool = True, diag: bool = False,
               tied_affine: bool = False, hier_basis: bool = False,
               maxsubiter: int = 25) -> Family:
    """Mixture-of-linear-experts joint family: a Gaussian basis on x (NIW,
    or hierarchically tied with `hier_basis`) x a linear model of y | x
    (MNW, MNG with `diag`, or tied-affine). data = (x, y). `tied_affine`
    with `hier_basis` is the reference's mixture of linear Gaussians with
    tied activation."""
    basis = (hier_gaussian_family(maxsubiter) if hier_basis
             else gaussian_family())
    if tied_affine:
        model = tied_affine_family(maxsubiter)
    elif diag:
        model = diag_linear_family(affine)
    else:
        model = linear_family(affine)
    return product_family((basis, model), ((0,), (0, 1)))


# -- tied variants (a scale shared across components) ------------------------

def _pool_wishart(p):
    """Pool an NIW or MNW posterior across K: psi = inv(mean_k
    psi_k^{-1}), nu = mean_k nu_k."""
    pooled = inv_psd(torch.mean(inv_psd(p.psi), 0, keepdim=True))
    return p._replace(psi=pooled.expand(p.psi.shape),
                      nu=torch.mean(p.nu).expand(p.nu.shape))


def _pool_gamma(p):
    """Pool an NG or MNG posterior across K: alpha and beta averaged."""
    return p._replace(alpha=torch.mean(p.alpha, 0, keepdim=True).expand(
                          p.alpha.shape),
                      beta=torch.mean(p.beta, 0, keepdim=True).expand(
                          p.beta.shape))


# the reference pools NIW and MNW posteriors alike (psi, nu), and NG and
# MNG alike (alpha, beta)
_POOLERS = {_niw.NIW: _pool_wishart, _mnw.MNW: _pool_wishart,
            _ng.NG: _pool_gamma, _mng.MNG: _pool_gamma}


def _tied_ml(stats, base_ml):
    """Pooled-scale weighted maximum likelihood: per-component means or
    slopes, one shared covariance from the summed residual scatter.
    Dispatches on the BASE family's params type (MNW and MNG share
    LinGaussStats, so the statistics alone cannot tell full from diagonal
    noise)."""
    params = base_ml(stats)
    if isinstance(params, _niw.GaussParams):
        n = torch.clamp(stats.n1, min=1e-8)
        scatter = stats.xxT - n[..., None, None] * (
            params.mu[..., :, None] * params.mu[..., None, :])
        sigma = torch.sum(scatter, 0, keepdim=True) / torch.sum(n)
        eye = torch.eye(sigma.shape[-1], dtype=sigma.dtype,
                        device=sigma.device)
        lm = torch.linalg.inv(sigma + 1e-6 * eye)
        return params._replace(lmbda=lm.expand(params.lmbda.shape))
    if isinstance(params, _mnw.LinGaussParams):
        n = torch.clamp(stats.n, min=1e-8)
        resid = stats.yyT - params.A @ stats.yxT.transpose(-1, -2)
        sigma = torch.sum(resid, 0, keepdim=True) / torch.sum(n)
        eye = torch.eye(sigma.shape[-1], dtype=sigma.dtype,
                        device=sigma.device)
        lm = torch.linalg.inv(0.5 * (sigma + sigma.transpose(-1, -2))
                              + 1e-6 * eye)
        return params._replace(lmbda=lm.expand(params.lmbda.shape))
    if isinstance(params, _ng.DiagGaussParams):
        n = torch.clamp(stats.n1, min=1e-8)
        scatter = stats.xsq - n[..., None] * torch.square(params.mu)
        sigma = torch.sum(scatter, 0, keepdim=True) / torch.sum(n)
        return params._replace(lmbda_diag=(1.0 / (sigma + 1e-8)).expand(
            params.lmbda_diag.shape))
    if isinstance(params, _mng.DiagLinGaussParams):
        n = torch.clamp(stats.n, min=1e-8)
        resid = stats.yyT - params.A @ stats.yxT.transpose(-1, -2)
        sigma = (torch.sum(torch.diagonal(resid, dim1=-2, dim2=-1), 0,
                           keepdim=True) / torch.sum(n))
        return params._replace(lmbda_diag=(1.0 / (sigma + 1e-8)).expand(
            params.lmbda_diag.shape))
    raise TypeError(f'no tied ML for {type(params).__name__}')


def tied_family(base: Family) -> Family:
    """Tie the scale parameters across components: run the base update
    (or SVI blend), then pool the posterior (the reference pools in its
    nat -> std map, the same point). The Gibbs step does not pool: it is
    the exact tied draw (`tied_gibbs.tied_gibbs_update`), one Wishart or
    Gamma draw of the shared scale. The ML update pools the residual
    scatter (`_tied_ml`). The base family's posterior must be NIW, NG,
    MNW or MNG. Pooling replaces the update's inverse scale, so the tied
    family keeps no prior constants."""
    def pool(post):
        return _POOLERS[type(post)](post)

    return base._replace(
        prior_consts=None, psi_aux=None,
        update=lambda prior, stats: pool(base.update(prior, stats)),
        svi_blend=lambda post, prior, stats, scale, step: pool(
            base.svi_blend(post, prior, stats, scale, step)),
        gibbs_update=tied_gibbs_update,
        ml_update=(None if base.ml_update is None
                   else partial(_tied_ml, base_ml=base.ml_update)))
