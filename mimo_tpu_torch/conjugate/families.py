"""Conjugate-family protocol (port of mimo_tpu/conjugate/families.py).

A Family is a bundle of pure functions. `data` is a tuple of tensors with
leading axis N; `resp` is (N, K); per-point outputs are (N, K). This
package ports the full-covariance (NIW) and diagonal (NG) Gaussian
families, the linear-Gaussian families with full (MNW) and diagonal (MNG)
noise, and the product that joins a basis and an expert into the ILR
family; the SVI blend and the maximum-likelihood update arrive with the
engines that use them (ROADMAP A13/A14).
"""

from typing import Any, Callable, NamedTuple

import torch

from mimo_tpu_torch.distributions import mng as _mng
from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions import ng as _ng
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.mnw import augment


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
    # update + sample (hierarchical and tied families, ROADMAP A16/A17):
    # (gen, prior, stats) -> (posterior, params)
    gibbs_update: Any = None


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
    )


def ilr_family(affine: bool = True, diag: bool = False,
               tied_affine: bool = False, hier_basis: bool = False,
               maxsubiter: int = 25) -> Family:
    """Mixture-of-linear-experts joint family: Gaussian basis on x (NIW)
    x linear model of y|x (MNW, or MNG when `diag`). data = (x, y). The
    tied-affine and hierarchically-tied variants are not ported yet."""
    if tied_affine:
        raise NotImplementedError('tied-affine experts are not ported yet '
                                  '(ROADMAP A17)')
    if hier_basis:
        raise NotImplementedError('the hierarchically-tied basis is not '
                                  'ported yet (ROADMAP A16)')
    model = diag_linear_family(affine) if diag else linear_family(affine)
    return product_family((gaussian_family(), model), ((0,), (0, 1)))
