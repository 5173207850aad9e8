"""Conjugate-family protocol (port of mimo_tpu/conjugate/families.py).

A Family is a bundle of pure functions. `data` is a tuple of tensors with
leading axis N; `resp` is (N, K); per-point outputs are (N, K). This slice
ports the full-covariance Gaussian family; the SVI blend, the
maximum-likelihood update and the custom Gibbs hook arrive with the
engines that use them.
"""

from typing import Any, Callable, NamedTuple

import torch

from mimo_tpu_torch.distributions import niw as _niw


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
