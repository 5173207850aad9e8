"""Vectorized log-pdfs (port of mimo_tpu/utils/stats.py).

Per-point-per-component matrices are (N, K), component axis last, as in
the JAX package.
"""

import math

import torch

from mimo_tpu_torch.utils.linalg import logdet_psd, quad_form

LOG2PI = 1.8378770664093453


def sample_categorical_from_log(gen, log_p, dim=-1):
    """Sample categorical labels from unnormalized log-probabilities: one
    Gumbel-max draw per row from the explicit generator, fully vectorized.
    Returns int64 labels with `dim` reduced."""
    u = torch.rand(log_p.shape, generator=gen, dtype=log_p.dtype,
                   device=log_p.device)
    tiny = torch.finfo(log_p.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(log_p + gumbel, dim=dim)


def normalize_log(log_p, dim=-1):
    """(softmax(log_p), logsumexp(log_p)) — the E-step normalizer."""
    lognorm = torch.logsumexp(log_p, dim=dim)
    return torch.exp(log_p - lognorm.unsqueeze(dim)), lognorm


def mvn_logpdf(x, mu, lmbda, logdet_lmbda=None):
    """Stacked multivariate normal log-pdf with precision matrices.
    x: (N, d); mu: (K, d); lmbda: (K, d, d) -> (N, K)."""
    d = x.shape[-1]
    if logdet_lmbda is None:
        logdet_lmbda = logdet_psd(lmbda)
    quad = quad_form(x, lmbda, mu)
    return 0.5 * (logdet_lmbda - d * LOG2PI) - 0.5 * quad


def diag_mvn_logpdf(x, mu, lmbda_diag):
    """Stacked diagonal-precision normal log-pdf.
    x: (N, d); mu, lmbda_diag: (K, d) -> (N, K)."""
    d = x.shape[-1]
    quad = (torch.square(x) @ lmbda_diag.T
            - 2.0 * (x @ (lmbda_diag * mu).T)
            + torch.sum(lmbda_diag * torch.square(mu), -1))
    logdet = torch.sum(torch.log(lmbda_diag), -1)
    return 0.5 * (logdet - d * LOG2PI) - 0.5 * quad


def gammaln_diff(a, h):
    """lgamma(a + h) - lgamma(a), stable for large a.

    The direct difference cancels catastrophically in f32 once a is
    large: at a ~ 2.5e6 (nu/2 of a posterior that absorbed N=1e7 points)
    lgamma(a) ~ 3.4e7, whose f32 ulp is 4 nats. For a >= 100 use the
    Stirling-series difference arranged so no large terms cancel:
      (a - 0.5) log1p(h/a) + h log(a+h) - h - h / (12 a (a+h))."""
    h = torch.as_tensor(h, dtype=a.dtype, device=a.device)
    direct = torch.lgamma(a + h) - torch.lgamma(a)
    a_safe = torch.clamp(a, min=100.0)      # keep the unused branch finite
    stable = ((a_safe - 0.5) * torch.log1p(h / a_safe)
              + h * torch.log(a_safe + h) - h
              - h / (12.0 * a_safe * (a_safe + h)))
    return torch.where(a < 100.0, direct, stable)


def mvt_logpdf(x, mu, lmbda, df):
    """Stacked multivariate Student-t log-pdf with precision-form scale
    `lmbda` (Sigma^{-1}) and degrees of freedom df (K,) -> (N, K)."""
    d = x.shape[-1]
    delta = quad_form(x, lmbda, mu)
    aux = (gammaln_diff(0.5 * df, 0.5 * d)
           + 0.5 * logdet_psd(lmbda)
           - 0.5 * d * (torch.log(df) + math.log(math.pi)))
    return aux - 0.5 * (df + d) * torch.log1p(delta / df)


def entropy_categorical(resp, dim=-1):
    """-sum resp*log(resp), NaN-safe."""
    pos = resp > 0
    plogp = torch.where(pos, resp * torch.log(torch.where(pos, resp, 1.0)),
                        0.0)
    return -torch.sum(plogp, dim=dim)
