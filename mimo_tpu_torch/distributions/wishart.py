"""Wishart distribution primitives, batched over a leading component axis
(port of mimo_tpu/distributions/wishart.py).

Convention: Lambda ~ W(psi, nu) with E[Lambda] = nu * psi.
"""

import math

import torch

from mimo_tpu_torch.utils.linalg import (
    cholesky, chol_logdet, mvdigamma, mvgammaln,
)


def gamma_sample(gen, conc):
    """Gamma(conc, 1) draws from an explicit generator (same device)."""
    return torch._standard_gamma(conc, generator=gen)


def wishart_sample(gen, psi, nu):
    """Draw Lambda ~ W(psi, nu), batched: psi (..., d, d), nu (...,).

    Bartlett: A lower-triangular with A_ii ~ sqrt(chi2(nu - i)),
    A_ij ~ N(0,1) for i > j; Lambda = (L A)(L A)^T with L = chol(psi)."""
    d = psi.shape[-1]
    batch = psi.shape[:-2]
    normals = torch.randn(batch + (d, d), generator=gen, dtype=psi.dtype,
                          device=psi.device)
    i = torch.arange(d, dtype=psi.dtype, device=psi.device)
    chi2 = 2.0 * gamma_sample(gen, 0.5 * (nu[..., None] - i))    # (..., d)
    a = torch.tril(normals, diagonal=-1) + torch.diag_embed(torch.sqrt(chi2))
    t = cholesky(psi) @ a
    return t @ t.transpose(-1, -2)


def wishart_expected_logdet(psi_chol, nu):
    """E[logdet Lambda] = mvdigamma(nu/2, d) + d log 2 + logdet psi."""
    return expected_logdet_at(chol_logdet(psi_chol), nu, psi_chol.shape[-1])


def expected_logdet_at(logdet_psi, nu, d):
    """`wishart_expected_logdet` given logdet psi (...,) itself."""
    return mvdigamma(0.5 * nu, d) + d * math.log(2.0) + logdet_psi


def wishart_log_partition(psi_chol, nu):
    """log Z of W(psi, nu): nu*d/2 log2 + log Gamma_d(nu/2) + nu/2 logdet psi."""
    return log_partition_at(chol_logdet(psi_chol), nu, psi_chol.shape[-1])


def log_partition_at(logdet_psi, nu, d):
    """`wishart_log_partition` given logdet psi (...,) itself."""
    return (0.5 * nu * d * math.log(2.0) + mvgammaln(0.5 * nu, d)
            + 0.5 * nu * logdet_psi)
