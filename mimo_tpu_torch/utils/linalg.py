"""Batched PSD linear algebra helpers (port of mimo_tpu/utils/linalg.py).

Everything broadcasts over leading batch axes (typically the K component
axis). Matmuls run at full float32: the package sets the precision policy
at import, so no per-call precision wrappers are needed.
"""

import math

import torch

# Batched Cholesky factorizations and Cholesky solves run since the last
# reset, a count a call whatever its batch (the tests and chip_smoke.py
# read how often a sweep factors).
counts = {'cholesky': 0, 'solve': 0}


def symmetrize(a):
    """0.5 * (A + A^T) over the trailing two axes."""
    return 0.5 * (a + a.transpose(-1, -2))


def _eye(a):
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def cholesky(a, jitter=0.0):
    """Batched lower Cholesky factor of a PSD matrix, with optional
    diagonal jitter. A matrix that is not PD gives NaN factors (as
    jnp.linalg.cholesky does) instead of raising, so a bad sweep shows up
    in the ELBO trace and in `finite_report` rather than stopping a run
    mid-way on a host sync."""
    if jitter:
        a = a + jitter * _eye(a)
    counts['cholesky'] += 1
    chol, _ = torch.linalg.cholesky_ex(symmetrize(a))
    return chol


def cholesky_solve(b, chol):
    """Solve A x = b given chol(A) (batched over leading axes)."""
    counts['solve'] += 1
    return torch.cholesky_solve(b, chol)


def chol_logdet(chol):
    """log|A| from chol(A): 2 * sum(log(diag))."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)


def logdet_psd(a):
    """log-determinant of a PSD matrix via Cholesky (batched)."""
    return chol_logdet(cholesky(a))


def inv_psd(a):
    """Inverse of a PSD matrix (batched), by Cholesky solve."""
    return inv_psd_chol(a)[0]


def inv_psd_chol(a):
    """(A^{-1}, chol(A)) of a PSD matrix (batched): `inv_psd` and the
    factor it solved with."""
    chol = cholesky(a)
    return cholesky_solve(_eye(a).expand(a.shape), chol), chol


def solve_psd(a, b):
    """Solve A x = b for PSD A (batched over leading axes)."""
    return cholesky_solve(b, cholesky(a))


def mvdigamma(a, d):
    """Multivariate digamma: sum_{i=0..d-1} digamma(a - i/2)."""
    i = torch.arange(d, dtype=a.dtype, device=a.device)
    return torch.sum(torch.digamma(a[..., None] - 0.5 * i), dim=-1)


def mvgammaln(a, d):
    """Multivariate log-gamma, log Gamma_d(a)."""
    i = torch.arange(d, dtype=a.dtype, device=a.device)
    const = 0.25 * d * (d - 1) * math.log(math.pi)
    return const + torch.sum(torch.lgamma(a[..., None] - 0.5 * i), dim=-1)


def quad_form(x, a, m=None):
    """Batched quadratic form (x - m)^T A (x - m) -> (N, K).

    x: (N, d) data; a: (K, d, d) PSD matrices; m: optional (K, d) centers.
    The (N, d^2) squared-feature matrix is built once (independent of K)
    and contracted against the flattened matrices in one matmul."""
    n, d = x.shape
    k = a.shape[0]
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    quad = xx @ a.reshape(k, d * d).T
    if m is not None:
        am = torch.einsum('kde,ke->kd', a, m)
        mam = torch.einsum('kd,kd->k', m, am)
        quad = quad - 2.0 * (x @ am.T) + mam
    return quad
