"""Multi-chain convergence diagnostics: split R-hat and effective sample
size over `fit_chains` outputs (the port's own copy of
mimo_tpu/parallel/diagnostics.py, NumPy only).

The reference's only multi-run diagnostic is best-of-N ELBO selection
(examples/gmm/sine/svi_gmm.py:57-67). `fit_chains` runs C restarts of a
fused engine as one program (one kernel launch a sweep for all chains),
so proper diagnostics come with them:

    states, lls = fit_chains(m, 'fit_gibbs', x, keys,
                             maxiter=500, track_loglik=True)
    rhat = split_rhat(lls)        # (chains, draws) -> scalar
    n_eff = ess(lls)

Anything with a per-sweep trace works: Gibbs log-likelihoods, ELBO
traces, or parameter scalars you stack yourself. Both functions accept
(chains, draws) or (chains, draws, *stat) and reduce over the first two
axes; tensors are read through numpy (on the host).

References: Gelman & Rubin 1992; Vehtari, Gelman, Simpson, Carpenter,
Burkner 2021 (split-R-hat, rank normalization); Geyer 1992 (initial
positive sequence for the ESS autocovariance truncation). Host-side
NumPy: diagnostics are post-fit, O(chains * draws), tiny next to the
fits themselves.
"""

import numpy as np

__all__ = ['split_rhat', 'ess', 'rank_normalize', 'diagnostics']


def _host(x):
    """float64 numpy of an array or a (CPU or CUDA) tensor."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _split(x):
    """(C, T, ...) -> (2C, T//2, ...): split each chain in half so a
    trending single chain is caught as between-half disagreement."""
    x = _host(x)
    if x.ndim < 2:
        raise ValueError('need (chains, draws[, ...])')
    if x.shape[1] < 4:
        raise ValueError(
            f'need >= 4 draws per chain for split diagnostics, got '
            f'{x.shape[1]} (each half must have >= 2 samples for a '
            f'ddof=1 variance)')
    t = x.shape[1] - (x.shape[1] % 2)
    half = t // 2
    return np.concatenate([x[:, :half], x[:, half:t]], axis=0)


def _norm_ppf(p):
    """Standard-normal inverse CDF without scipy: stdlib
    statistics.NormalDist().inv_cdf (Wichura AS241), vectorized.
    The diagnostics need nothing beyond numpy."""
    from statistics import NormalDist
    inv = NormalDist().inv_cdf
    p = np.asarray(p, np.float64)
    return np.fromiter((inv(float(v)) for v in p.ravel()),
                       np.float64, p.size).reshape(p.shape)


def rank_normalize(x):
    """Rank-normalize draws over (chains, draws) jointly (Vehtari et al.
    2021 eq. 14): robust R-hat/ESS for heavy-tailed quantities (e.g.
    early-sweep log-likelihoods)."""
    x = _host(x)
    c, t = x.shape[:2]
    flat = x.reshape(c * t, -1)
    r = np.empty_like(flat)
    for j in range(flat.shape[1]):
        order = np.argsort(flat[:, j], kind='stable')
        ranks = np.empty(c * t)
        ranks[order] = np.arange(1, c * t + 1)
        r[:, j] = _norm_ppf((ranks - 0.375) / (c * t + 0.25))
    return r.reshape(x.shape)


def split_rhat(x, rank_normalized=False):
    """Split-R-hat over (chains, draws[, *stat]) -> scalar or (*stat).

    < 1.01: converged by the modern standard (Vehtari et al. 2021);
    the classic 1.1 threshold is generous. Returns inf when a chain is
    constant while others differ (W = 0 with B > 0)."""
    x = _host(x)
    if rank_normalized:
        x = rank_normalize(x)
    x = _split(x)
    c, t = x.shape[:2]
    mean = x.mean(axis=1)                      # (2C, *stat)
    var = x.var(axis=1, ddof=1)
    w = var.mean(axis=0)                       # within
    b = t * mean.var(axis=0, ddof=1)           # between
    var_plus = (t - 1) / t * w + b / t
    with np.errstate(divide='ignore', invalid='ignore'):
        out = np.sqrt(var_plus / w)
        out = np.where((w == 0) & (b > 0), np.inf, out)
        out = np.where((w == 0) & (b == 0), 1.0, out)
    return out[()] if out.ndim == 0 else out


def _ess_1d(x):
    """ESS of (2C, T) split draws for ONE statistic (Geyer initial
    monotone positive pair sums over the multi-chain autocorrelation)."""
    c, t = x.shape
    mean = x.mean(axis=1)
    var = x.var(axis=1, ddof=1)
    w = var.mean()
    var_plus = (t - 1) / t * w + mean.var(ddof=1)   # + B/T
    if var_plus == 0 or w == 0:
        return float(c * t)
    # per-chain autocovariance via FFT, averaged over chains
    xc = x - mean[:, None]
    npad = int(2 ** np.ceil(np.log2(2 * t)))
    f = np.fft.rfft(xc, npad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), npad, axis=1)[:, :t].real / t
    rho = 1.0 - (w - acov.mean(axis=0)) / var_plus      # rho[0] ~= 1
    # Geyer: sum pair sums while positive, enforcing monotone decrease
    tau = 0.0
    prev = np.inf
    for k in range(0, t - 1, 2):
        pair = rho[k] + (rho[k + 1] if k + 1 < t else 0.0)
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        tau += pair
    tau = max(2.0 * tau - 1.0, 1.0 / (c * t))  # tau = 1 for iid
    return float(c * t / tau)


def ess(x):
    """Effective sample size over (chains, draws[, *stat]) -> scalar or
    (*stat). ~chains*draws for iid draws; n(1-rho)/(1+rho)-ish for an
    AR(1) chain."""
    x = _split(x)
    if x.ndim == 2:
        return _ess_1d(x)
    stat_shape = x.shape[2:]
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    out = np.array([_ess_1d(flat[:, :, j])
                    for j in range(flat.shape[2])])
    return out.reshape(stat_shape)


def diagnostics(traces, rank_normalized=True):
    """One-call summary for a (chains, draws) trace stack from
    fit_chains: {'rhat', 'ess', 'rhat_rank', 'n'} — print it, log it,
    or gate a re-run on rhat > 1.01."""
    traces = _host(traces)
    return {
        'rhat': float(np.max(split_rhat(traces))),
        'rhat_rank': float(np.max(split_rhat(traces, rank_normalized=True)))
        if rank_normalized else None,
        'ess': float(np.min(ess(traces))),
        'n': int(traces.shape[0] * traces.shape[1]),
    }
