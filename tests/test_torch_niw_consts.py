"""The NIW algebra that factors each matrix once a sweep, in float64: the
fixed prior's constants (`niw.prior_constants`) and the update's aux
(`posterior_update(..., with_aux=True)`) against the plain calls, the
factorization counters (`utils.linalg.counts`, `niw.prior_consts`) of a
fused VI and Gibbs sweep, and the fused engines against the same engines
built on the plain functions (a family without prior constants)."""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import mimo_tpu.distributions.niw as jn

import mimo_tpu_torch.distributions.niw as tn
from mimo_tpu_torch.conjugate.families import (
    diag_gaussian_family, gaussian_family, hier_gaussian_family,
    linear_family, tied_family,
)
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.utils import linalg as tl
from mimo_tpu_torch.utils.tree import tree_where

torch.set_num_threads(1)
DIMS = [1, 2, 3, 8, 32]
K = 5


def _psd(gen, lead, d, scale):
    a = torch.randn(lead + (d, d), generator=gen, dtype=torch.float64)
    return scale * (a @ a.transpose(-1, -2) / d
                    + torch.eye(d, dtype=torch.float64))


def _prior(gen, d):
    return tn.NIW(mu=torch.randn((K, d), generator=gen, dtype=torch.float64),
                  kappa=0.05 + torch.rand((K,), generator=gen,
                                          dtype=torch.float64),
                  psi=_psd(gen, (K,), d, 0.5),
                  nu=d + 2.0 + 5.0 * torch.rand((K,), generator=gen,
                                                dtype=torch.float64))


def _stats(gen, d, lead=()):
    """Random weighted statistics of 200 points (a chain's own on `lead`)."""
    x = 3.0 * torch.randn(lead + (200, d), generator=gen,
                          dtype=torch.float64)
    resp = torch.softmax(torch.randn(lead + (200, K), generator=gen,
                                     dtype=torch.float64), -1)
    if not lead:
        return tn.suff_stats(x, resp)
    return vmap(tn.suff_stats)(x, resp)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


@pytest.mark.parametrize('chains', [None, 3])
@pytest.mark.parametrize('d', DIMS)
def test_kl_with_constants_and_aux_equals_plain(d, chains):
    """KL(q || p) from p's constants and q's aux (no factorization) equals
    the plain call at rtol 1e-12, one state or vmapped over 3 chains, and
    the JAX package's KL at rtol 1e-8."""
    gen = torch.Generator().manual_seed(100 + d)
    p = _prior(gen, d)
    consts = tn.prior_constants(p)
    lead = () if chains is None else (chains,)
    stats = _stats(gen, d, lead)

    def cached(s):
        q, aux = tn.posterior_update(p, s, consts, with_aux=True)
        return q, tn.kl_divergence(q, p, consts, aux)

    def plain(q):
        return tn.kl_divergence(q, p)

    over = (lambda f: f) if chains is None else vmap
    q, kl = over(cached)(stats)
    want = over(plain)(q)
    tl.counts.update(cholesky=0, solve=0)
    over(lambda s: cached(s)[1])(stats)
    assert tl.counts == {'cholesky': 1, 'solve': 1}     # the update's only
    np.testing.assert_allclose(kl.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)
    for c in range(lead[0] if lead else 1):
        qc = q if not lead else tn.NIW(*(a[c] for a in q))
        kc = kl if not lead else kl[c]
        ref = jn.kl_divergence(
            jn.NIW(*(jnp.asarray(a.numpy()) for a in qc)),
            jn.NIW(*(jnp.asarray(a.numpy()) for a in p)))
        np.testing.assert_allclose(kc.numpy(), np.asarray(ref), rtol=1e-8)


@pytest.mark.parametrize('d', DIMS)
def test_update_with_constants_is_bitwise_plain(d):
    """The update that reads the prior's constants gives the plain
    update's posterior bit for bit; its aux holds the posterior's psi^{-1}
    and log|psi|."""
    gen = torch.Generator().manual_seed(200 + d)
    p = _prior(gen, d)
    stats = _stats(gen, d)
    consts = tn.prior_constants(p)
    want = tn.posterior_update(p, stats)
    for got in (tn.posterior_update(p, stats, consts),
                tn.posterior_update(p, stats, consts, with_aux=True)[0],
                tn.posterior_update(p, stats, with_aux=True)[0]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, aux = tn.posterior_update(p, stats, consts, with_aux=True)
    np.testing.assert_allclose(
        (aux.psi_inv @ want.psi).numpy(),
        np.broadcast_to(np.eye(d), (K, d, d)), atol=1e-10)
    np.testing.assert_allclose(aux.logdet.numpy(),
                               torch.logdet(want.psi).numpy(), rtol=1e-11)
    built = tn.psi_aux(want)
    np.testing.assert_allclose(built.psi_inv.numpy(), aux.psi_inv.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(built.logdet.numpy(), aux.logdet.numpy(),
                               rtol=1e-11)


def _chol(a):
    return torch.linalg.cholesky_ex(0.5 * (a + a.transpose(-1, -2)))[0]


def _inv(a):
    eye = torch.eye(a.shape[-1], dtype=a.dtype).expand(a.shape)
    return torch.cholesky_solve(eye, _chol(a))


def _logdet(chol):
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)


def _mv(fn, a, d):
    i = torch.arange(d, dtype=a.dtype)
    return torch.sum(fn(a[..., None] - 0.5 * i), dim=-1)


def _log_partition_before(p):
    d = p.dim
    logz_w = (0.5 * p.nu * d * math.log(2.0)
              + (0.25 * d * (d - 1) * math.log(math.pi)
                 + _mv(torch.lgamma, 0.5 * p.nu, d))
              + 0.5 * p.nu * _logdet(_chol(p.psi)))
    return -0.5 * d * torch.log(p.kappa) + logz_w


def _nat_before(p):
    d = p.dim
    kmm = p.kappa[..., None, None] * (p.mu[..., :, None] * p.mu[..., None, :])
    return tn.GaussStats(x=p.kappa[..., None] * p.mu, n1=p.kappa,
                         xxT=_inv(p.psi) + kmm, n2=p.nu - d)


def _kl_before(q, p):
    """The KL as the port computed it before the prior's constants."""
    d = q.dim
    e_lm = torch.einsum('k,kde,ke->kd', q.nu, q.psi, q.mu)
    e_mlm = -0.5 * (d / q.kappa + torch.einsum('kd,kd->k', q.mu, e_lm))
    e_l = -0.5 * q.nu[..., None, None] * q.psi
    e_logdet = 0.5 * (_mv(torch.digamma, 0.5 * q.nu, d) + d * math.log(2.0)
                      + _logdet(_chol(q.psi)))
    nq, np_ = _nat_before(q), _nat_before(p)
    inner = (torch.einsum('kd,kd->k', nq.x - np_.x, e_lm)
             + (nq.n1 - np_.n1) * e_mlm
             + torch.einsum('kde,kde->k', nq.xxT - np_.xxT, e_l)
             + (nq.n2 - np_.n2) * e_logdet)
    return _log_partition_before(p) - _log_partition_before(q) + inner


def _update_before(prior, stats):
    """The update as the port computed it before the prior's constants."""
    kappa_n = prior.kappa + stats.n1
    mu_n = (prior.kappa[..., None] * prior.mu + stats.x) / kappa_n[..., None]
    xbar = stats.x / torch.clamp(stats.n1, min=1e-12)[..., None]
    scatter = stats.xxT - stats.n1[..., None, None] * (
        xbar[..., :, None] * xbar[..., None, :])
    dm = xbar - prior.mu
    coef = prior.kappa * stats.n1 / kappa_n
    psi_inv_n = (_inv(prior.psi) + scatter
                 + coef[..., None, None] * (dm[..., :, None] * dm[..., None, :]))
    return tn.NIW(mu=mu_n, kappa=kappa_n, psi=_inv(psi_inv_n),
                  nu=prior.nu + stats.n2)


@pytest.mark.parametrize('d', DIMS)
def test_plain_calls_are_bitwise_as_before(d):
    """A caller that hands no constants (dense fit_vi, SVI, the streams,
    the nested models, the tied pooling) gets the same bits as the
    arithmetic before the constants existed."""
    gen = torch.Generator().manual_seed(300 + d)
    p = _prior(gen, d)
    stats = _stats(gen, d)
    q = tn.posterior_update(p, stats)
    assert all(torch.equal(a, b)
               for a, b in zip(q, _update_before(p, stats)))
    assert torch.equal(tn.kl_divergence(q, p), _kl_before(q, p))
    assert torch.equal(tn.log_partition(q), _log_partition_before(q))


@pytest.mark.parametrize('family', [
    'gaussian', 'tied', 'diag', 'hier', 'linear'])
def test_only_niw_offers_prior_constants(family):
    """The engines take the factored path where the family offers the
    prior's constants: the NIW family alone (the tied pooling replaces the
    update's inverse scale)."""
    fam = {'gaussian': gaussian_family, 'diag': diag_gaussian_family,
           'hier': hier_gaussian_family, 'linear': linear_family,
           'tied': lambda: tied_family(gaussian_family())}[family]()
    offers = family == 'gaussian'
    assert (fam.prior_consts is not None) == offers
    assert (fam.psi_aux is not None) == offers


def _blobs():
    gen = torch.Generator().manual_seed(7)
    centres = 4.0 * torch.randn((3, 3), generator=gen, dtype=torch.float64)
    return centres[torch.arange(900) % 3] + 0.7 * torch.randn(
        (900, 3), generator=gen, dtype=torch.float64)


def _models():
    model = BayesianGMM.make(size=6, dim=3, gating='dp', kappa=0.05,
                             psi_scale=0.5, dtype=torch.float64,
                             device='cpu')
    plain = copy.copy(model)
    plain.family = model.family._replace(prior_consts=None, psi_aux=None)
    return model, plain


def _counted(fn):
    tl.counts.update(cholesky=0, solve=0)
    tn.prior_consts.update(built=0, reused=0)
    out = fn()
    return out, dict(tl.counts), dict(tn.prior_consts)


def _engine_call(engine, chains, tol, x, maxiter, start=None):
    keys = [1, 2, 3] if chains == 3 else 1
    kw = dict(key=keys, maxiter=maxiter, backend='torch',
              chains=chains == 3)
    if engine == 'fit_gibbs_fused':
        return lambda m: m.fit_gibbs_fused(x, **kw)
    return lambda m: m.fit_vi_fused(x, tol=tol, init_state=start,
                                    randomize=start is None, **kw)


CASES = [('fit_vi_fused', 1, None), ('fit_vi_fused', 3, None),
         ('fit_vi_fused', 1, 1e-12), ('fit_vi_fused', 3, 1e-12),
         ('fit_gibbs_fused', 1, None), ('fit_gibbs_fused', 3, None)]


@pytest.mark.parametrize('engine,chains,tol', CASES)
def test_sweep_factorizations(engine, chains, tol):
    """After a call's first sweep a fused VI sweep factors twice (the
    update's psi^{-1} and B1's theta) and solves once; a Gibbs sweep
    factors four times (two draws, theta, the update) and solves once.
    The prior's constants are built once a call and read by every
    sweep's update (and KL)."""
    model, _ = _models()
    x = _blobs()
    per = {'fit_vi_fused': (2, 1, 2), 'fit_gibbs_fused': (4, 1, 1)}[engine]
    seen = []
    for maxiter in (3, 4):
        _, counts, consts = _counted(
            lambda: _engine_call(engine, chains, tol, x, maxiter)(model))
        assert consts == {'built': 1, 'reused': per[2] * maxiter}
        seen.append(counts)
    assert (seen[1]['cholesky'] - seen[0]['cholesky'],
            seen[1]['solve'] - seen[0]['solve']) == per[:2]


def _vi_start(model, x, chains, converged_first):
    """A 2-sweep VI state; with `converged_first` chain 0's a 60-sweep
    one, so that a tol stops chain 0 while the others run on."""
    keys = [4, 5, 6] if chains == 3 else 4
    start, _ = model.fit_vi_fused(x, key=keys, chains=chains == 3,
                                  maxiter=2, backend='torch')
    if not converged_first:
        return start
    done, _ = model.fit_vi_fused(x, key=keys, chains=True, maxiter=60,
                                 backend='torch')
    first = torch.arange(chains) == 0
    return tree_where(first, done, start)


@pytest.mark.parametrize('engine,chains,tol', CASES + [
    ('fit_vi_fused', 3, 0.1)])
def test_factored_engine_matches_plain_engine(engine, chains, tol):
    """The fused engines on the factored path against the same engines
    built on the plain functions (the family without prior constants):
    VI's states bit for bit and its traces at rtol 1e-10 (only the KL's
    f64 round trips differ), Gibbs bit for bit. At tol=0.1 from a start
    whose chain 0 has converged, chain 0 stops while the others run on,
    so the aux is selected chain by chain."""
    model, plain = _models()
    x = _blobs()
    start = None
    if engine == 'fit_vi_fused':
        start = _vi_start(model, x, chains, tol == 0.1)
    call = _engine_call(engine, chains, tol, x, 25, start)
    got, want = call(model), call(plain)
    if engine == 'fit_gibbs_fused':
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(got), _leaves(want)))
        return
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(got[0]), _leaves(want[0])))
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-10)
    if tol == 0.1:
        stopped = [int((row[1:] == row[:-1]).sum()) for row in got[1]]
        assert min(stopped) < max(stopped), stopped
