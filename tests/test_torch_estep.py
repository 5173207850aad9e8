"""Kernel B1's plain PyTorch version (ops/cuda_estep.py) and the fused
E-step twins (ops/family_estep.py) against mimo_tpu: the Pallas E-step in
interpret mode (float32, the tolerances of tests/test_pallas.py) and the
XLA blockwise engine (float64, rtol 1e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import NIW as JNIW
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas

from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.ops import cuda_estep
from mimo_tpu_torch.ops import family_estep as tfe

torch.set_num_threads(1)


def _problem(dtype, n=1000, k=6, d=2, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * 2
    post = dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(1, 5, k),
                psi=np.broadcast_to(0.7 * np.eye(d), (k, d, d)).copy(),
                nu=rng.uniform(d + 2, d + 8, k))
    log_pi = np.log(rng.dirichlet(np.ones(k)))
    jd = jnp.float32 if dtype == 'f32' else jnp.float64
    td = torch.float32 if dtype == 'f32' else torch.float64
    jax_side = (jnp.asarray(x, jd),
                JNIW(**{f: jnp.asarray(v, jd) for f, v in post.items()}),
                jnp.asarray(log_pi, jd))
    torch_side = (torch.as_tensor(x, dtype=td),
                  NIW(**{f: torch.as_tensor(v, dtype=td)
                         for f, v in post.items()}),
                  torch.as_tensor(log_pi, dtype=td))
    return jax_side, torch_side


def _assert_stats(got, want, rtol, atol):
    for g, w in zip(got.stats, want.stats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=rtol, atol=atol)


def test_plain_matches_pallas_interpret_ragged_tail():
    """N=1000 over blocks of 256: the Pallas launcher pads and masks the
    tail; the plain version stops at n (it also ignores columns past n)."""
    (xj, pj, lpj), (xt_, pt, lpt) = _problem('f32')
    n = xj.shape[0]
    xt_pad = jnp.pad(xj.T, ((0, 0), (0, (-n) % 256)))
    want = fused_estep_pallas(jfe.gaussian_spec(), pj, lpj, (xt_pad,), 256, n)
    padded = torch.cat([xt_.T, torch.full((2, 24), 1e3)], 1)
    got = cuda_estep.fused_estep_cuda(tfe.gaussian_spec(), pt, lpt,
                                      (padded,), n)
    _assert_stats(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


@pytest.mark.parametrize('d', [2, 3])
def test_plain_matches_blockwise_f64(d):
    (xj, pj, lpj), (xt_, pt, lpt) = _problem('f64', n=777, k=5, d=d, seed=d)
    want = jfe.fused_estep_blockwise(jfe.gaussian_spec(), pj, lpj, (xj,), 259)
    got = cuda_estep.fused_estep_cuda(tfe.gaussian_spec(), pt, lpt,
                                      (xt_.T.contiguous(),), xt_.shape[0])
    _assert_stats(got, want, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-8)


@pytest.mark.parametrize('engine', ['blockwise', 'dense'])
def test_fused_twins_match_jax_f64(engine):
    (xj, pj, lpj), (xt_, pt, lpt) = _problem('f64', n=900, seed=9)
    if engine == 'blockwise':
        want = jfe.fused_estep_blockwise(jfe.gaussian_spec(), pj, lpj, (xj,),
                                         300)
        got = tfe.fused_estep_blockwise(tfe.gaussian_spec(), pt, lpt, (xt_,),
                                        128)        # ragged last block
    else:
        want = jfe.fused_estep_dense(jfe.gaussian_spec(), pj, lpj, (xj,))
        got = tfe.fused_estep_dense(tfe.gaussian_spec(), pt, lpt, (xt_,))
    _assert_stats(got, want, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-8)


@pytest.mark.parametrize('part', ['features', 'features_t', 'theta'])
def test_spec_pieces_match_jax(part):
    (xj, pj, _), (xt_, pt, _) = _problem('f64', n=50, d=3, seed=2)
    js, ts = jfe.gaussian_spec(), tfe.gaussian_spec()
    if part == 'features':
        got, want = ts.features((xt_,)), js.features((xj,))
    elif part == 'features_t':
        got, want = ts.features_t((xt_.T,)), jfe.gauss_features_t((xj.T,))
    else:
        got, want = ts.theta(pt), js.theta(pj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def test_pad_theta_folds_log_pi():
    theta = torch.arange(14.0).reshape(2, 7)
    out, m = cuda_estep.pad_theta(theta, torch.tensor([1.0, -1.0]),
                                  torch.float32)
    assert m == 7 and out.shape == (2, 8) and out.is_contiguous()
    assert out[:, 0].tolist() == [1.0, 6.0] and out[:, 7].tolist() == [0, 0]


def test_kernel_entry_refuses_other_feature_maps():
    """The kernel wrapper's CPU branch is the plain version; the spec-level
    entry refuses feature maps the kernel does not assemble."""
    spec = tfe.gaussian_spec()._replace(features_t=lambda ts: ts[0])
    (_, (xt_, pt, lpt)) = _problem('f32', n=10)
    with pytest.raises(NotImplementedError):
        cuda_estep.fused_estep_cuda(spec, pt, lpt, (xt_.T.contiguous(),), 10)
