"""Kernel B2's plain PyTorch version (ops/cuda_gibbs.py, ops/philox.py)
and the fused Gibbs twin: plug-in theta against mimo_tpu, one-hot
statistics consistent with the labels, labels distributed as the softmax
of the log-densities, labels independent of the blocking, and the Philox
generator against the Random123 known answers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.ops import family_estep as jfe

from mimo_tpu_torch.distributions.niw import NIW, mode_params
from mimo_tpu_torch.ops import cuda_gibbs
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.ops.cuda_estep import pad_theta
from mimo_tpu_torch.ops.philox import philox4x32_10, uniforms

torch.set_num_threads(1)


def _params(dtype=torch.float64, k=6, d=2, seed=5):
    rng = np.random.default_rng(seed)
    post = NIW(mu=torch.as_tensor(rng.standard_normal((k, d)), dtype=dtype),
               kappa=torch.as_tensor(rng.uniform(1, 5, k), dtype=dtype),
               psi=0.7 * torch.eye(d, dtype=dtype).expand(k, d, d),
               nu=torch.as_tensor(rng.uniform(d + 2, d + 8, k), dtype=dtype))
    log_pi = torch.log(torch.full((k,), 1.0 / k, dtype=dtype))
    return mode_params(post), log_pi


@pytest.mark.parametrize('d', [2, 3])
def test_theta_plugin_matches_jax(d):
    params, _ = _params(d=d, seed=d)
    want = jfe.gaussian_spec().theta_plugin(
        JParams(jnp.asarray(params.mu.numpy()),
                jnp.asarray(params.lmbda.numpy())))
    got = tfe.gaussian_spec().theta_plugin(params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize('KAT', [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(KAT):
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    ctr, key, want = KAT
    words = philox4x32_10(tuple(torch.tensor(c) for c in ctr),
                          tuple(torch.tensor(k) for k in key))
    assert tuple(int(w) for w in words) == want


def test_uniforms_are_23_bit_and_keyed_by_point():
    seed = torch.tensor(2 ** 40 + 7)
    u = uniforms(seed, 10, 5, 9, torch.float64)
    assert u.shape == (5, 9)
    assert bool(((u >= 0) & (u < 1)).all())
    assert bool(((u * 2 ** 23) == torch.round(u * 2 ** 23)).all())
    # point 12 is row 2 here and row 0 of a draw starting at 12
    np.testing.assert_array_equal(uniforms(seed, 12, 1, 9, torch.float64)[0],
                                  u[2])


def _onehot_acc(labels, feats, k):
    oh = np.eye(k)[labels.numpy()]
    return oh.T @ feats


def test_acc_equals_onehot_of_labels():
    params, log_pi = _params()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((1000, 2)) * 2)
    spec = tfe.gaussian_spec()
    seed = torch.tensor(99)
    labels, res = tfe.fused_gibbs_blockwise(spec, seed, params, log_pi, (x,),
                                            256)
    feats = spec.features((x,)).numpy()
    acc = _onehot_acc(labels, feats, 6)
    np.testing.assert_allclose(res.counts.numpy(), acc[:, 0], rtol=1e-12)
    np.testing.assert_allclose(res.stats.x.numpy(), acc[:, 1:3], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(res.stats.xxT.reshape(6, 4).numpy(), acc[:, 3:],
                               rtol=1e-12, atol=1e-12)
    # the kernel-layout plain version: same labels, same statistics
    theta, m = pad_theta(spec.theta_plugin(params), log_pi, torch.float64)
    lab2, acc2 = cuda_gibbs.gibbs_plain(x.T.contiguous(), theta, seed, 1000)
    np.testing.assert_array_equal(lab2.numpy(), labels.numpy())
    np.testing.assert_allclose(acc2[:, :m].numpy(), acc, rtol=1e-12,
                               atol=1e-12)


def test_labels_independent_of_blocking():
    params, log_pi = _params(torch.float32)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1500, 2)),
                        dtype=torch.float32)
    spec = tfe.gaussian_spec()
    seed = torch.tensor(1234567)
    runs = [tfe.fused_gibbs_blockwise(spec, seed, params, log_pi, (x,), b)[0]
            for b in (100, 512, 1500)]
    theta, _ = pad_theta(spec.theta_plugin(params), log_pi, torch.float32)
    runs.append(cuda_gibbs.gibbs(x.T.contiguous(), theta, seed, 1500)[0])
    for r in runs[1:]:
        np.testing.assert_array_equal(r.numpy(), runs[0].numpy())
    other = tfe.fused_gibbs_blockwise(spec, torch.tensor(1234568), params,
                                      log_pi, (x,), 512)[0]
    assert bool((other != runs[0]).any())


def test_label_frequencies_follow_softmax():
    """2^16 points at each of 4 distinct x: per-x label counts within
    5 sigma of the softmax of the plug-in log-densities."""
    params, log_pi = _params(torch.float32, k=5, seed=3)
    xs = torch.tensor([[0.0, 0.0], [1.0, -1.0], [-0.5, 2.0], [0.3, 0.3]])
    reps = 1 << 16
    x = xs.repeat_interleave(reps, 0)
    spec = tfe.gaussian_spec()
    theta, _ = pad_theta(spec.theta_plugin(params), log_pi, torch.float32)
    labels, _ = cuda_gibbs.gibbs_plain(x.T.contiguous(), theta,
                                       torch.tensor(5), x.shape[0])
    logp = (spec.features((xs.double(),))
            @ spec.theta_plugin(_params(torch.float64, k=5, seed=3)[0]).T
            + log_pi.double())
    probs = torch.softmax(logp, -1).numpy()
    for i in range(4):
        counts = np.bincount(labels[i * reps:(i + 1) * reps].numpy(),
                             minlength=5)
        expected = probs[i] * reps
        sigma = np.sqrt(reps * probs[i] * (1 - probs[i]))
        assert np.all(np.abs(counts - expected) <= 5 * sigma + 1), (
            i, counts, expected)


def test_gibbs_plain_handles_empty_and_tail():
    params, log_pi = _params(torch.float32)
    theta, _ = pad_theta(tfe.gaussian_spec().theta_plugin(params), log_pi,
                         torch.float32)
    xt = torch.randn(2, 300, generator=torch.Generator().manual_seed(0))
    lab0, acc0 = cuda_gibbs.gibbs(xt, theta, torch.tensor(1), 0)
    assert lab0.shape == (0,) and float(acc0.abs().sum()) == 0.0
    lab, _ = cuda_gibbs.gibbs(xt, theta, torch.tensor(1), 257)
    full, _ = cuda_gibbs.gibbs(xt, theta, torch.tensor(1), 300)
    np.testing.assert_array_equal(lab.numpy(), full[:257].numpy())
    assert int(lab.min()) >= 0 and int(lab.max()) < 6
