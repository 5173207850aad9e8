"""The CUDA kernels B1-B3 against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; run them
on the card with `python -m pytest tests/test_torch_kernels.py -m cuda`.
`chip_smoke.py` holds the same kernels to their plain versions at the
main path's shapes."""

import pytest
import torch

from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs, cuda_predict

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _inputs(dev, n, k, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = 1 + d + d * d
    m8 = -(-m // 8) * 8
    xt = torch.randn((d, n), generator=g, device=dev) * 2
    theta = torch.randn((k, m8), generator=g, device=dev) * 0.3
    theta[:, m:] = 0.0
    theta[:, 1 + d:m] = -0.2 * torch.eye(d, device=dev).reshape(1, -1)
    return xt, theta


@pytest.mark.parametrize('n,k,d', [(100003, 50, 2), (1000, 7, 3)])
def test_estep_kernel_matches_plain_and_repeats(dev, n, k, d):
    xt, theta = _inputs(dev, n, k, d)
    acc, lse = cuda_estep.estep(xt, theta, n)
    acc2, lse2 = cuda_estep.estep(xt, theta, n)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n)
    torch.testing.assert_close(acc, pacc, rtol=1e-4, atol=1e-3 * n / 1e6)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    assert torch.equal(acc, acc2) and torch.equal(lse, lse2)


def test_gibbs_kernel_matches_plain(dev):
    n, k, d = 100003, 50, 2
    xt, theta = _inputs(dev, n, k, d, seed=1)
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert float((labels != plabels).float().mean()) <= 1e-4
    f = cuda_estep.assemble_features(xt, theta.shape[1]).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    ref = oh.T @ f.T
    bound = 1e-5 * (oh.T @ f.abs().T) + 1e-6
    assert bool(((acc.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize('studentt', [True, False])
def test_predict_kernel_matches_plain(dev, studentt):
    n, k, d = 100003, 50, 2
    xt, _ = _inputs(dev, n, k, d, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    thq = torch.rand((k, 8), generator=g, device=dev)
    aux = torch.rand((k, 8), generator=g, device=dev)
    out = cuda_predict.predict(xt, thq, aux, n, studentt)
    ref = cuda_predict.predict_plain(xt, thq, aux, n, studentt)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xt, theta = _inputs(dev, 1000, 7, 2)
    with pytest.raises(TypeError):
        cuda_estep.estep(xt.double(), theta.double(), 1000)
    with pytest.raises(ValueError):
        cuda_estep.estep(xt, theta, 1001)
    wide_x, wide_theta = _inputs(dev, 100, 256, 32)
    with pytest.raises(NotImplementedError, match='shared memory'):
        cuda_estep.estep(wide_x, wide_theta, 100)


def test_engines_kernel_path_tracks_plain_path(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    init, _ = m.fit_vi_fused(x, key=1, maxiter=2, backend='torch')
    before = cuda_estep.launches
    _, v_k = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='auto')
    assert cuda_estep.launches == before + 10
    _, v_t = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='torch')
    torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
    lp_k = m.log_predictive(init, x, backend='kernel')
    lp_t = m.log_predictive(init, x, backend='torch')
    torch.testing.assert_close(lp_k, lp_t, rtol=1e-5, atol=1e-4)
    gs = m.fit_gibbs_fused(x, key=2, maxiter=5, backend='kernel')
    assert bool(torch.isfinite(gs.log_pi).all())
