"""The CUDA kernels (B1-B3, B1/B2 over the ILR map on a full or a
diagonal basis, B1-B3 over the diagonal map, B4, B5 and B6 with MNW and
MNG experts, B3 on HierTied rows, B5/B6 with tied-affine experts and a
HierTied basis, the B1 probes S1 and S2, S3, the nested mixtures' paths
through B1/B2/B3 at M*K rows and B5/B6 over flattened experts, B1/B2
with a chain axis and the chained fused engines, flat and nested, and B1
a block at a time in the out-of-core engines through the staged buffers)
against their plain PyTorch versions, on the card; and the Geweke test
of the full Gibbs transition through B2 (gmm, hier).
Every test here needs a CUDA device and skips without one; run them on
the card with
`python -m pytest --noconftest tests/test_torch_kernels.py -m cuda`.
`chip_smoke.py` holds the same kernels to their plain versions at the
main paths' shapes."""

import pytest
import torch

from mimo_tpu_torch.distributions.affine import TiedAffine
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.ops import (
    _build, cuda_diag_predict, cuda_estep, cuda_gibbs, cuda_hello,
    cuda_ilr_predict, cuda_predict, cuda_probes)
from mimo_tpu_torch.ops.cuda_estep import DIAG, ILR

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
    # past shared memory (d=32, K=256) the streamed layout launches; only
    # scratch past device memory is refused (6,000 chains of K=300)
    wide_x, wide_theta = _inputs(dev, 100, 256, 32)
    _check_estep(wide_x, wide_theta, 100, cuda_estep.GAUSS, 0)
    many = _inputs(dev, 100, 300, 2)[1].expand(6000, -1, -1).contiguous()
    with pytest.raises(NotImplementedError, match='device memory'):
        cuda_estep.estep(wide_x[:2], many, 100)


def test_engines_kernel_path_tracks_plain_path(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    init, _ = m.fit_vi_fused(x, key=1, maxiter=2, backend='torch')
    before = cuda_estep.launches['gauss']
    _, v_k = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='auto')
    assert cuda_estep.launches['gauss'] == before + 10
    _, v_t = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='torch')
    torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
    lp_k = m.log_predictive(init, x, backend='kernel')
    lp_t = m.log_predictive(init, x, backend='torch')
    torch.testing.assert_close(lp_k, lp_t, rtol=1e-5, atol=1e-4)
    gs = m.fit_gibbs_fused(x, key=2, maxiter=5, backend='kernel')
    assert bool(torch.isfinite(gs.log_pi).all())


def _ilr_inputs(dev, n, k, d, p, seed=0, kind=ILR):
    """Stacked [x; y] rows and random coefficients over an ILR map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = cuda_estep.feature_width(kind, d, p)
    m8 = -(-m // 8) * 8
    xt = torch.rand((d + p, n), generator=g, device=dev) * 4 - 2
    theta = torch.randn((k, m8), generator=g, device=dev) * 0.05
    theta[:, m:] = 0.0
    return xt, theta


@pytest.mark.parametrize('n,k,d,p', [(100003, 50, 8, 1), (1000, 7, 2, 3)])
def test_ilr_estep_kernel_matches_plain_and_repeats(dev, n, k, d, p):
    xt, theta = _ilr_inputs(dev, n, k, d, p)
    acc, lse = cuda_estep.estep(xt, theta, n, ILR, p)
    acc2, lse2 = cuda_estep.estep(xt, theta, n, ILR, p)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, ILR, p)
    torch.testing.assert_close(acc, pacc, rtol=1e-4, atol=1e-3 * n / 1e6)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    assert torch.equal(acc, acc2) and torch.equal(lse, lse2)


@pytest.mark.parametrize('n,k,d,p', [(100003, 50, 8, 1), (1000, 7, 2, 3)])
def test_ilr_gibbs_kernel_matches_plain(dev, n, k, d, p):
    xt, theta = _ilr_inputs(dev, n, k, d, p, seed=1)
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n, ILR, p)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n, ILR, p)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert float((labels != plabels).float().mean()) <= 1e-4
    f = cuda_estep.assemble_features(xt, theta.shape[1], ILR, p).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    bound = 1e-5 * (oh.T @ f.abs().T) + 1e-6
    assert bool(((acc.double() - oh.T @ f.T).abs() <= bound).all())


DIAG_BASIS = [(kind, n, k, d, p)
              for kind in (cuda_estep.ILR_DIAG, cuda_estep.ILR_DIAG_LINEAR)
              for n, k, d, p in ((100003, 50, 8, 1), (1000, 7, 2, 3),
                                 (100003, 50, 1, 1))]


@pytest.mark.parametrize('kind,n,k,d,p', DIAG_BASIS)
def test_diag_basis_ilr_estep_kernel_matches_plain_and_repeats(dev, kind, n,
                                                               k, d, p):
    """B1 over the ILR map on a diagonal basis, with and without the
    experts' ones column: its plain version's result, bitwise on repeat."""
    xt, theta = _ilr_inputs(dev, n, k, d, p, kind=kind)
    acc, lse = cuda_estep.estep(xt, theta, n, kind, p)
    acc2, lse2 = cuda_estep.estep(xt, theta, n, kind, p)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, p)
    torch.testing.assert_close(acc, pacc, rtol=1e-4, atol=1e-3 * n / 1e6)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    assert torch.equal(acc, acc2) and torch.equal(lse, lse2)


@pytest.mark.parametrize('kind,n,k,d,p', DIAG_BASIS)
def test_diag_basis_ilr_gibbs_kernel_matches_plain(dev, kind, n, k, d, p):
    """B2 over the same maps: the plain Philox labels and the one-hot sums
    of its own labels."""
    xt, theta = _ilr_inputs(dev, n, k, d, p, seed=1, kind=kind)
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n, kind, p)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n, kind, p)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert float((labels != plabels).float().mean()) <= 1e-4
    f = cuda_estep.assemble_features(xt, theta.shape[1], kind, p).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    bound = 1e-5 * (oh.T @ f.abs().T) + 1e-6
    assert bool(((acc.double() - oh.T @ f.T).abs() <= bound).all())


def test_check_launch_refuses_a_narrow_ilr_theta(dev):
    xt, theta = _ilr_inputs(dev, 1000, 7, 2, 3)
    with pytest.raises(ValueError, match='features of the ilr map'):
        cuda_estep.estep(xt, theta[:, :16].contiguous(), 1000, ILR, 3)


def _ilr_state(dev, k, d, p, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def psd(q, scale):
        a = torch.randn((k, q, q), generator=g, device=dev)
        return scale * (a @ a.transpose(-1, -2) / q
                        + torch.eye(q, device=dev))

    basis = NIW(mu=torch.randn((k, d), generator=g, device=dev),
                kappa=50 + 200 * torch.rand((k,), generator=g, device=dev),
                psi=psd(d, 0.05),
                nu=50 + 200 * torch.rand((k,), generator=g, device=dev))
    experts = MNW(M=torch.randn((k, p, d + 1), generator=g, device=dev),
                  K_=psd(d + 1, 80.0), psi=psd(p, 0.05),
                  nu=50 + 200 * torch.rand((k,), generator=g, device=dev))
    log_w = torch.log_softmax(torch.randn((k,), generator=g, device=dev), 0)
    return basis, experts, log_w


@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('has_y', [True, False])
@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
def test_ilr_predict_kernels_match_plain(dev, d, p, has_y, hard):
    n, k = 100003, 50
    basis, experts, log_w = _ilr_state(dev, k, d, p)
    g = torch.Generator(device=dev).manual_seed(5)
    xt = torch.rand((d + (p if has_y else 0), n), generator=g,
                    device=dev) * 4 - 2
    if p == 1:
        th, aux = cuda_ilr_predict.ilr_predict_coefficients(
            basis, experts, log_w)
        out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, has_y, hard)
        ref = cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n, has_y, hard)
    else:
        th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
            basis, experts, log_w, True, has_y)
        out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p, has_y,
                                             hard)
        ref = cuda_ilr_predict.ilr_p_predict_plain(xt, th, aux, vc, n, p,
                                                   has_y, hard)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[:p], ref[:p], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[p:2 * p], ref[p:2 * p], rtol=2e-3,
                               atol=1e-5)
    torch.testing.assert_close(out[2 * p:], ref[2 * p:], rtol=1e-3,
                               atol=2e-3)


def test_hello_kernel_doubles(dev):
    x = torch.randn((8, 128), device=dev)
    assert torch.equal(cuda_hello.twice(x), 2 * x)


def test_ilr_engines_kernel_path_tracks_plain_path(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((20011, 2), generator=g, device=dev) * 6 - 3
    y = torch.sin(x.sum(-1, keepdim=True)) + 0.1 * torch.randn(
        (20011, 1), generator=g, device=dev)
    m = BayesianILR.make(size=10, input_dim=2, output_dim=1, alpha=2.0,
                         kappa=0.05, device=dev)
    m.init_transform(x, y)
    init, _ = m.fit_vi_fused((x, y), key=1, maxiter=3, backend='torch')
    before = cuda_estep.launches['ilr']
    _, v_k = m.fit_vi_fused((x, y), maxiter=5, init_state=init,
                            randomize=False, backend='kernel')
    assert cuda_estep.launches['ilr'] == before + 5
    _, v_t = m.fit_vi_fused((x, y), maxiter=5, init_state=init,
                            randomize=False, backend='torch')
    torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
    before = cuda_ilr_predict.launches['ilr_predict']
    mu_k, var_k, _, nlpd_k = m.predict(init, x, y, backend='kernel')
    assert cuda_ilr_predict.launches['ilr_predict'] == before + 1
    mu_t, var_t, _, nlpd_t = m.predict(init, x, y, backend='torch')
    torch.testing.assert_close(mu_k, mu_t, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(nlpd_k, nlpd_t, rtol=1e-3, atol=2e-3)
    gs = m.fit_gibbs_fused((x, y), key=2, maxiter=5, backend='kernel')
    assert bool(torch.isfinite(gs.log_pi).all())


# -- the diagonal families ----------------------------------------------------

def _diag_inputs(dev, n, k, d, seed=0):
    """Data and random coefficients over the diagonal map [1; x; x^2]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = 1 + 2 * d
    m8 = -(-m // 8) * 8
    xt = torch.randn((d, n), generator=g, device=dev) * 2
    theta = torch.randn((k, m8), generator=g, device=dev) * 0.3
    theta[:, m:] = 0.0
    theta[:, 1 + d:m] = -0.2
    return xt, theta


@pytest.mark.parametrize('n,k,d', [(100003, 50, 2), (1000, 7, 3)])
def test_diag_estep_kernel_matches_plain_and_repeats(dev, n, k, d):
    xt, theta = _diag_inputs(dev, n, k, d)
    acc, lse = cuda_estep.estep(xt, theta, n, DIAG)
    acc2, lse2 = cuda_estep.estep(xt, theta, n, DIAG)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, DIAG)
    torch.testing.assert_close(acc, pacc, rtol=1e-4, atol=1e-3 * n / 1e6)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    assert torch.equal(acc, acc2) and torch.equal(lse, lse2)


def test_diag_gibbs_kernel_matches_plain(dev):
    n, k, d = 100003, 50, 2
    xt, theta = _diag_inputs(dev, n, k, d, seed=1)
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n, DIAG)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n, DIAG)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert float((labels != plabels).float().mean()) <= 1e-4
    f = cuda_estep.assemble_features(xt, theta.shape[1], DIAG).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    bound = 1e-5 * (oh.T @ f.abs().T) + 1e-6
    assert bool(((acc.double() - oh.T @ f.T).abs() <= bound).all())


def _ng_posterior(dev, k, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((k, d), generator=g, device=dev)
    return NG(mu=torch.randn((k, d), generator=g, device=dev) * 2,
              kappa=u(1.0, 20.0), alpha=u(2.0, 40.0), beta=u(0.5, 5.0))


@pytest.mark.parametrize('dist', ['studentt', 'gaussian'])
def test_diag_predictive_kernels_match_plain(dev, dist):
    """B4 (Student-t) and B3 over the diagonal map (Gaussian) against
    their plain versions at the tolerances of tests/test_pallas.py."""
    n, k, d = 100003, 50, 2
    post = _ng_posterior(dev, k, d)
    log_w = torch.log_softmax(torch.randn((k,), device=dev), 0)
    xt, _ = _diag_inputs(dev, n, k, d, seed=2)
    if dist == 'studentt':
        rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
        out = cuda_diag_predict.diag_predict(xt, rows, aux, n)
        ref = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
    else:
        thq, aux = cuda_predict.diag_gaussian_coefficients(post, log_w)
        out = cuda_predict.predict(xt, thq, aux, n, False, DIAG)
        ref = cuda_predict.predict_plain(xt, thq, aux, n, False, DIAG)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _mng_state(dev, k, d, p, seed=0):
    basis, experts, log_w = _ilr_state(dev, k, d, p, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    alpha = 50 + 200 * torch.rand((k, p), generator=g, device=dev)
    beta = alpha * (0.005 + 0.02 * torch.rand((k, p), generator=g,
                                              device=dev))
    return basis, MNG(M=experts.M, K_=experts.K_, alpha=alpha,
                      beta=beta), log_w


@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('has_y', [True, False])
@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
def test_mng_ilr_predict_kernels_match_plain(dev, d, p, has_y, hard):
    """B5's MNG rows (p = 1) and B6's MNG tail (p = 3)."""
    n, k = 100003, 50
    basis, experts, log_w = _mng_state(dev, k, d, p)
    g = torch.Generator(device=dev).manual_seed(5)
    xt = torch.rand((d + (p if has_y else 0), n), generator=g,
                    device=dev) * 4 - 2
    if p == 1:
        th, aux = cuda_ilr_predict.ilr_predict_coefficients(
            basis, experts, log_w)
        out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, has_y, hard)
        ref = cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n, has_y, hard)
    else:
        th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
            basis, experts, log_w, True, has_y)
        assert vc.shape == (k, 2 * p)
        out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p, has_y,
                                             hard)
        ref = cuda_ilr_predict.ilr_p_predict_plain(xt, th, aux, vc, n, p,
                                                   has_y, hard)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[:p], ref[:p], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[p:2 * p], ref[p:2 * p], rtol=2e-3,
                               atol=1e-5)
    torch.testing.assert_close(out[2 * p:], ref[2 * p:], rtol=1e-3,
                               atol=2e-3)


def test_diag_engines_kernel_path_tracks_plain_path(dev):
    """The diagonal GMM's engines and log_predictive, and the MNG ILR's
    VI and predict, through their kernels against their plain paths."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    m = BayesianGMM.make(size=10, dim=2, diag=True, kappa=0.05, device=dev)
    init, _ = m.fit_vi_fused(x, key=1, maxiter=2, backend='torch')
    before = cuda_estep.launches['diag']
    _, v_k = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='kernel')
    assert cuda_estep.launches['diag'] == before + 10
    _, v_t = m.fit_vi_fused(x, maxiter=10, init_state=init, randomize=False,
                            backend='torch')
    torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
    b4, b3 = cuda_diag_predict.launches, cuda_predict.launches['diag']
    for dist in ('studentt', 'gaussian'):
        lp_k = m.log_predictive(init, x, dist=dist, backend='kernel')
        lp_t = m.log_predictive(init, x, dist=dist, backend='torch')
        torch.testing.assert_close(lp_k, lp_t, rtol=1e-4, atol=1e-4)
    assert cuda_diag_predict.launches == b4 + 1
    assert cuda_predict.launches['diag'] == b3 + 1
    before = cuda_gibbs.launches['diag']
    gs = m.fit_gibbs_fused(x, key=2, maxiter=5, backend='kernel')
    assert cuda_gibbs.launches['diag'] == before + 5
    assert bool(torch.isfinite(gs.log_pi).all())

    y = torch.tanh(x @ torch.randn((2, 3), generator=g, device=dev)) \
        + 0.1 * torch.randn((20011, 3), generator=g, device=dev)
    mi = BayesianILR.make(size=8, input_dim=2, output_dim=3, alpha=2.0,
                          kappa=0.1, diag=True, device=dev)
    mi.init_transform(x, y)
    st, _ = mi.fit_vi_fused((x, y), key=1, maxiter=10, backend='kernel')
    before = cuda_ilr_predict.launches['ilr_p_predict']
    mu_k, var_k, _, nlpd_k = mi.predict(st, x, y, backend='kernel')
    assert cuda_ilr_predict.launches['ilr_p_predict'] == before + 1
    mu_t, var_t, _, nlpd_t = mi.predict(st, x, y, backend='torch')
    scale = float(mi.output_transform.scale.max())
    torch.testing.assert_close(mu_k, mu_t, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(var_k, var_t, rtol=2e-3,
                               atol=1e-4 * scale ** 2)
    torch.testing.assert_close(nlpd_k, nlpd_t, rtol=1e-3, atol=2e-3)


# -- the tied and hierarchical families, and the B1 probes --------------------

def _hier_basis(basis):
    """A HierTied basis with the NIW basis's means and a shared scale."""
    k, d = basis.mu.shape
    return HierTied(
        hyper=NIW(mu=basis.mu[:1], kappa=basis.kappa[:1], psi=basis.psi[:1],
                  nu=basis.nu[:1]),
        mus=basis.mu, kappas=basis.kappa, kappas0=torch.ones_like(
            basis.kappa))


def _tied_experts(experts):
    """Tied-affine experts with the MNW experts' scales: one slope, the
    per-expert offsets, one noise scale, 0-d nu."""
    d = experts.M.shape[-1] - 1
    return TiedAffine(M=experts.M[0, :, :d], K_=experts.K_[0, :d, :d],
                      mus=experts.M[:, :, d], kappas=experts.K_[:, d, d],
                      psi=experts.psi[0], nu=experts.nu[0])


@pytest.mark.parametrize('studentt', [True, False])
def test_hier_predict_kernel_matches_plain(dev, studentt):
    """B3 on HierTied rows (df = nu - d + 1 over K, precision df psi)."""
    n, k, d = 100003, 50, 2
    basis, _, log_w = _ilr_state(dev, k, d, 1)
    post = _hier_basis(basis)
    xt = torch.rand((d, n), device=dev) * 4 - 2
    thq, aux = cuda_predict.predictive_coefficients(post, log_w, studentt)
    out = cuda_predict.predict(xt, thq, aux, n, studentt)
    ref = cuda_predict.predict_plain(xt, thq, aux, n, studentt)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('d,p', [(1, 1), (2, 3)])
@pytest.mark.parametrize('basis_kind,experts_kind', [
    ('niw', 'tied'), ('hier', 'mnw'), ('hier', 'mng'), ('hier', 'tied')])
def test_new_ilr_serving_branches_match_plain(dev, basis_kind, experts_kind,
                                              d, p):
    """B5 (p = 1) and B6 (p = 3) on the tied-affine and HierTied
    coefficient branches, average and mode, with and without y."""
    n, k = 100003, 50
    basis, experts, log_w = (_mng_state(dev, k, d, p) if experts_kind == 'mng'
                             else _ilr_state(dev, k, d, p))
    if basis_kind == 'hier':
        basis = _hier_basis(basis)
    if experts_kind == 'tied':
        experts = _tied_experts(experts)
    g = torch.Generator(device=dev).manual_seed(5)
    for has_y in (True, False):
        xt = torch.rand((d + (p if has_y else 0), n), generator=g,
                        device=dev) * 4 - 2
        for hard in (False, True):
            if p == 1:
                th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                    basis, experts, log_w)
                out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, has_y,
                                                   hard)
                ref = cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n,
                                                         has_y, hard)
            else:
                th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                    basis, experts, log_w, True, has_y)
                out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                     has_y, hard)
                ref = cuda_ilr_predict.ilr_p_predict_plain(
                    xt, th, aux, vc, n, p, has_y, hard)
            assert bool(torch.isfinite(out).all())
            torch.testing.assert_close(out[:p], ref[:p], rtol=1e-4,
                                       atol=1e-4)
            torch.testing.assert_close(out[p:2 * p], ref[p:2 * p],
                                       rtol=2e-3, atol=1e-5)
            torch.testing.assert_close(out[2 * p:], ref[2 * p:], rtol=1e-3,
                                       atol=2e-3)


def _probe_bound(acc, ref, xt, theta, n, divide=True, nv=None):
    """|acc - ref| <= 1e-5 x the summed magnitudes sum_n w_nk |F_jn|."""
    f = cuda_estep.assemble_features(xt[:, :n], theta.shape[1]).double()
    logp = theta.double() @ f
    ex = torch.exp(logp - logp.max(0).values)
    w = ex / ex.sum(0) if divide else ex
    if nv is not None:
        w[:, nv:] = 0.0
    mag = w @ f.abs().T
    return bool(((acc.double() - ref.double()).abs() <= 1e-5 * mag
                 + 1e-6).all())


@pytest.mark.parametrize('divide', [True, False])
def test_regf_probe_matches_plain(dev, divide):
    """S1: B1 with and without the per-point divide; with it, S1 is B1."""
    n, k, d = 100003, 50, 2
    xt, theta = _inputs(dev, n, k, d, seed=8)
    acc, lse = cuda_probes.regf(xt, theta, n, divide)
    pacc, plse = cuda_probes.estep_probe_plain(xt, theta, n, divide)
    assert _probe_bound(acc, pacc, xt, theta, n, divide)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    if divide:
        bacc, blse = cuda_estep.estep(xt, theta, n)
        assert torch.equal(acc, bacc) and torch.equal(lse, blse)


@pytest.mark.parametrize('n,k,nv', [(4096, 8, 4000), (100096, 50, 100003)])
@pytest.mark.parametrize('mode', ['none', 'unused', 'used'])
def test_count_probe_matches_plain(dev, mode, n, k, nv):
    """S2 at the TPU probe's shape (K=8, d=2, N=4096, nv=4000) and at a
    wide one: the count as nothing, as an unread or a read int32 in device
    memory; the points at or past a used count contribute nothing."""
    xt, theta = _inputs(dev, n, k, 2, seed=9)
    nv_t = torch.tensor([nv], dtype=torch.int32, device=dev)
    acc, lse = cuda_probes.estep_count(xt, theta, n, mode, nv_t)
    used = nv if mode == 'used' else None
    pacc, plse = cuda_probes.estep_probe_plain(xt, theta, n, True, used)
    assert _probe_bound(acc, pacc, xt, theta, n, True, used)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)
    bacc, blse = cuda_estep.estep(xt, theta, min(n, used or n))
    torch.testing.assert_close(acc, bacc, rtol=1e-5, atol=1e-3)


def test_kernel_entries_refuse_expanded_coefficients(dev):
    """Pooled and tied posteriors are built with expand (stride 0); the
    wrappers raise rather than copy when such a tensor reaches them."""
    xt, theta = _inputs(dev, 1000, 7, 2)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_estep.estep(xt, theta[:1].expand(7, theta.shape[1]), 1000)
    thq = torch.rand((7, 8), device=dev)
    aux = torch.rand((1, 8), device=dev).expand(7, 8)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_predict.predict(xt, thq, aux, 1000)
    with pytest.raises(ValueError, match='multiple of 128'):
        cuda_probes.estep_count(xt, theta, 1000, 'none')


def test_tied_and_hier_engines_kernel_path_tracks_plain_path(dev):
    """The tied, tied-diagonal and hierarchical GMMs and the
    tied-activation ILR through their kernels against their plain
    paths: launches, VI traces, predictives."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    for kw in (dict(gating='dp', tied=True, psi_scale=0.5),
               dict(diag=True, tied=True),
               dict(gating='dp', hierarchical=True, psi_scale=0.5,
                    maxsubiter=5)):
        m = BayesianGMM.make(size=10, dim=2, kappa=0.05, device=dev, **kw)
        init, _ = m.fit_vi_fused(x, key=1, maxiter=2, backend='torch')
        name = 'diag' if kw.get('diag') else 'gauss'
        before = cuda_estep.launches[name]
        _, v_k = m.fit_vi_fused(x, maxiter=5, init_state=init,
                                randomize=False, backend='kernel')
        assert cuda_estep.launches[name] == before + 5
        _, v_t = m.fit_vi_fused(x, maxiter=5, init_state=init,
                                randomize=False, backend='torch')
        torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
        lp_k = m.log_predictive(init, x, backend='kernel')
        lp_t = m.log_predictive(init, x, backend='torch')
        torch.testing.assert_close(lp_k, lp_t, rtol=1e-4, atol=1e-4)
        before = cuda_gibbs.launches[name]
        gs = m.fit_gibbs_fused(x, key=2, maxiter=3, backend='kernel')
        assert cuda_gibbs.launches[name] == before + 3
        assert bool(torch.isfinite(gs.log_pi).all())

    y = torch.sin(x[:, :1]) + 0.1 * torch.randn((20011, 1), generator=g,
                                                device=dev)
    for p in (1, 3):
        yy = y if p == 1 else torch.tanh(x @ torch.randn(
            (2, 3), generator=g, device=dev))
        mi = BayesianILR.make(size=8, input_dim=2, output_dim=p, alpha=2.0,
                              kappa=0.1, tied_affine=True, hier_basis=True,
                              maxsubiter=5, device=dev)
        mi.init_transform(x, yy)
        gs = mi.fit_gibbs_fused((x, yy), key=0, maxiter=5, backend='kernel')
        st, _ = mi.fit_vi_fused((x, yy), key=1, maxiter=5, backend='kernel',
                                init_state=MFState(gs.components, gs.gating),
                                randomize=False)
        name = 'ilr_predict' if p == 1 else 'ilr_p_predict'
        before = cuda_ilr_predict.launches[name]
        mu_k, var_k, _, nlpd_k = mi.predict(st, x, yy, backend='kernel')
        assert cuda_ilr_predict.launches[name] == before + 1
        mu_t, var_t, _, nlpd_t = mi.predict(st, x, yy, backend='torch')
        scale = float(mi.output_transform.scale.max())
        torch.testing.assert_close(mu_k, mu_t, rtol=1e-4, atol=1e-4 * scale)
        torch.testing.assert_close(var_k, var_t, rtol=2e-3,
                                   atol=1e-4 * scale ** 2)
        torch.testing.assert_close(nlpd_k, nlpd_t, rtol=1e-3, atol=2e-3)


# -- B1 and B2 at the tensor-core kernels' tile edges ------------------------
# m8 -> (map, d, p) with that padded width. B1's tile holds 64 points up to
# m8 = 64 and 32 above; B2's 128 up to m8 = 16, then as B1's (csrc/estep.cuh
# estep_tile, csrc/gibbs.cu gibbs_tile).
EDGE_MAPS = {8: (cuda_estep.GAUSS, 2, 0), 16: (cuda_estep.GAUSS, 3, 0),
             32: (cuda_estep.GAUSS, 5, 0), 168: (ILR, 8, 1)}


def _edge_inputs(dev, n, k, m8, seed):
    kind, d, p = EDGE_MAPS[m8]
    if kind == ILR:
        xt, theta = _ilr_inputs(dev, n, k, d, p, seed)
    else:
        xt, theta = _inputs(dev, n, k, d, seed)
    assert theta.shape == (k, m8)
    return xt, theta, kind, p


def _edge_ns(m8):
    tiles = {64 if m8 <= 64 else 32, 128 if m8 <= 16 else
             64 if m8 <= 64 else 32}
    return sorted({1, 7, 1_000_003} | {t + e for t in tiles for e in (-1, 1)})


EDGE_CASES = [(k, m8, n) for k in (7, 16, 50, 64) for m8 in EDGE_MAPS
              for n in _edge_ns(m8)]


def _check_estep(xt, theta, n, kind, p):
    """B1 against its plain version with the tolerances of chip_smoke.py
    phase 7 (within 1e-5 of the summed magnitudes) and, at n >= 1e6 over
    the Gauss map, phase 3 (rtol 1e-4, atol 1e-3 per 1e6 points); lse
    within rtol 1e-5 (and 1e-6 of sum |lse_n|, for the few-point sums
    that cancel); bitwise on repeat."""
    acc, lse = cuda_estep.estep(xt, theta, n, kind, p)
    acc2, lse2 = cuda_estep.estep(xt, theta, n, kind, p)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, p)
    f = cuda_estep.assemble_features(xt[:, :n], theta.shape[1], kind,
                                     p).double()
    logp = theta.double() @ f
    mag = torch.softmax(logp, 0) @ f.abs().T
    assert bool(((acc.double() - pacc.double()).abs()
                 <= 1e-5 * mag + 1e-6).all())
    if kind != ILR and n >= 1_000_000:
        torch.testing.assert_close(acc, pacc, rtol=1e-4, atol=1e-3 * n / 1e6)
    # a sum of a few points' lse can cancel: its scale is sum |lse_n|
    scale = float(torch.logsumexp(logp, 0).abs().sum())
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(acc, acc2) and torch.equal(lse, lse2)


def _check_gibbs(xt, theta, n, kind, p):
    """B2: labels in range and equal to the plain Philox labels (near-ties
    aside, at most 1e-4 of the points), the statistics the one-hot sums
    of its own labels (chip_smoke.py phase 4)."""
    k = theta.shape[0]
    seed = torch.tensor(123456789, dtype=torch.int64, device=xt.device)
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n, kind, p)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n, kind, p)
    assert labels.shape == (n,)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert int((labels != plabels).sum()) <= 1e-4 * n
    f = cuda_estep.assemble_features(xt[:, :n], theta.shape[1], kind,
                                     p).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    bound = 1e-5 * (oh.T @ f.abs().T) + 1e-6
    assert bool(((acc.double() - oh.T @ f.T).abs() <= bound).all())


@pytest.mark.parametrize('k,m8,n', EDGE_CASES)
def test_estep_kernel_tile_edges(dev, k, m8, n):
    """B1 at K on both sides of the 16-row slabs, every tile width and n
    at the tiles' edges."""
    xt, theta, kind, p = _edge_inputs(dev, n, k, m8, seed=11)
    _check_estep(xt, theta, n, kind, p)


@pytest.mark.parametrize('k,m8,n', EDGE_CASES)
def test_gibbs_kernel_tile_edges(dev, k, m8, n):
    """B2 at the same edges."""
    xt, theta, kind, p = _edge_inputs(dev, n, k, m8, seed=12)
    _check_gibbs(xt, theta, n, kind, p)


# -- B1 and B2 in the streamed layout (csrc/tc.cuh) --------------------------
# (map, d, p, K, n) past the plain layout: more 16-row slabs of K than a
# block has warps (K > 256 up to m8 = 64, K > 128 above), an m8 past the
# widest compiled width (256), or tiles past shared memory; among them the
# fed shapes of bench.py:296-312 (d=16 K=128, d=32 K=256), the ILR map at
# d=16, p=1 (m8 = 584) and the diagonal map at d=32, K=256. The chunked
# layout these once ran in is gone; the tests keep their names.
STREAMED_CASES = [
    (cuda_estep.GAUSS, 2, 0, 300, 100_003),   # m8 = 8, 19 slabs, 2 chunks
    (cuda_estep.GAUSS, 2, 0, 390, 1_001),
    (cuda_estep.GAUSS, 2, 0, 3_500, 1_001),   # 219 slabs, 14 chunks
    (cuda_estep.GAUSS, 3, 0, 1_700, 777),     # m8 = 16
    (ILR, 5, 1, 150, 10_007),                 # m8 = 80, K > 128
    (ILR, 12, 2, 4, 1_001),                   # m8 = 360: 6 windows of 64
    (cuda_estep.GAUSS, 16, 0, 30, 1_001),     # m8 = 280
    (cuda_estep.GAUSS, 16, 0, 128, 100_003),  # bench.py's d=16 cell
    (cuda_estep.GAUSS, 32, 0, 256, 20_011),   # bench.py:305, m8 = 1064
    (cuda_estep.GAUSS, 23, 0, 5, 2_001),      # m8 = 560 > 512 table rows
    (ILR, 16, 1, 50, 100_003),                # m8 = 584
    (DIAG, 32, 0, 256, 20_011),               # m8 = 72, K past 128
]


def _streamed_inputs(dev, kind, d, p, k, n, seed):
    if kind == ILR:
        return _ilr_inputs(dev, n, k, d, p, seed)
    if kind == DIAG:
        return _diag_inputs(dev, n, k, d, seed)
    return _inputs(dev, n, k, d, seed)


@pytest.mark.parametrize('kind,d,p,k,n', STREAMED_CASES)
def test_estep_kernel_chunked_layout(dev, kind, d, p, k, n):
    xt, theta = _streamed_inputs(dev, kind, d, p, k, n, seed=13)
    _check_estep(xt, theta, n, kind, p)


@pytest.mark.parametrize('kind,d,p,k,n', STREAMED_CASES)
def test_gibbs_kernel_chunked_layout(dev, kind, d, p, k, n):
    xt, theta = _streamed_inputs(dev, kind, d, p, k, n, seed=14)
    _check_gibbs(xt, theta, n, kind, p)


@pytest.mark.parametrize('divide', [True, False])
def test_regf_probe_chunked_layout(dev, divide):
    """S1 at m8 = 48, a width the probes run only in B1's streamed
    layout; with the divide it equals B1 within B1's tolerances."""
    n, k, d = 10_007, 8, 6
    xt, theta = _inputs(dev, n, k, d, seed=15)
    acc, lse = cuda_probes.regf(xt, theta, n, divide)
    pacc, plse = cuda_probes.estep_probe_plain(xt, theta, n, divide)
    assert _probe_bound(acc, pacc, xt, theta, n, divide)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0.0)


def test_gibbs_fast_draw_within_its_margin(dev):
    """B2 takes the accurate draw only for the components whose fast MUFU
    draw comes within a margin (2^-10) of the best fast one; the labels
    are exact while the fast draw stays within half of it of the accurate
    one for every u."""
    assert cuda_gibbs.gumbel_fast_error(dev) < 2.0 ** -12


def test_tc_kernels_refuse_past_shared_memory(dev):
    """Past shared memory (theta of K=8000, m8=8 alone is 256 KB, which B1
    and B2 once refused) the streamed layout takes the shape; only scratch
    past device memory raises: 6,000 chains of K=300 hold 16 MB of logits
    each, 96 GB in all."""
    xt, theta = _inputs(dev, 1000, 8000, 2)
    _check_estep(xt, theta, 1000, cuda_estep.GAUSS, 0)
    _check_gibbs(xt, theta, 1000, cuda_estep.GAUSS, 0)
    xt, theta = _inputs(dev, 1000, 300, 2)
    thetas = theta.expand(6000, -1, -1).contiguous()
    with pytest.raises(NotImplementedError, match='device memory'):
        cuda_estep.estep(xt, thetas, 1000)
    seeds = torch.zeros(6000, dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match='device memory'):
        cuda_gibbs.gibbs(xt, thetas, seeds, 1000)


# -- the serving kernels B3-B6 at any K and d (csrc/serving.cuh) -------------
# Each thread owns 4 points (B5 at d <= 2, B3/B4 over narrow maps), 2
# (B3-B5 at the other compiled widths, d <= 8, and B6 at d <= 4) or 1 (B6
# at d = 5-8 and the runtime-width paths), so the point tiles are 512,
# 256 and 128 points; K past what a block stages at once streams in
# chunks through two buffers.

def _serving_ns(tile):
    return (1, tile - 1, tile + 1, 3 * tile + 5)


def _assert_serving_close(out, ref, p):
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[:p], ref[:p], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[p:2 * p], ref[p:2 * p], rtol=2e-3,
                               atol=1e-5)
    torch.testing.assert_close(out[2 * p:], ref[2 * p:], rtol=1e-3,
                               atol=2e-3)


def _serving_state(dev, kind, k, d, p, seed):
    basis, experts, log_w = (_mng_state(dev, k, d, p, seed) if kind == 'mng'
                             else _ilr_state(dev, k, d, p, seed))
    if kind == 'hier':
        basis = _hier_basis(basis)
    if kind == 'tied':
        experts = _tied_experts(experts)
    return basis, experts, log_w


def _b5_tile(d):
    return 512 if d <= 2 else 256 if d <= 8 else 128


@pytest.mark.parametrize('kind', ['mnw', 'mng', 'tied', 'hier'])
@pytest.mark.parametrize('d', [1, 2, 5, 8, 9])
@pytest.mark.parametrize('k', [1, 7, 50, 194, 500])
def test_ilr_predict_kernel_any_k_and_d(dev, k, d, kind):
    """B5 at K from 1 to 500 and d = 1, 2 (compiled, 512-point tiles), 5
    and 8 (compiled, 256-point tiles; K=194 and 500 at d=8 raised before
    the K-chunks) and 9 (runtime width, 128-point tiles), MNW, MNG,
    tied-affine experts and a HierTied basis, average and mode, with and
    without y, n at the tile's edges and at 1."""
    basis, experts, log_w = _serving_state(dev, kind, k, d, 1, seed=20)
    th, aux = cuda_ilr_predict.ilr_predict_coefficients(basis, experts,
                                                        log_w)
    g = torch.Generator(device=dev).manual_seed(21)
    for n in _serving_ns(_b5_tile(d)):
        xy = torch.rand((d + 1, n), generator=g, device=dev) * 4 - 2
        for has_y in (True, False):
            xt = xy if has_y else xy[:d].contiguous()
            for hard in (False, True):
                out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, has_y,
                                                   hard)
                ref = cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n,
                                                         has_y, hard)
                _assert_serving_close(out, ref, 1)


@pytest.mark.parametrize('kind', ['mnw', 'mng', 'tied', 'hier'])
@pytest.mark.parametrize('d,p', [(1, 2), (1, 3), (2, 2), (2, 3)])
@pytest.mark.parametrize('k', [1, 7, 50, 300])
def test_ilr_p_predict_kernel_any_k(dev, k, d, p, kind):
    """B6 at K from 1 to 300 (K=300 with y raised before the K-chunks)
    at the compiled widths (256-point tiles), MNW, MNG, tied-affine
    experts and a HierTied basis, average and mode, with and without y,
    n at the tile's edges and at 1."""
    basis, experts, log_w = _serving_state(dev, kind, k, d, p, seed=22)
    g = torch.Generator(device=dev).manual_seed(23)
    for n in _serving_ns(256):
        xy = torch.rand((d + p, n), generator=g, device=dev) * 4 - 2
        for has_y in (True, False):
            xt = xy if has_y else xy[:d].contiguous()
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w, True, has_y)
            for hard in (False, True):
                out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                     has_y, hard)
                ref = cuda_ilr_predict.ilr_p_predict_plain(
                    xt, th, aux, vc, n, p, has_y, hard)
                _assert_serving_close(out, ref, p)


@pytest.mark.parametrize('kind', ['mnw', 'mng'])
@pytest.mark.parametrize('d,p', [(9, 2), (2, 5), (4, 2), (5, 3), (8, 2),
                                 (8, 3)])
def test_ilr_p_predict_kernel_runtime_widths(dev, d, p, kind):
    """B6 past its compiled widths (d = 9 or p = 5: the runtime-width
    path, its running sums in the output rows) and at the wide compiled
    ones (d = 4-8, 256- or 128-point tiles), K=60."""
    basis, experts, log_w = _serving_state(dev, kind, 60, d, p, seed=24)
    g = torch.Generator(device=dev).manual_seed(25)
    for n in _serving_ns(256 if d <= 4 and p <= 3 else 128):
        xy = torch.rand((d + p, n), generator=g, device=dev) * 4 - 2
        for has_y in (True, False):
            xt = xy if has_y else xy[:d].contiguous()
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w, True, has_y)
            for hard in (False, True):
                out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                     has_y, hard)
                ref = cuda_ilr_predict.ilr_p_predict_plain(
                    xt, th, aux, vc, n, p, has_y, hard)
                _assert_serving_close(out, ref, p)


def _random_rows(g, dev, rows, width):
    th = torch.zeros((rows, -(-width // 8) * 8), device=dev)
    th[:, :width] = 0.01 * torch.randn((rows, width), generator=g,
                                       device=dev)
    return th


@pytest.mark.parametrize('which', ['B3', 'B5', 'B6'])
def test_serving_kernels_read_a_component_past_the_buffers_in_place(dev,
                                                                   which):
    """A component whose coefficient rows pass the largest staging buffer
    (96 KB: B3 at d=160, B5 at d=100, B6 at d=70, p=2 with y) is read in
    place from device memory. Random coefficient rows (the path does not
    depend on what they encode), K=3, n at the runtime tile's edges."""
    k = 3
    g = torch.Generator(device=dev).manual_seed(31)
    aux = torch.rand((k, 8), generator=g, device=dev) + 0.5
    aux[:, 0] = torch.randn((k,), generator=g, device=dev)
    for n in _serving_ns(128):
        if which == 'B3':
            d = 160
            th = _random_rows(g, dev, k, 1 + d + d * d)
            xt = torch.randn((d, n), generator=g, device=dev)
            torch.testing.assert_close(
                cuda_predict.predict(xt, th, aux, n),
                cuda_predict.predict_plain(xt, th, aux, n), rtol=1e-5,
                atol=1e-4)
            continue
        for hard in (False, True):
            if which == 'B5':
                d = 100
                th = _random_rows(g, dev, 3 * k, 1 + d + d * d)
                xt = torch.randn((d + 1, n), generator=g, device=dev)
                _assert_serving_close(
                    cuda_ilr_predict.ilr_predict(xt, th, aux, n, True, hard),
                    cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n, True,
                                                       hard), 1)
            else:
                d, p = 70, 2
                th = _random_rows(g, dev, (3 + p) * k,
                                  cuda_ilr_predict.joint_width(d, p))
                vc = torch.rand((k, p), generator=g, device=dev) + 0.5
                xt = torch.randn((d + p, n), generator=g, device=dev)
                _assert_serving_close(
                    cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                   True, hard),
                    cuda_ilr_predict.ilr_p_predict_plain(
                        xt, th, aux, vc, n, p, True, hard), p)


@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('d,p', [(1, 1), (8, 1), (9, 1), (2, 3), (4, 2),
                                 (9, 2)])
def test_ilr_serving_variance_does_not_cancel_far_from_zero(dev, d, p, hard):
    """B5 (d = 1 and 8 compiled, d = 9 runtime width) and B6 (d = 2, p = 3
    and d = 4, p = 2 compiled; d = 9, p = 2 runtime, its reference means
    in the scratch rows) over 300 experts whose means sit near +-30 with
    a spread of ~0.1 and own variance c vc = 0.007, K streamed in chunks:
    mean and variance against the plain version in float64 (the expanded
    E[c vc + mu^2] - mean^2 would lose ~1e-3 of var here); under 'mode'
    the chosen expert's c vc exactly."""
    k, n = 300, 1000
    g = torch.Generator(device=dev).manual_seed(30)
    sign = torch.tensor([1.0, -1.0, 1.0], device=dev)[:p]
    means = 30.0 * sign + 0.1 * torch.randn((k, p), generator=g, device=dev)
    m8 = -(-(1 + d + d * d) // 8) * 8
    th = torch.zeros(((2 + p) * k, m8), device=dev)
    th[2 * k:, 0] = means.T.reshape(-1)
    aux = torch.zeros((k, 8), device=dev)
    aux[:, 0] = torch.randn((k,), generator=g, device=dev)
    vc = torch.full((k, p), 0.007, device=dev)
    if p == 1:
        aux[:, 3] = vc[:, 0]
    xt = torch.rand((d, n), generator=g, device=dev) * 4 - 2
    if p == 1:
        out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, False, hard)
        ref = cuda_ilr_predict.ilr_predict_plain(
            xt.double(), th.double(), aux.double(), n, False, hard)
    else:
        out = cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p, False,
                                             hard)
        ref = cuda_ilr_predict.ilr_p_predict_plain(
            xt.double(), th.double(), aux.double(), vc.double(), n, p, False,
            hard)
    torch.testing.assert_close(out[:p].double(), ref[:p], rtol=1e-6,
                               atol=0.0)
    torch.testing.assert_close(out[p:2 * p].double(), ref[p:2 * p],
                               rtol=1e-4, atol=0.0)
    if hard:
        assert bool((out[p:2 * p] == vc[0, 0]).all())


@pytest.mark.parametrize('studentt', [True, False])
@pytest.mark.parametrize('k,d', [(500, 2), (60, 5), (256, 8), (40, 9),
                                 (16, 24)])
def test_predict_kernel_any_k_and_d(dev, k, d, studentt):
    """B3 at shapes it refused before the K-chunks (K=500 at d=2, K=256
    at d=8, and d=24, where the F tile alone passed shared memory) and at
    each side of its last compiled width (d=8; 5 and 9)."""
    basis, _, log_w = _ilr_state(dev, k, d, 1, seed=26)
    thq, aux = cuda_predict.predictive_coefficients(basis, log_w, studentt)
    g = torch.Generator(device=dev).manual_seed(27)
    for n in _serving_ns(_b5_tile(d)):
        xt = torch.randn((d, n), generator=g, device=dev)
        out = cuda_predict.predict(xt, thq, aux, n, studentt)
        ref = cuda_predict.predict_plain(xt, thq, aux, n, studentt)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('k,d', [(64, 32), (40, 7)])
def test_diag_predict_kernel_wide(dev, k, d):
    """B4 at K=64, d=32 (refused before the K-chunks; runtime width) and
    at d=7 (compiled), and B3 over the diagonal map at the same shapes."""
    post = _ng_posterior(dev, k, d)
    log_w = torch.log_softmax(torch.randn((k,), device=dev), 0)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    thq, aux3 = cuda_predict.diag_gaussian_coefficients(post, log_w)
    g = torch.Generator(device=dev).manual_seed(28)
    for n in _serving_ns(256 if d <= 8 else 128):
        xt = torch.randn((d, n), generator=g, device=dev) * 2
        out = cuda_diag_predict.diag_predict(xt, rows, aux, n)
        ref = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        out = cuda_predict.predict(xt, thq, aux3, n, False, DIAG)
        ref = cuda_predict.predict_plain(xt, thq, aux3, n, False, DIAG)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_dp_gmm_log_predictive_at_k500_runs_through_b3(dev):
    """A DP-GMM at K=500, d=2 fits on the card and serves its Student-t
    log_predictive through B3 under backend='auto'."""
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    m = BayesianGMM.make(size=500, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    st, _ = m.fit_vi_fused(x, key=1, maxiter=3)
    before = cuda_predict.launches['gauss']
    lp = m.log_predictive(st, x)
    assert cuda_predict.launches['gauss'] == before + 1
    torch.testing.assert_close(lp, m.log_predictive(st, x, backend='torch'),
                               rtol=1e-5, atol=1e-4)


# B3 and B4 at every compiled width (d = 1-8; 9, 16, 17, 24, 32 padded to
# 12, 16, 24, 24, 32) and past them (d = 40, the runtime width), K from 1
# to 500 (one partial group of the blocked fold; chunks of every size).
SERVING_DS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 24, 25, 32, 40]


def _b34_tile(d):
    return 512 if d <= 2 else 256 if d <= 32 else 128


def _ng_posterior_h(dev, k, d, shared, seed):
    """An NG posterior whose tail exponents h are equal across dims
    (shared: alpha per component, the models' case) or not."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    alpha = u(2.0, 400.0, (k, 1) if shared else (k, d)).expand(k, d)
    return NG(mu=torch.randn((k, d), generator=g, device=dev) * 2,
              kappa=u(1.0, 20.0, (k, d)), alpha=alpha.contiguous(),
              beta=u(0.5, 5.0, (k, d)) * alpha / 20.0)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('k', [1, 50, 500])
@pytest.mark.parametrize('d', SERVING_DS)
def test_diag_predict_kernel_widths(dev, d, k, shared):
    """B4 against its plain version with h equal (one log per component)
    and unequal (a log per dim) across dims, n at the tile's edges."""
    post = _ng_posterior_h(dev, k, d, shared, seed=40 + d)
    log_w = torch.log_softmax(torch.randn((k,), device=dev), 0)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    assert bool((aux[:, 1] > 0).all()) == shared or d == 1
    g = torch.Generator(device=dev).manual_seed(41)
    for n in _serving_ns(_b34_tile(d)):
        xt = torch.randn((d, n), generator=g, device=dev) * 2
        out = cuda_diag_predict.diag_predict(xt, rows, aux, n)
        ref = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('d', [8, 9, 30, 32, 40])
def test_diag_predict_kernel_where_the_product_overflows(dev, d):
    """Points so far out that prod_j (1 + u_j) overflows f32 (df ~ 10, a
    point ~15 sigma out in every dim, d >= 8 dims): B4 takes the per-dim
    sum there and stays finite and equal to its plain version, shared h
    or not, among ordinary points; at d = 9 and 30 (padded to 12 and 32)
    the padded dims then make U inf * 0 = NaN, which the guard catches
    too."""
    k, n = 5, 300
    for shared in (True, False):
        g = torch.Generator(device=dev).manual_seed(42)
        post = NG(mu=torch.randn((k, d), generator=g, device=dev),
                  kappa=torch.full((k, d), 8.0, device=dev),
                  alpha=(torch.full((k, 1), 5.0, device=dev) if shared else
                         4.0 + 2.0 * torch.rand((k, d), generator=g,
                                                device=dev)).expand(k, d)
                  .contiguous(),
                  beta=torch.full((k, d), 2.0, device=dev))
        log_w = torch.log_softmax(torch.randn((k,), generator=g, device=dev),
                                  0)
        rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
        xt = torch.randn((d, n), generator=g, device=dev)
        xt[:, :7] = torch.tensor([14.0, -14.0, 20.0, 30.0, -50.0, 1e3, 1e5],
                                 device=dev)
        out = cuda_diag_predict.diag_predict(xt, rows, aux, n)
        ref = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
        assert bool(torch.isfinite(ref).all())
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_serving_entries_refuse_a_width_they_do_not_compile(dev):
    """B3's and B4's C entries take the width the host laid the
    coefficients out for (cuda_predict.serving_width) and refuse one they
    do not compile, or one below d, rather than read a layout they did not
    get."""
    lib = _build.load()
    d, k, n = 9, 8, 100
    xt = torch.zeros((d, n), device=dev)
    out = torch.empty((n,), device=dev)
    aux = torch.zeros((k, 8), device=dev)
    rows = torch.zeros((k * 32, 4), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for width, m in ((20, 1 + 20 + 400), (8, 96), (9, 1 + 9 + 81)):
        th = torch.zeros((k, m), device=dev)
        assert lib.mimo_predict(xt.data_ptr(), n, d, width, 0, n,
                                th.data_ptr(), k, m, aux.data_ptr(), 1,
                                out.data_ptr(), stream) != 0
    for width in (20, 8, 9, 33):
        assert lib.mimo_diag_predict(xt.data_ptr(), n, d, width, n,
                                     rows.data_ptr(), k, aux.data_ptr(),
                                     out.data_ptr(), stream) != 0
    torch.cuda.synchronize()
    assert cuda_predict.serving_width(d) == 12


@pytest.mark.parametrize('studentt', [True, False])
@pytest.mark.parametrize('k', [1, 50, 500])
@pytest.mark.parametrize('d', SERVING_DS)
def test_predict_kernel_widths(dev, d, k, studentt):
    """B3 over the Gauss map (NIW rows) and over the diagonal map (the NG
    Gaussian predictive) against its plain version, n at the tile's
    edges."""
    basis, _, log_w = _ilr_state(dev, k, d, 1, seed=43 + d)
    thq, aux = cuda_predict.predictive_coefficients(basis, log_w, studentt)
    post = _ng_posterior_h(dev, k, d, True, seed=44 + d)
    thd, auxd = cuda_predict.diag_gaussian_coefficients(post, log_w)
    g = torch.Generator(device=dev).manual_seed(45)
    for n in _serving_ns(_b34_tile(d)):
        xt = torch.randn((d, n), generator=g, device=dev)
        out = cuda_predict.predict(xt, thq, aux, n, studentt)
        ref = cuda_predict.predict_plain(xt, thq, aux, n, studentt)
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
        if not studentt:
            out = cuda_predict.predict(xt, thd, auxd, n, False, DIAG)
            ref = cuda_predict.predict_plain(xt, thd, auxd, n, False, DIAG)
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# -- the nested mixtures of mixtures (B1/B2/B3 at M*K rows, B5/B6 flattened) --

def _nested_x(dev, n, seed):
    """Two super-clusters of two blobs each, as tests/test_hierarchical.py."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.tensor([[-5., -5.], [-5., -3.], [5., 5.], [5., 3.]],
                     device=dev)
    lab = torch.randint(0, 4, (n,), generator=g, device=dev)
    return c[lab] + 0.5 * torch.randn((n, 2), generator=g, device=dev)


@pytest.mark.parametrize('hierarchical', [False, True])
def test_nested_engines_kernel_path_tracks_plain_path(dev, hierarchical):
    """Nested fit_vi_fused through B1 (one launch a sweep, M*K = 12 rows)
    against backend='torch' on 20,000 points; fit_gibbs_fused through B2;
    log_predictive on NIW and HierTied posteriors through B3's per-cluster
    rows, once a call."""
    x = _nested_x(dev, 20_000, 31)
    m = BayesianMixtureOfMixtures.make_gmm(
        3, 4, 2, hierarchical=hierarchical, kappa=0.5, psi_scale=0.5,
        means=[[-5., -4.], [5., 4.], [0., 0.]], device=dev)
    before = cuda_estep.launches['gauss']
    st, v_k = m.fit_vi_fused(x, key=1, maxiter=6, backend='kernel')
    assert cuda_estep.launches['gauss'] == before + 6
    _, v_t = m.fit_vi_fused(x, key=1, maxiter=6, backend='torch')
    torch.testing.assert_close(v_k, v_t, rtol=1e-4, atol=0.0)
    before = cuda_gibbs.launches['gauss']
    gs = m.fit_gibbs_fused(x, key=2, maxiter=4)
    assert cuda_gibbs.launches['gauss'] == before + 4
    assert int(gs.labels.min()) >= 0 and int(gs.labels.max()) < 3
    for dist in ('studentt', 'gaussian'):
        before = cuda_predict.launches['gauss']
        lp_k = m.log_predictive(st, x, dist=dist)
        assert cuda_predict.launches['gauss'] == before + 1
        torch.testing.assert_close(
            lp_k, m.log_predictive(st, x, dist=dist, backend='torch'),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('prediction', ['average', 'mode'])
@pytest.mark.parametrize('p', [1, 2])
def test_nested_predict_runs_through_b5_b6(dev, p, prediction):
    """Nested ILR predict (Student-t) through B5 (p = 1) or B6 (p = 2)
    over the M*K flattened experts, once a call, against the dense
    two-level path in original units."""
    g = torch.Generator(device=dev).manual_seed(37)
    n = 20_011
    x = torch.rand((n, 1), generator=g, device=dev) * 12 - 6
    y = torch.cat([torch.sin(x), torch.cos(x)], -1)[:, :p] + 0.1 * torch.randn(
        (n, p), generator=g, device=dev)
    m = BayesianMixtureOfMixtures.make_ilr(2, 4, 1, p, kappa=0.1, device=dev)
    m.init_transform(x, y)
    st, _ = m.fit_vi((x, y), key=1, maxiter=10, maxsubiter=2)
    name = 'ilr_predict' if p == 1 else 'ilr_p_predict'
    before = cuda_ilr_predict.launches[name]
    got = m.predict(st, x, y, prediction=prediction, dist='studentt')
    assert cuda_ilr_predict.launches[name] == before + 1
    want = m.predict(st, x, y, prediction=prediction, dist='studentt',
                     backend='torch')
    scale = float(m.output_transform.scale.max())
    bad = torch.zeros((n,), dtype=torch.bool, device=dev)
    for g_, w_, rtol, atol in ((got[0], want[0], 1e-4, 1e-4 * scale),
                               (got[1], want[1], 2e-3, 1e-4 * scale ** 2),
                               (got[3], want[3], 1e-3, 2e-3)):
        err = (g_ - w_).abs() > atol + rtol * w_.abs()
        bad |= err.reshape(n, -1).any(-1)
    # 'mode': a point whose two best experts tie to f32 rounding may pick
    # either (chip_smoke.py's compare_serving rule)
    assert int(bad.sum()) <= (1e-4 * n if prediction == 'mode' else 0)


# -- B1 and B2 with a chain axis (theta (C, K, m8), csrc/tc.cuh) --------------
# (map, d, p, K, n, C): the plain layout's narrow and wide widths and the
# streamed layout, C up to the two-sample check's 256 sweeps of one theta.
CHAIN_CASES = [
    (cuda_estep.GAUSS, 2, 0, 50, 100_003, 8),
    (cuda_estep.GAUSS, 2, 0, 16, 100_000, 16),
    (cuda_estep.GAUSS, 3, 0, 7, 1_001, 3),
    (DIAG, 2, 0, 50, 20_011, 4),
    (ILR, 8, 1, 50, 20_011, 4),                # m8 = 168
    (cuda_estep.GAUSS, 2, 0, 300, 20_011, 2),  # streamed layout
    (ILR, 12, 2, 4, 1_001, 2),                 # streamed, 6 windows
    (cuda_estep.GAUSS, 16, 0, 128, 20_011, 2),  # streamed, fed shapes
    (cuda_estep.GAUSS, 32, 0, 256, 5_003, 3),
    (ILR, 16, 1, 50, 20_011, 2),
]


def _chain_inputs(dev, kind, d, p, k, n, c, seed):
    """C thetas (C, K, m8) over one map and the shared points."""
    thetas = []
    for i in range(c):
        xt, theta = (_ilr_inputs(dev, n, k, d, p, seed + i) if kind == ILR
                     else _inputs(dev, n, k, d, seed + i))
        if kind == DIAG:
            theta[:, 1 + 2 * d:] = 0.0
            theta[:, 1 + d:1 + 2 * d] = -0.2
        thetas.append(theta)
    return xt, torch.stack(thetas).contiguous()


@pytest.mark.parametrize('kind,d,p,k,n,c', CHAIN_CASES)
def test_estep_chain_axis_equals_one_chain_launches(dev, kind, d, p, k, n, c):
    """Chain i of a C-chain launch is bitwise the one-chain launch at
    theta[i] (each chain has the one-chain grid along x) and within B1's
    tolerances of the plain version."""
    xt, thetas = _chain_inputs(dev, kind, d, p, k, n, c, seed=21)
    acc, lse = cuda_estep.estep(xt, thetas, n, kind, p)
    assert acc.shape == thetas.shape and lse.shape == (c,)
    for i in range(c):
        a1, l1 = cuda_estep.estep(xt, thetas[i], n, kind, p)
        assert torch.equal(acc[i], a1) and torch.equal(lse[i], l1)
    if c <= 4:
        for i in range(c):
            _check_estep(xt, thetas[i], n, kind, p)


@pytest.mark.parametrize('kind,d,p,k,n,c', CHAIN_CASES)
def test_gibbs_chain_axis_equals_one_chain_launches(dev, kind, d, p, k, n, c):
    """Chain i of a C-chain launch draws exactly the labels of a one-chain
    launch at (theta[i], seed[i]); its statistics are bitwise those of
    that launch."""
    xt, thetas = _chain_inputs(dev, kind, d, p, k, n, c, seed=31)
    seeds = torch.arange(c, dtype=torch.int64, device=dev) * 7919 + 11
    labels, acc = cuda_gibbs.gibbs(xt, thetas, seeds, n, kind, p)
    assert labels.shape == (c, n) and acc.shape == thetas.shape
    for i in range(c):
        l1, a1 = cuda_gibbs.gibbs(xt, thetas[i], seeds[i], n, kind, p)
        assert torch.equal(labels[i], l1) and torch.equal(acc[i], a1)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, thetas, seeds, n, kind, p)
    assert int((labels != plabels).sum()) <= 1e-4 * n * c


def test_chain_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xt, thetas = _chain_inputs(dev, cuda_estep.GAUSS, 2, 0, 7, 1000, 3, 41)
    seed = torch.tensor(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match='3 int64'):
        cuda_gibbs.gibbs(xt, thetas, seed, 1000)
    with pytest.raises(ValueError, match='contiguous'):
        cuda_estep.estep(xt, thetas.transpose(0, 1), 1000)
    with pytest.raises(ValueError, match='theta must be'):
        cuda_estep.estep(xt, thetas[None], 1000)


def test_fused_chains_launch_once_a_sweep(dev):
    """fit_chains over the fused engines launches B1 (VI, MAP, EM) or B2
    (Gibbs) once a sweep for every chain; the VI, MAP and EM chains track
    the serial fits with the same keys."""
    from mimo_tpu_torch.parallel import fit_chains
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((20011, 2), generator=g, device=dev) * 3
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    keys = [1, 2, 3]
    for engine, mod in (('fit_vi_fused', cuda_estep),
                        ('fit_map_fused', cuda_estep),
                        ('fit_em_fused', cuda_estep),
                        ('fit_gibbs_fused', cuda_gibbs)):
        before = mod.launches['gauss']
        out = fit_chains(m, engine, x, keys, maxiter=6)
        assert mod.launches['gauss'] == before + 6, engine
        if engine == 'fit_gibbs_fused':
            assert out.labels.shape == (3, 20011)
            continue
        assert out[1].shape == (3, 6)
        for i, k in enumerate(keys):
            _, tr = getattr(m, engine)(x, key=k, maxiter=6)
            torch.testing.assert_close(out[1][i], tr, rtol=1e-5, atol=0.0)


def test_nested_chains_launch_once_a_sweep_and_equal_one_chain(dev):
    """fit_chains over a nested model's fused engines launches B1 or B2
    once a sweep for all chains at M*K rows; the chains' B1 / B2 launches
    at their final thetas are their one-chain launches, and each VI chain
    tracks the nested fit with its key."""
    from torch.func import vmap
    from mimo_tpu_torch.ops.cuda_estep import kernel_xts
    from mimo_tpu_torch.ops.cuda_estep import pad_theta
    from mimo_tpu_torch.parallel import fit_chains
    g = torch.Generator(device=dev).manual_seed(9)
    c = torch.tensor([[-5., -4.], [5., 4.]], device=dev)
    x = c[torch.arange(30011, device=dev) % 2] + 0.7 * torch.randn(
        (30011, 2), generator=g, device=dev)
    m = BayesianMixtureOfMixtures.make_gmm(3, 4, 2, hierarchical=False,
                                           kappa=0.5, psi_scale=0.5,
                                           device=dev)
    keys = [1, 2, 3]
    for engine, mod in (('fit_vi_fused', cuda_estep),
                        ('fit_map_fused', cuda_estep),
                        ('fit_em_fused', cuda_estep),
                        ('fit_gibbs_fused', cuda_gibbs)):
        before = mod.launches['gauss']
        out = fit_chains(m, engine, x, keys, maxiter=5)
        assert mod.launches['gauss'] == before + 5, engine
        if engine == 'fit_gibbs_fused':
            gs = out
            assert gs.labels.shape == (3, 30011)
            continue
        assert out[1].shape == (3, 5)
        if engine == 'fit_vi_fused':
            st = out[0]
            for i, k in enumerate(keys):
                _, tr = m.fit_vi_fused(x, key=k, maxiter=5)
                torch.testing.assert_close(out[1][i], tr, rtol=1e-5,
                                           atol=0.0)
    xt = kernel_xts((x,))[0]
    spec = m._flat_spec()
    th = pad_theta(vmap(spec.theta)(st.components),
                   vmap(m._flat_log_pi)(st), torch.float32)[0]
    th_g = pad_theta(vmap(spec.theta_plugin)(
        vmap(vmap(m.family.mode_params))(gs.components)),
        vmap(m._log_mix_weights)(gs).flatten(1), torch.float32)[0]
    seeds = torch.tensor([11, 12, 13], dtype=torch.int64, device=dev)
    acc, lse = cuda_estep.estep(xt, th, 30011)
    labels, gacc = cuda_gibbs.gibbs(xt, th_g, seeds, 30011)
    for i in range(3):
        a1, l1 = cuda_estep.estep(xt, th[i], 30011)
        assert torch.equal(acc[i], a1) and torch.equal(lse[i], l1)
        lab1, g1 = cuda_gibbs.gibbs(xt, th_g[i], seeds[i], 30011)
        assert torch.equal(labels[i], lab1) and torch.equal(gacc[i], g1)


def _stream_data(dev, n=50011, seed=13):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, 2), generator=g, device=dev) * 3
    x[: n // 3] += 6.0
    return x, x.cpu().numpy()


def test_stream_full_launches_b1_once_a_block(dev):
    """fit_vi_stream_full / fit_map_stream_full / fit_em_stream_full on
    the card: B1 once a block, the ragged tail included, through the
    staged buffer; the streamed VI tracks fit_vi_fused in memory from the
    same state, whatever the prefetch depth, and bf16 on the wire stays
    within 1e-4."""
    x, xh = _stream_data(dev)
    b, nb = 16384, 4                                 # 3 blocks and a tail
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    st0, _ = m.fit_vi_fused(x, key=1, maxiter=3)

    def rb(i):
        return xh[i * b:(i + 1) * b]

    before = cuda_estep.launches['gauss']
    st, v = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=4)
    assert cuda_estep.launches['gauss'] == before + 4 * nb
    _, v_m = m.fit_vi_fused(x, init_state=st0, randomize=False, maxiter=4)
    torch.testing.assert_close(v, v_m, rtol=1e-5, atol=0.0)
    _, v1 = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=4,
                                 prefetch=1)
    _, v3 = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=4,
                                 prefetch=3)
    assert torch.equal(v1, v) and torch.equal(v3, v)
    _, vb = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=4,
                                 transfer_dtype=torch.bfloat16)
    torch.testing.assert_close(vb, v, rtol=1e-4, atol=0.0)
    for engine, kw in (('fit_map_stream_full', dict(init_state=st0)),
                       ('fit_em_stream_full', dict(key=2))):
        before = cuda_estep.launches['gauss']
        _, tr = getattr(m, engine)(rb, nb, maxiter=3, **kw)
        assert cuda_estep.launches['gauss'] == before + 3 * nb, engine
        assert bool(torch.isfinite(tr).all())


def test_stager_delivers_every_block_in_order(dev):
    """The staged (rows, capacity) buffers hold each block transposed,
    ragged blocks and a block larger than the first included, over more
    blocks than buffers."""
    from mimo_tpu_torch.io.stage import Stager
    gen = torch.Generator().manual_seed(3)
    sizes = [1000, 1000, 37, 2500, 1, 999]
    blocks = [(torch.randn((s, 2), generator=gen).numpy(),
               torch.randn((s, 1), generator=gen).numpy()) for s in sizes]
    stager = Stager(dev)
    for blk in blocks:
        slot, xts, nb = stager.put(stager.fill([blk]))
        assert nb == blk[0].shape[0] and [t.shape[0] for t in xts] == [2, 1]
        for t, a in zip(xts, blk):
            assert torch.equal(t[:, :nb].cpu(), torch.from_numpy(a).T)
        stager.release(slot)


def test_svi_stream_groups_do_not_change_the_steps(dev):
    """fit_svi_stream on the card: one pinned stack a group; group 1 and
    group 8 take the same steps on the same batches, bitwise."""
    x, xh = _stream_data(dev, 20011)
    m = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    st0, _ = m.fit_vi_fused(x, key=1, maxiter=3)

    def nb(i):
        idx = torch.randperm(xh.shape[0], generator=torch.Generator()
                             .manual_seed(100 + i))[:512].numpy()
        return xh[idx]

    kw = dict(total_size=xh.shape[0], maxiter=24, step_size=0.5,
              batch_size=512, init_state=st0, forgetting=0.7)
    a = m.fit_svi_stream(nb, group=1, **kw)
    b = m.fit_svi_stream(nb, group=8, **kw)
    assert torch.equal(a.components.mu, b.components.mu)
    assert torch.equal(a.gating.gamma, b.gating.gamma)
    c = m.fit_svi_stream(nb, group=8, transfer_dtype=torch.bfloat16, **kw)
    assert bool(torch.isfinite(c.components.mu).all())


# -- the kernels over a mesh's shards ----------------------------------------------

def _gmm_shard_inputs(dev, n, k=50, d=2, seed=0):
    """A float32 GMM's prior, uniform log weights and x (n, d) on the
    card, with the GMM spec."""
    from mimo_tpu_torch.ops.family_estep import gaussian_spec
    g = torch.Generator(device=dev).manual_seed(seed)
    m = BayesianGMM.make(size=k, dim=d, gating='dp', kappa=0.05,
                         psi_scale=0.5, device=dev)
    x = torch.randn((n, d), generator=g, device=dev) * 2
    log_pi = torch.log(torch.full((k,), 1.0 / k, device=dev))
    return m, gaussian_spec(), x, log_pi


def test_one_shard_b1_b2_b3_are_the_unsharded_launch(dev):
    """Over a one-position mesh, B1, B2 and B3 launch exactly as the
    unsharded wrappers do: bitwise the same statistics, lse, labels and
    densities, one launch each."""
    from mimo_tpu_torch.ops.cuda_estep import kernel_xts
    from mimo_tpu_torch.parallel import make_mesh
    m, spec, x, log_pi = _gmm_shard_inputs(dev, 100003)
    mesh = make_mesh(devices=[dev])
    xts = kernel_xts((x,))
    post = m.components_prior
    a = cuda_estep.fused_estep_cuda(spec, post, log_pi, xts, x.shape[0])
    before = dict(cuda_estep.launches)
    b = cuda_estep.fused_estep_cuda_sharded(spec, post, log_pi, [xts], mesh)
    assert cuda_estep.launches['gauss'] == before['gauss'] + 1
    assert torch.equal(a.lse, b.lse) and torch.equal(a.counts, b.counts)
    assert torch.equal(a.stats.xxT, b.stats.xxT)
    params = m.family.mode_params(post)
    seed = torch.tensor(4242, dtype=torch.int64, device=dev)
    la, ra = cuda_gibbs.fused_gibbs_cuda(spec, seed, params, log_pi, xts,
                                         x.shape[0])
    lb, rb = cuda_gibbs.fused_gibbs_cuda_sharded(spec, seed, params, log_pi,
                                                 [xts], mesh)
    assert torch.equal(la, lb[0]) and torch.equal(ra.counts, rb.counts)
    st = MFState(post, m.gating_prior)
    lw = m.predictive_log_weights(st)
    pa = cuda_predict.gauss_predictive_cuda(post, lw, x)
    pb = cuda_predict.gauss_predictive_cuda_sharded(post, lw, [x])
    assert torch.equal(pa, pb[0])


def test_sharded_b1_b2_b3_skip_an_empty_shard(dev):
    """Four shards, the second empty and the third one point: three
    launches of each kernel, an empty result for the empty shard, and
    statistics equal to the launches' sum; B2's shard 0 draws the
    unsharded labels."""
    from mimo_tpu_torch.ops.cuda_estep import kernel_xts
    from mimo_tpu_torch.parallel import make_mesh
    m, spec, x, log_pi = _gmm_shard_inputs(dev, 20011, seed=1)
    mesh = make_mesh(devices=[dev] * 4)
    parts = [x[:12000], x[12000:12000], x[12000:12001], x[12001:]]
    xts = [kernel_xts((p,)) for p in parts]
    post = m.components_prior
    before = dict(cuda_estep.launches)
    got = cuda_estep.fused_estep_cuda_sharded(spec, post, log_pi, xts, mesh)
    assert cuda_estep.launches['gauss'] == before['gauss'] + 3
    one = [cuda_estep.fused_estep_cuda(spec, post, log_pi, t, t[0].shape[1])
           for t in (xts[0], xts[2], xts[3])]
    assert torch.equal(got.lse, one[0].lse + one[1].lse + one[2].lse)
    assert torch.equal(got.counts,
                       one[0].counts + one[1].counts + one[2].counts)
    params = m.family.mode_params(post)
    seed = torch.tensor(99, dtype=torch.int64, device=dev)
    before = dict(cuda_gibbs.launches)
    labels, res = cuda_gibbs.fused_gibbs_cuda_sharded(spec, seed, params,
                                                      log_pi, xts, mesh)
    assert cuda_gibbs.launches['gauss'] == before['gauss'] + 3
    assert [t.shape[0] for t in labels] == [12000, 0, 1, 8010]
    lab0, _ = cuda_gibbs.fused_gibbs_cuda(spec, seed, params, log_pi,
                                          xts[0], 12000)
    assert torch.equal(labels[0], lab0)
    assert float(res.counts.sum()) == 20011
    lw = m.predictive_log_weights(MFState(post, m.gating_prior))
    before = cuda_predict.launches['gauss']
    outs = cuda_predict.gauss_predictive_cuda_sharded(post, lw, parts)
    assert cuda_predict.launches['gauss'] == before + 3
    assert [o.shape[0] for o in outs] == [12000, 0, 1, 8010]
    assert torch.equal(torch.cat(outs),
                       cuda_predict.gauss_predictive_cuda(post, lw, x))


def test_b1_b2_b3_read_a_view_at_an_odd_column_offset(dev):
    """A column view xt[:, 1:] (its start 4 bytes past the allocation's,
    its stride the parent's) gives bitwise what a fresh contiguous copy
    gives: B1 and B2 stage points with 4-byte copies, B3 reads scalars."""
    n, k, d = 100003, 50, 2
    xt, theta = _inputs(dev, n + 1, k, d, seed=2)
    view, copy = xt[:, 1:], xt[:, 1:].contiguous()
    assert view.data_ptr() % 16 == 4 and view.stride(0) == n + 1
    acc_v, lse_v = cuda_estep.estep(view, theta, n)
    acc_c, lse_c = cuda_estep.estep(copy, theta, n)
    assert torch.equal(acc_v, acc_c) and torch.equal(lse_v, lse_c)
    seed = torch.tensor(7, dtype=torch.int64, device=dev)
    lab_v, g_v = cuda_gibbs.gibbs(view, theta, seed, n)
    lab_c, g_c = cuda_gibbs.gibbs(copy, theta, seed, n)
    assert torch.equal(lab_v, lab_c) and torch.equal(g_v, g_c)
    m = BayesianGMM.make(size=k, dim=d, device=dev)
    thq, aux = cuda_predict.predictive_coefficients(
        m.components_prior, torch.full((k,), -3.9, device=dev))
    assert torch.equal(cuda_predict.predict(view, thq, aux, n),
                       cuda_predict.predict(copy, thq, aux, n))


def test_streams_over_a_mesh_launch_b1_once_a_shard(dev):
    """fit_vi_stream_full over a (1, 4) mesh on the card: B1 once per
    non-empty shard of every staged block (a column view of the staged
    buffer), one reduction a sweep, the unsharded stream's trace within
    rtol 1e-5; N = 5 over 8 positions launches 5 a sweep; fit_svi_stream
    over the mesh launches 4 a step."""
    import numpy as np
    from mimo_tpu_torch.parallel import make_mesh
    from mimo_tpu_torch.parallel import mesh as pmesh
    m, _, x, _ = _gmm_shard_inputs(dev, 3 * 40000 + 1234, seed=3)
    xh = x.cpu().numpy()
    b = 40000
    nb = -(-xh.shape[0] // b)
    st0, _ = m.fit_vi_fused(x, key=1, maxiter=2)
    mesh = make_mesh(devices=[dev] * 4)
    before = cuda_estep.launches['gauss']
    pmesh.reset_counters()
    st, tr = m.fit_vi_stream_full(lambda i: xh[i * b:(i + 1) * b], nb,
                                  init_state=st0, maxiter=2, mesh=mesh)
    torch.cuda.synchronize()
    assert cuda_estep.launches['gauss'] == before + 2 * 4 * nb
    assert pmesh.counters['sweep']['calls'] == 2
    su, tu = m.fit_vi_stream_full(lambda i: xh[i * b:(i + 1) * b], nb,
                                  init_state=st0, maxiter=2)
    torch.testing.assert_close(tr, tu, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(st.components.mu, su.components.mu,
                               rtol=1e-4, atol=1e-4)
    mesh8 = make_mesh(devices=[dev] * 8)
    before = cuda_estep.launches['gauss']
    st5, _ = m.fit_vi_stream_full(lambda i: xh[:5], 1, init_state=st0,
                                  maxiter=2, mesh=mesh8)
    torch.cuda.synchronize()
    assert cuda_estep.launches['gauss'] == before + 2 * 5
    rng = np.random.default_rng(0)
    before = cuda_estep.launches['gauss']
    sv = m.fit_svi_stream(lambda i: xh[rng.choice(xh.shape[0], 4096)],
                          xh.shape[0], key=2, maxiter=10, batch_size=4096,
                          group=4, mesh=mesh)
    torch.cuda.synchronize()
    assert cuda_estep.launches['gauss'] == before + 10 * 4
    assert bool(torch.isfinite(sv.components.mu).all())


@pytest.mark.parametrize('family', ['gmm', 'hier'])
def test_geweke_through_b2(dev, family):
    """The Geweke joint-distribution test of the full Gibbs transition in
    float32 on the card, its label sweep on B2 (one launch a
    transition): 1,500 draws, burn 150, thin 1, n=128, K=3, the size of
    the CPU harness tests. (At n=256 a 1,500-draw chain mixes too slowly
    for 50 batch means of 30 draws: healthy runs reach max|z| 6.6-10.)"""
    from mimo_tpu_torch.scripts import geweke_gibbs
    args = geweke_gibbs.parse_args(
        ['--backend', 'cuda', '--family', family, '--draws', '1500',
         '--burn', '150', '--thin', '1', '--n', '128'])
    before = sum(cuda_gibbs.launches.values())
    mx, _, result = geweke_gibbs.run(args, out=lambda s: None)
    assert sum(cuda_gibbs.launches.values()) - before == 1650
    assert result['dtype'] == 'float32'
    assert result['dropped_prior'] == 0 and result['dropped_succ'] == 0
    assert mx < 6.0, result
