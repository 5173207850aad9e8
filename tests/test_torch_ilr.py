"""The port's ILR fit path against mimo_tpu, on the CPU: the ilr_spec
pieces and the fused E-step (float64, rtol 1e-8), kernel B1's plain
version over the ILR map against the Pallas E-step in interpret mode
(float32, the tolerances of tests/test_pallas.py), kernel B2's plain
version, the fused VI trace from a shared JAX state (float64, rtol 1e-8),
and a fused Gibbs -> VI fit of the sine data of tests/test_ilr.py held to
that file's thresholds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mimo_tpu.conjugate.families as jfam
from mimo_tpu.distributions.mnw import MNW as JMNW
from mimo_tpu.distributions.niw import NIW as JNIW
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.ops import family_estep as jfe
from mimo_tpu.ops.pallas_estep import fused_estep_pallas

import mimo_tpu_torch.conjugate.families as tfam
from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.config import GatingConfig, ILRConfig, MixtureConfig
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import BayesianGMM, BayesianILR, GibbsState
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.ops import cuda_estep, cuda_gibbs
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.ops.cuda_estep import kernel_xts
from mimo_tpu_torch.utils.tree import cast_floats

torch.set_num_threads(1)


def _psd(rng, k, d, scale=1.0):
    a = rng.standard_normal((k, d, d))
    return scale * (a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _posterior(rng, k, d, p, affine=True):
    """An (NIW, MNW) posterior with the scales of a fit at N ~ 1e3."""
    q = d + int(affine)
    niw = dict(mu=rng.standard_normal((k, d)), kappa=rng.uniform(50, 300, k),
               psi=_psd(rng, k, d, 0.02), nu=rng.uniform(50, 300, k))
    mnw = dict(M=rng.standard_normal((k, p, q)), K_=_psd(rng, k, q, 80.0),
               psi=_psd(rng, k, p, 0.05), nu=rng.uniform(50, 300, k))
    return niw, mnw


def _problem(dtype, n=1000, k=5, d=2, p=1, seed=3, affine=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    y = (np.sin(x.sum(-1, keepdims=True)) * np.ones((1, p))
         + 0.1 * rng.standard_normal((n, p)))
    niw, mnw = _posterior(rng, k, d, p, affine)
    log_pi = np.log(rng.dirichlet(np.ones(k) * 3))
    jd = jnp.float32 if dtype == 'f32' else jnp.float64
    td = torch.float32 if dtype == 'f32' else torch.float64
    jpost = (JNIW(**{f: jnp.asarray(v, jd) for f, v in niw.items()}),
             JMNW(**{f: jnp.asarray(v, jd) for f, v in mnw.items()}))
    tpost = (NIW(**{f: torch.as_tensor(v, dtype=td) for f, v in niw.items()}),
             MNW(**{f: torch.as_tensor(v, dtype=td) for f, v in mnw.items()}))
    return ((jnp.asarray(x, jd), jnp.asarray(y, jd)), jpost,
            jnp.asarray(log_pi, jd),
            (torch.as_tensor(x, dtype=td), torch.as_tensor(y, dtype=td)),
            tpost, torch.as_tensor(log_pi, dtype=td))


def _mode(post):
    return tfam.ilr_family().mode_params(post)


def _close_tree(got, want, rtol, atol):
    """Leaf by leaf, in field order (the two packages' NamedTuples are
    different classes with the same fields)."""
    got, want = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize('affine', [True, False])
@pytest.mark.parametrize('part', ['features', 'features_t', 'theta',
                                  'theta_plugin', 'unpack'])
def test_ilr_spec_pieces_match_jax(part, affine):
    dj, pj, _, dt, pt, _ = _problem('f64', n=40, d=2, p=2, affine=affine)
    js = jfe.ilr_spec(2, 2, affine=affine)
    ts = tfe.ilr_spec(2, 2, affine=affine)
    if part == 'features':
        got, want = ts.features(dt), js.features(dj)
    elif part == 'features_t':
        got = ts.features_t(tuple(a.T for a in dt))
        want = js.features_t(tuple(a.T for a in dj))
    elif part == 'theta':
        got, want = ts.theta(pt), js.theta(pj)
    elif part == 'theta_plugin':
        got = ts.theta_plugin(_mode(pt))
        want = js.theta_plugin(jfam.ilr_family().mode_params(pj))
    else:
        acc = np.random.default_rng(0).standard_normal(
            (5, tfe.ilr_width(2, 2, affine)))
        got, want = ts.unpack(torch.tensor(acc)), js.unpack(jnp.asarray(acc))
    _close_tree(got, want, rtol=1e-10, atol=1e-12)
    assert ts.features_t == tfe.ilr_features_t(affine)
    assert cuda_estep.feature_kind(ts.features_t) == (
        cuda_estep.ILR if affine else cuda_estep.ILR_LINEAR)


@pytest.mark.parametrize('engine', ['blockwise', 'dense', 'cuda_plain'])
def test_fused_estep_matches_jax_f64(engine):
    dj, pj, lpj, dt, pt, lpt = _problem('f64', n=600, d=2, p=2, seed=8)
    js, ts = jfe.ilr_spec(2, 2), tfe.ilr_spec(2, 2)
    want = jfe.fused_estep_blockwise(js, pj, lpj, dj, 200)
    if engine == 'blockwise':
        got = tfe.fused_estep_blockwise(ts, pt, lpt, dt, 128)  # ragged
    elif engine == 'dense':
        got = tfe.fused_estep_dense(ts, pt, lpt, dt)
    else:     # B1's plain version over the (d_i, N) layout, in float64
        got = cuda_estep.fused_estep_cuda(ts, pt, lpt,
                                          tuple(a.T for a in dt), 600)
    _close_tree(got.stats, want.stats, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-8)


@pytest.mark.parametrize('d,p', [(2, 1), (1, 3)])
def test_b1_plain_matches_pallas_interpret_ragged_tail(d, p):
    """N=1000 over blocks of 384 (the Pallas launcher pads and masks the
    tail); the port's plain B1 stops at n and ignores columns past it."""
    dj, pj, lpj, dt, pt, lpt = _problem('f32', n=1000, d=d, p=p, seed=d)
    js, ts = jfe.ilr_spec(d, p), tfe.ilr_spec(d, p)
    n = 1000
    xts = tuple(jnp.pad(a.T, ((0, 0), (0, (-n) % 384))) for a in dj)
    want = fused_estep_pallas(js, pj, lpj, xts, 384, n)
    padded = tuple(torch.cat([a.T, torch.full((a.shape[1], 24), 1e3)], 1)
                   for a in dt)
    got = cuda_estep.fused_estep_cuda(ts, pt, lpt, padded, n)
    _close_tree(got.stats, want.stats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(want.lse), rtol=1e-5)


def test_b2_plain_labels_and_one_hot_stats():
    """B2's plain version over the ILR map: labels in range, equal to the
    blockwise engine's (same Philox draws), and statistics equal to the
    one-hot sums of its own labels."""
    _, _, _, dt, pt, lpt = _problem('f64', n=700, d=2, p=2, seed=4)
    ts = tfe.ilr_spec(2, 2)
    params = _mode(pt)
    seed = torch.tensor(123456789, dtype=torch.int64)
    labels, res = cuda_gibbs.fused_gibbs_cuda(ts, seed, params, lpt,
                                              tuple(a.T for a in dt), 700)
    ref_labels, ref = tfe.fused_gibbs_blockwise(ts, seed, params, lpt, dt,
                                                256)
    assert labels.dtype == torch.int32
    assert 0 <= int(labels.min()) and int(labels.max()) < 5
    assert len(torch.unique(labels)) > 1
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    oh = torch.nn.functional.one_hot(labels.long(), 5).double()
    want = ts.unpack(oh.T @ ts.features(dt))
    _close_tree(res.stats, state_to_numpy(want), rtol=1e-12, atol=1e-10)
    _close_tree(res.stats, state_to_numpy(ref.stats), rtol=1e-12, atol=1e-10)


def test_kernel_results_cast_back_keeping_the_product_structure():
    """The engines cast the kernels' float32 statistics back to the data's
    dtype; a product family's statistics are a plain tuple of NamedTuples
    (this cast once assumed NamedTuples all the way down)."""
    _, _, _, dt, pt, lpt = _problem('f64', n=50, d=2, p=2)
    res = tfe.fused_estep_dense(tfe.ilr_spec(2, 2), pt, lpt, dt)
    cast = cast_floats(res, torch.float32)
    assert type(cast.stats) is tuple and len(cast.stats) == 2
    assert type(cast.stats[1]).__name__ == 'LinGaussStats'
    assert all(t.dtype == torch.float32 for t in
               list(cast.stats[0]) + list(cast.stats[1]) + [cast.lse])
    _close_tree(cast, state_to_numpy(res), rtol=1e-6, atol=1e-6)


def test_kernel_layout_stacks_x_and_y_without_copies():
    x, y = torch.randn(50, 3), torch.randn(50, 2)
    xts = kernel_xts((x, y))
    assert [a.shape for a in xts] == [(3, 50), (2, 50)]
    xt = cuda_estep.stack_rows(xts)
    assert xt.shape == (5, 50) and xt.data_ptr() == xts[0].data_ptr()
    torch.testing.assert_close(xt, torch.cat([x.T, y.T]))
    apart = (x.T.contiguous(), y.T.contiguous())
    torch.testing.assert_close(cuda_estep.stack_rows(apart),
                               torch.cat([x.T, y.T]))


@pytest.fixture(scope='module')
def vi_setup():
    """Sine-sum data (N=1200, d=2, p=1) in float64, standardized, and a
    shared initial state from random responsibilities."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-3, 3, (1200, 2))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((1200, 1))
    jm = JaxILR.make(size=6, input_dim=2, output_dim=1, alpha=2.0,
                     kappa=0.05, dtype=jnp.float64)
    jm.init_transform(jnp.asarray(x), jnp.asarray(y))
    resp = rng.dirichlet(np.ones(6), 1200)
    init = jm._mf_update((jm._tx(jnp.asarray(x)), jm._ty(jnp.asarray(y))),
                         jnp.asarray(resp))
    tm = BayesianILR.make(size=6, input_dim=2, output_dim=1, alpha=2.0,
                          kappa=0.05, dtype=torch.float64, device='cpu')
    tm.init_transform(torch.tensor(x), torch.tensor(y))
    return jm, tm, x, y, init


def test_vi_fused_trace_matches_jax_f64(vi_setup):
    jm, tm, x, y, init = vi_setup
    st_j, v_j = jm.fit_vi_fused((jnp.asarray(x), jnp.asarray(y)), maxiter=8,
                                init_state=init, randomize=False,
                                backend='xla', block_size=400)
    st_t, v_t = tm.fit_vi_fused(
        (torch.tensor(x), torch.tensor(y)), maxiter=8,
        init_state=state_from_numpy(jax.tree.map(np.asarray, init)),
        randomize=False, block_size=500)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-8)
    _close_tree(st_t, jax.tree.map(np.asarray, st_j), rtol=1e-8, atol=1e-9)
    assert bool((torch.diff(v_t) > -1e-6).all())
    # the transforms agree too (population std, as jnp.std)
    _close_tree(tm.output_transform, jm.output_transform, rtol=1e-12,
                atol=0.0)


def test_gibbs_then_vi_recovers_the_sine():
    """The flagship recipe on the fused engines (Gibbs init -> VI warm
    start -> predict) on tests/test_ilr.py's sine data and settings, held
    to its thresholds: RMSE < 0.16 (noise floor 0.1), mean NLPD < 0, a
    monotone ELBO in float64. The Gibbs chain draws from the port's
    Philox, not JAX's threefry, so the fit is the port's own."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(-6.0, 6.0, (1200, 1)))
    y = torch.sin(x) + 0.1 * torch.tensor(rng.standard_normal((1200, 1)))
    m = BayesianILR.make(size=30, input_dim=1, output_dim=1,
                         gating='stick-breaking', alpha=5.0, kappa=0.05,
                         K_scale=1e-2, dtype=torch.float64, device='cpu')
    m.init_transform(x, y)
    g = m.fit_gibbs_fused((x, y), key=0, maxiter=50)
    assert isinstance(g, GibbsState) and g.labels.shape == (1200,)
    st, vlb = m.fit_vi_fused((x, y), key=1, maxiter=200,
                             init_state=MFState(g.components, g.gating),
                             randomize=False)
    d = np.diff(vlb.numpy())
    assert np.all(d > -1e-6), d.min()
    mu, var, std, nlpd = m.predict(st, x, y)
    rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
    assert rmse < 0.16, rmse
    assert float(nlpd.mean()) < 0.0
    assert bool((var > 0).all())


def test_generate_draws_from_the_known_mixture():
    """BayesianILR.generate: labels follow the weights, x the basis
    Gaussians and y the chosen expert's line within its noise."""
    from mimo_tpu_torch.distributions.mnw import LinGaussParams
    from mimo_tpu_torch.distributions.niw import GaussParams
    d64 = torch.float64
    basis = GaussParams(mu=torch.tensor([[-3.0], [3.0]], dtype=d64),
                        lmbda=torch.full((2, 1, 1), 4.0, dtype=d64))
    experts = LinGaussParams(
        A=torch.tensor([[[2.0, 1.0]], [[-1.0, 0.5]]], dtype=d64),
        lmbda=torch.full((2, 1, 1), 100.0, dtype=d64))
    x, y, z = BayesianILR.generate(7, basis, experts, [0.25, 0.75], 20000)
    assert x.shape == (20000, 1) and y.shape == (20000, 1)
    assert abs(float((z == 1).double().mean()) - 0.75) < 0.02
    for k in (0, 1):
        xk, yk = x[z == k, 0], y[z == k, 0]
        assert abs(float(xk.mean()) - float(basis.mu[k, 0])) < 0.03
        assert abs(float(xk.std()) - 0.5) < 0.02
        resid = yk - (experts.A[k, 0, 0] * xk + experts.A[k, 0, 1])
        assert abs(float(resid.std()) - 0.1) < 0.005
        assert abs(float(resid.mean())) < 0.005


def test_make_and_configs_refuse_unported_variants():
    """The variants that were refused before they were ported (tied-affine
    experts, the hierarchical basis, tied and hierarchical GMMs) now
    build through make, the configs and ilr_spec, and fit."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(-2, 2, (300, 1)))
    y = torch.sin(x) + 0.1 * torch.tensor(rng.standard_normal((300, 1)))
    for kw in (dict(tied_affine=True), dict(hier_basis=True)):
        m = BayesianILR.make(size=3, input_dim=1, output_dim=1,
                             dtype=torch.float64, maxsubiter=3, **kw,
                             device='cpu')
        st, vlb = m.fit_vi_fused((x, y), key=1, maxiter=3)
        assert bool(torch.isfinite(vlb).all())
        assert m.predict(st, x)[0].shape == (300, 1)
        assert isinstance(ILRConfig(**kw).build(device='cpu'), BayesianILR)
    for kw in (dict(tied=True), dict(hierarchical=True)):
        g = MixtureConfig(size=3, maxsubiter=3, **kw).build(torch.float64,
                                                            device='cpu')
        st, vlb = g.fit_vi_fused(torch.cat([x, y], 1), key=1, maxiter=3)
        assert bool(torch.isfinite(vlb).all())
    assert tfe.ilr_spec(1, 1, hier_basis=True).features_t \
        == tfe.ilr_features_t(True)


def test_configs_build_the_port_models():
    m = ILRConfig(size=7, input_dim=2, output_dim=3,
                  gating=GatingConfig('dirichlet', 2.0)).build(torch.float64,
                                                               device='cpu')
    assert isinstance(m, BayesianILR) and m.size == 7
    assert m.components_prior[1].M.shape == (7, 3, 3)
    assert m.components_prior[1].M.dtype == torch.float64
    assert float(m.gating_prior.alpha[0]) == 2.0
    g = MixtureConfig(size=4, dim=3).build(device='cpu')
    assert isinstance(g, BayesianGMM) and g.components_prior.mu.shape == (4, 3)


def test_bridge_round_trips_ilr_states(vi_setup):
    jm, _, x, y, init = vi_setup
    src = jax.tree.map(np.asarray, init)
    port = state_from_numpy(src)
    assert isinstance(port.components[0], NIW)
    assert isinstance(port.components[1], MNW)
    _close_tree(port, src, rtol=0.0, atol=0.0)
    gs = jm.fit_gibbs_fused((jnp.asarray(x), jnp.asarray(y)), key=2,
                            maxiter=1, backend='xla', block_size=400)
    port = state_from_numpy(jax.tree.map(np.asarray, gs))
    assert isinstance(port, GibbsState)
    assert type(port.params[1]).__name__ == 'LinGaussParams'
    std = state_from_numpy(jax.tree.map(np.asarray, jm.input_transform))
    assert type(std).__name__ == 'Standardizer'
