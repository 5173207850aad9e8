"""The reference (portbench/reference) against the port's plain path
(backend='torch') at tiny sizes in float64: a VI fit, the Gibbs
conditional and the predictive. The test imports both; the reference
imports nothing of the port."""

import pytest
import torch

import pb_support
from harness import cells
from reference import dpgmm
from reference.precision import matmul, tf32_round
from mimo_tpu_torch.distributions.gating import StickBreaking
from mimo_tpu_torch.distributions.niw import NIW, mode_params, sample_params
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.parallel import fit_chains

MAKE = dict(gating='dp', alpha=1.0, kappa=0.05, psi_scale=0.5)
GMM = cells.adapter('BayesianGMM', pb_support.BENCH)


def config(n, k, d):
    return {'make': dict(MAKE, size=k, dim=d),
            'data': {'kind': 'blobs', 'n': n, 'weights': [0.3, 0.4, 0.3],
                     'mean_scale': 4.0, 'precision': 2.0}}


def setup(n, k, d, chains, seed=5):
    cfg = config(n, k, d)
    x = GMM.data(cfg, seed, torch.device('cpu')).double()
    start = GMM.start(cfg, x.float(), chains, seed, sub=2048)
    model = BayesianGMM.make(size=k, dim=d, dtype=torch.float64,
                             device='cpu', **MAKE)
    prior = dpgmm.make_prior(cfg['make'], d, torch.float64, x.device)
    return model, x, dpgmm.cast(start, torch.float64), prior


def as_state(p, chain=None):
    p = p if chain is None else {k: v[chain] for k, v in p.items()}
    return MFState(NIW(p['mu'], p['kappa'], p['psi'], p['nu']),
                   StickBreaking(p['gamma'], p['delta']))


def state_dict(st):
    c, g = st.components, st.gating
    return dict(mu=c.mu, kappa=c.kappa, psi=c.psi, nu=c.nu, gamma=g.gamma,
                delta=g.delta)


def assert_posteriors_close(a, b, rtol):
    na, nb = dpgmm.natural(a), dpgmm.natural(b)
    for key in na:
        torch.testing.assert_close(na[key], nb[key], rtol=rtol, atol=0.0)


@pytest.mark.parametrize('chains,d,k', [(1, 2, 6), (2, 2, 6), (1, 3, 5)])
def test_vi_fit_matches_port(chains, d, k):
    model, x, start, prior = setup(3000, k, d, chains)
    ref, ref_trace = dpgmm.vi_fit(x, prior, start, 4)
    if chains == 1:
        st, trace = model.fit_vi_fused(x, maxiter=4, backend='torch',
                                       init_state=as_state(start, 0),
                                       randomize=False)
        st, trace = state_dict(st), trace[None]
        st = {k_: v[None] for k_, v in st.items()}
    else:
        st, trace = fit_chains(model, 'fit_vi_fused', x, [1, 2], maxiter=4,
                               backend='torch', init_state=as_state(start),
                               randomize=False)
        st = state_dict(st)
    torch.testing.assert_close(trace, ref_trace, rtol=1e-10, atol=0.0)
    assert_posteriors_close(st, ref, 1e-8)


def test_gibbs_conditional_matches_port():
    model, x, _, prior = setup(4000, 6, 2, 1)
    gs = model.fit_gibbs_fused(x, key=3, maxiter=3, backend='torch')
    labels = gs.labels[None]
    ref = dpgmm.posterior(prior, *dpgmm.stats_from_labels(x, labels, 6))
    port = {k: v[None] for k, v in state_dict(gs).items()}
    assert_posteriors_close(port, ref, 1e-9)
    # the labels' conditional: the port's plug-in log-densities
    logp_port = torch.log_softmax(
        model.family.loglik(gs.params, (x,)) + gs.log_pi, -1)
    theta = dpgmm.plugin_theta(gs.params.mu, gs.params.lmbda,
                               gs.log_pi).reshape(6, -1)
    logp_ref = dpgmm.label_logp(x, theta, 1, 6)[:, 0]
    torch.testing.assert_close(logp_ref, logp_port, rtol=1e-9, atol=1e-9)


def test_label_test_reads_draws_as_sound():
    model, x, _, _ = setup(20000, 6, 2, 1)
    gs = model.fit_gibbs_fused(x, key=4, maxiter=4, backend='torch')
    args = (x, gs.params.mu[None], gs.params.lmbda[None], gs.log_pi[None])
    assert float(dpgmm.label_test(*args, gs.labels[None]).abs().max()) < 5
    shifted = (gs.labels + 1) % 6
    assert float(dpgmm.label_test(*args, shifted[None]).abs().max()) > 50


def test_draw_test_reads_draws_as_sound():
    """The port's samplers drawing 400 times from one posterior whose last
    two of 6 components are empty read z^2 as N(0, 1) would in every
    group; the posterior's mode in their place reads far from it."""
    _, x, _, prior = setup(20000, 6, 2, 1)
    labels = (torch.arange(x.shape[0]) % 4)[None]
    post = dpgmm.posterior(prior, *dpgmm.stats_from_labels(x, labels, 6))
    post = {k: v.expand((400,) + v.shape[1:]) for k, v in post.items()}
    comp = NIW(post['mu'], post['kappa'], post['psi'], post['nu'])
    sticks = StickBreaking(post['gamma'], post['delta'])
    g = torch.Generator().manual_seed(6)
    params = sample_params(g, comp)
    log_pi = torch.log(sticks.sample(g))
    tests = dpgmm.draw_test(post, params.mu, params.lmbda, log_pi)
    assert {k: z.numel() for k, z in tests.items()} == {
        'mu': 2400, 'lmbda': 2400, 'sticks': 400}
    for z in tests.values():
        assert 0.8 < float((z * z).mean()) < 1.25
    assert dpgmm.draw_z2_dev(tests) < 0.3
    mode = mode_params(comp)
    log_mode = torch.log(sticks.mode().clamp(min=1e-37))
    assert dpgmm.draw_z2_dev(dpgmm.draw_test(post, mode.mu, mode.lmbda,
                                             log_mode)) > 3.0


@pytest.mark.parametrize('d', [2, 4])
def test_predictive_matches_port(d):
    model, x, start, _ = setup(3000, 5, d, 1)
    st, _ = model.fit_vi_fused(x, maxiter=3, backend='torch',
                               init_state=as_state(start, 0),
                               randomize=False)
    lp_port = model.log_predictive(st, x, backend='torch')
    lp_ref = dpgmm.predictive(x, state_dict(st))
    torch.testing.assert_close(lp_ref, lp_port, rtol=1e-10, atol=1e-10)


def test_tf32_rounding():
    one = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10,
                        3.0], dtype=torch.float32)
    out = tf32_round(one)
    want = torch.tensor([1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10, 3.0])
    assert torch.equal(out, want)
    a = torch.randn(4096, dtype=torch.float32)
    rel = ((tf32_round(a) - a) / a).abs().max()
    assert float(rel) <= 2 ** -11
    b = torch.randn(64, 8, dtype=torch.float64)
    c = torch.randn(8, 16, dtype=torch.float64)
    exact = b @ c
    assert float((matmul(b, c, 'f64') - exact).abs().max()) < 1e-12
    assert float((matmul(b, c, 'tf32') - exact).abs().max()) > 1e-5
