"""The precision rule of kernels B1 and B2 (csrc/estep.cuh), emulated on
the CPU by mimo_tpu_torch/ops/precision.py: TF32 rounding
(cvt.rna.tf32.f32: round to nearest, ties away from zero, 10 mantissa
bits kept), the exact three-part splits of theta and F for the logits
(six passes), and the two-part splits of P and F for the statistics
(three passes). The emulated B1 is held to float64 at
theta from `mimo_tpu` fits run on the CPU at small N (DP-GMM, diagonal
GMM, ILR with MNW experts at d=2 and d=8) and converted with the bridge,
within the card's tolerances and within 10x the f32 plain version's
error; and each split the rule keeps is shown to be needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions.niw import GaussParams as JParams
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR

from mimo_tpu_torch.bridge import state_from_numpy
from mimo_tpu_torch.models import BayesianILR
from mimo_tpu_torch.ops import cuda_estep
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.ops.cuda_estep import (
    DIAG, GAUSS, ILR, assemble_features, pad_theta)
from mimo_tpu_torch.ops.precision import (
    RULE, emulated_estep, split2, split3, tf32)

torch.set_num_threads(1)


def errors(xt, theta, n, kind=GAUSS, p=0, **kw):
    """Errors against float64 of the emulated kernel and of the f32 plain
    version: statistics as max |err| / summed magnitude sum_n r |F|, lse
    relative, and (last) the logits' max |err| / sum_j |theta_j F_j|,
    emulated and f32."""
    m8 = theta.shape[1]
    f64 = assemble_features(xt[:, :n].double(), m8, kind, p)
    s64 = theta.double() @ f64
    r64 = torch.softmax(s64, 0)
    acc64, lse64 = r64 @ f64.T, torch.logsumexp(s64, 0).sum()
    mag = (r64 @ f64.abs().T).clamp(min=1e-300)
    smag = theta.double().abs() @ f64.abs()

    def rel(acc, lse):
        return (float(((acc.double() - acc64).abs() / mag).max()),
                abs(float(lse) - float(lse64)) / abs(float(lse64)))

    acc, lse, logits = emulated_estep(xt, theta, n, kind, p, **kw)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, p)
    plogits = theta @ assemble_features(xt[:, :n], m8, kind, p)
    return (rel(acc, lse), rel(pacc, plse),
            tuple(float(((lg.double() - s64).abs() / smag).max())
                  for lg in (logits, plogits)))


def separated_gmm(lam, mu_scale, k=50, n=8192, seed=3):
    """Gauss-map theta of K components of precision lam (1-2x) with means
    mu_scale N(0, 1) from the origin, and n points drawn from them
    (spread 2 / sqrt(lam)): the constant column c = -lam |mu|^2 / 2 is
    large against the logits, as in fits far from the origin."""
    g = torch.Generator().manual_seed(seed)
    mu = torch.randn((k, 2), generator=g) * mu_scale
    lam = lam * (1 + torch.rand((k,), generator=g))
    theta = torch.zeros((k, 8))
    theta[:, 0] = -0.5 * lam * (mu ** 2).sum(1) + torch.log(lam)
    theta[:, 1:3] = lam[:, None] * mu
    theta[:, 3] = theta[:, 6] = -0.5 * lam
    xt = (mu[torch.randint(0, k, (n,), generator=g)].T
          + torch.randn((2, n), generator=g) * 2.0 / float(lam.min()) ** 0.5)
    return xt.contiguous(), theta


def ratio(kernel, plain):
    """The precision line's ratio (chip_smoke.py): the plain version's
    error counted as at least half an f32 ulp."""
    return kernel / max(plain, 2.0 ** -24)


@pytest.fixture(scope='module')
def gmm_thetas():
    """theta at mimo_tpu VI fits on the data of tests/test_pallas.py
    (N=4096, K=8, d=2): the DP-GMM (NIW) and the diagonal GMM (NG)."""
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = JaxGMM.generate(jax.random.PRNGKey(0),
                           JParams(jnp.asarray([[-3., 0.], [3., 0.],
                                                [0., 4.]]), lm),
                           jnp.asarray([.3, .4, .3]), 4096)
    x = x.astype(jnp.float32)
    out = {}
    for name, kw, spec, kind in (
            ('gauss', dict(gating='dp', psi_scale=0.5), tfe.gaussian_spec(),
             GAUSS),
            ('diag', dict(diag=True), tfe.diag_gaussian_spec(), DIAG)):
        jm = JaxGMM.make(size=8, dim=2, kappa=0.05, dtype=jnp.float32, **kw)
        st, _ = jm.fit_vi_fused(x, key=1, maxiter=30, backend='xla')
        st = state_from_numpy(jax.tree.map(np.asarray, st),
                              dtype=torch.float32)
        theta, _ = pad_theta(spec.theta(st.components),
                             st.gating.expected_log_pi(), torch.float32)
        out[name] = (torch.tensor(np.asarray(x)).T.contiguous(), theta, kind,
                     0)
    return out


@pytest.fixture(scope='module')
def ilr_thetas():
    """theta at mimo_tpu VI fits of ILR with MNW experts (K=8) on
    y = sin(x w) + 0.1 eps, x ~ U(-3, 3)^d, N=2000, at d=2 and d=8
    (m8 = 24 and 168), in the fit's standardized units."""
    rng = np.random.default_rng(0)
    out = {}
    for d in (2, 8):
        x = rng.uniform(-3, 3, (2000, d))
        y = (np.sin(x @ rng.standard_normal((d, 1)))
             + 0.1 * rng.standard_normal((2000, 1)))
        xj, yj = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
        jm = JaxILR.make(size=8, input_dim=d, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float32)
        jm.init_transform(xj, yj)
        st, _ = jm.fit_vi_fused((xj, yj), key=1, maxiter=30, backend='xla')
        st = state_from_numpy(jax.tree.map(np.asarray, st),
                              dtype=torch.float32)
        spec = BayesianILR.make(size=8, input_dim=d, output_dim=1,
                                device='cpu')._estep_spec()
        theta, _ = pad_theta(spec.theta(st.components),
                             st.gating.expected_log_pi(), torch.float32)
        xt = torch.tensor(np.concatenate(
            [np.asarray(jm._tx(xj)), np.asarray(jm._ty(yj))], 1).T.copy())
        out[d] = (xt, theta, ILR, 1)
    return out


def _case(gmm_thetas, ilr_thetas, name):
    if name in gmm_thetas:
        return gmm_thetas[name]
    return ilr_thetas[int(name[-1])]


CASES = ['gauss', 'diag', 'ilr d=2', 'ilr d=8']


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                 # the tf32 after 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -12,
                      3.0e38, 0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, one, 1.0, 3.0e38, 0.0])
    got = tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 5]], want[[0, 1, 2, 3, 5]])
    assert abs(float(got[4]) - 3.0e38) <= 3.0e38 * 2.0 ** -11
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_splits_are_exact_where_the_rule_needs_them():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10_000, generator=g) * torch.exp(
        torch.randn(10_000, generator=g) * 5)
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(tf32(part), part)
    assert torch.equal((hi + mid) + lo, x)
    hi, lo = split2(x)
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs().clamp(min=1e-300)).max()) <= 2.0 ** -22


@pytest.mark.parametrize('name', CASES)
def test_rule_holds_the_cards_tolerances_of_float64(gmm_thetas, ilr_thetas,
                                                   name):
    """The emulated B1 within the tolerances chip_smoke.py holds the kernel
    to (statistics within 1e-5 of their summed magnitude, lse rtol 1e-5),
    here against float64, and within 10x the f32 plain version's error."""
    xt, theta, kind, p = _case(gmm_thetas, ilr_thetas, name)
    (ks, kl), (ps, pl), (kg, pg) = errors(xt, theta, xt.shape[1], kind, p)
    assert ks <= 1e-5 and kl <= 1e-5
    assert ratio(ks, ps) <= 10 and ratio(kl, pl) <= 10
    assert kg <= 10 * pg


@pytest.mark.parametrize('name', CASES)
def test_logits_of_the_rule_are_exact_products(gmm_thetas, ilr_thetas,
                                               name):
    """Six passes keep every product term down to 2^-22: the logits are
    within 2^-22 of sum_j |theta_j F_j| (f32 rounding of the sums) on every
    map, and the three terms dropped below 2^-33 change them by less."""
    xt, theta, kind, p = _case(gmm_thetas, ilr_thetas, name)
    n = xt.shape[1]
    full = tuple((a, b) for a in range(3) for b in range(3))
    full = tuple(t for t in full if t not in RULE) + RULE
    _, _, rule = emulated_estep(xt, theta, n, kind, p)
    _, _, exact = emulated_estep(xt, theta, n, kind, p, terms=full)
    f64 = assemble_features(xt[:, :n].double(), theta.shape[1], kind, p)
    smag = theta.double().abs() @ f64.abs()
    assert float(((rule.double() - exact.double()).abs() / smag).max()) \
        <= 2.0 ** -22


def test_dropping_thetas_third_part_breaks_the_rule():
    """3xTF32 (theta in two parts, to 2^-22) leaves a systematic
    per-component error: where unit-precision components sit 10 sigma from
    the origin the emulated B1 is more than 10x less precise than f32 in
    lse and in the statistics; the rule's exact theta is not."""
    xt, theta = separated_gmm(1.0, 10.0)
    n = xt.shape[1]
    three_x = ((1, 0), (0, 1), (0, 0))     # theta's third part dropped
    (ks, kl), (ps, pl), _ = errors(xt, theta, n, terms=three_x)
    assert ratio(kl, pl) > 10 and ratio(ks, ps) > 10
    (ks, kl), (ps, pl), _ = errors(xt, theta, n)
    assert ratio(kl, pl) <= 10 and ratio(ks, ps) <= 10


def test_dropping_the_split_of_p_breaks_the_rule(gmm_thetas, ilr_thetas):
    """The statistics with P in one tf32 pass (the TPU kernel's single
    pass) are more than 10x less precise than f32 on every map."""
    for name in CASES:
        xt, theta, kind, p = _case(gmm_thetas, ilr_thetas, name)
        (ks, _), (ps, _), _ = errors(xt, theta, xt.shape[1], kind, p,
                                     split_p=False)
        assert ratio(ks, ps) > 10, name
