"""The serving kernels B3 and B4 as they are laid out and as they round,
on the CPU (the kernels themselves run only on the card).

- Layout: B3's and B4's own layouts of their coefficients
  (`kernel_coefficients`: d padded to the compiled widths 12, 16, 24, 32
  of `serving_width` with zero coefficients, B3's padded widths
  group-major and term-major)
  and B4's h-shared flag, evaluated in float64 from the layout alone (B4
  with one log per component where the flag is set), agree with
  mimo_tpu's Pallas kernels in interpret mode and with the plain
  versions, at d = 2, 9, 24, 32; the flag is set exactly where mimo_tpu's
  tail exponents are equal across dims.
- Arithmetic: a pure-torch float32 emulation of the kernels' arithmetic
  (csrc/serving.cuh, csrc/diag_predict.cu, csrc/predict.cuh: the U fold of
  B4, log2_1p, the blocked softmax fold in log2 units, each FMA rounded
  once) lies within 10x of the f32 plain version's error against float64
  (the bound of chip_smoke.py's precision lines) at a fitted-scale cell,
  10 sigma off the origin, with tail exponents up to 1e5, and at a point
  so far out that B4's product 1 + U overflows, at d = 32 and at padded
  widths (where a padded dim then adds inf * 0). The MUFU approximations
  are modelled at their worst: rcp.approx 1 ulp, lg2.approx and
  ex2.approx 2^-22 relative, each biased one way.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.distributions import ng as jng
from mimo_tpu.distributions.niw import NIW as JNIW
from mimo_tpu.ops.pallas_predict import (
    diag_predictive_pallas, gauss_predictive_pallas)

from mimo_tpu_torch.distributions.ng import NG, predictive_studentt_params
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.ops import cuda_diag_predict, cuda_predict
from mimo_tpu_torch.ops.cuda_estep import DIAG, GAUSS, assemble_features

torch.set_num_threads(1)
LN2 = math.log(2.0)


# -- the layouts ---------------------------------------------------------------

def _niw_arrays(rng, k, d):
    a = rng.standard_normal((k, d, d))
    return dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(1, 50, k),
                psi=(a @ a.transpose(0, 2, 1) / d + np.eye(d)) * 0.5,
                nu=rng.uniform(d + 2, d + 40, k))


def _ng_arrays(rng, k, d):
    """alpha drawn per component (equal across dims: the models' case)
    for the even components and per (component, dim) for the odd."""
    alpha = np.repeat(rng.uniform(2, 40, (k, 1)), d, 1)
    alpha[1::2] = rng.uniform(2, 40, (k // 2, d))
    return dict(mu=rng.standard_normal((k, d)) * 2,
                kappa=rng.uniform(1, 20, (k, d)), alpha=alpha,
                beta=rng.uniform(0.5, 5, (k, d)))


def _b3_layout_eval(th, aux, m, d, kind, x, studentt):
    """B3's output from its kernel layout alone, in float64: x (n, d)."""
    th, aux = th.double(), aux.double()
    if th.dim() == 3:                                    # (K' / G, M, G)
        width = cuda_predict.serving_width(d)
        th = th.transpose(1, 2).reshape(-1, m)
        xp = torch.zeros((width, x.shape[0]), dtype=torch.float64)
        xp[:d] = x.T
        f = assemble_features(xp, -(-m // 8) * 8, kind)[:m]
    else:
        f = assemble_features(x.T.contiguous(), m, kind)
    q = torch.clamp(th @ f, min=0.0)
    tail = (aux[:, 1:2] * torch.log1p(q * aux[:, 2:3]) if studentt
            else 0.5 * q)
    return torch.logsumexp(aux[:, 0:1] - tail, 0)


@pytest.mark.parametrize('studentt', [True, False])
@pytest.mark.parametrize('d', [2, 9, 24, 32])
def test_b3_kernel_layout_matches_pallas_interpret(d, studentt):
    """B3's kernel copy (11 components: padded to 16 at the padded
    widths) against gauss_predictive_pallas in interpret mode (rtol 1e-5,
    atol 1e-4, the plain version's tolerance) and against the plain
    version in float64 (rtol 1e-12: the padding adds exact zeros)."""
    rng = np.random.default_rng(40 + d)
    k, n = 11, 256
    arrays = _niw_arrays(rng, k, d)
    log_w = np.log(rng.dirichlet(np.ones(k)))
    x = rng.standard_normal((n, d)) * 3
    dist = 'studentt' if studentt else 'gaussian'
    want = gauss_predictive_pallas(
        JNIW(**{f: jnp.asarray(v, jnp.float32) for f, v in arrays.items()}),
        jnp.asarray(log_w, jnp.float32), jnp.asarray(x, jnp.float32),
        block_size=256, dist=dist)
    post = NIW(**{f: torch.as_tensor(v) for f, v in arrays.items()})
    thq, aux = cuda_predict.predictive_coefficients(
        post, torch.as_tensor(log_w), studentt)
    th, auxk, m = cuda_predict.kernel_coefficients(thq, aux, d, GAUSS)
    if d > 8:
        width = cuda_predict.serving_width(d)
        assert th.shape == (2, 1 + width + width * width, 8)
        assert auxk.shape == (16, 8) and bool((auxk[k:, 0] == -math.inf)
                                              .all())
    got = _b3_layout_eval(th, auxk, m, d, GAUSS, torch.as_tensor(x),
                          studentt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-4)
    plain = cuda_predict.predict_plain(torch.as_tensor(x).T.contiguous(),
                                       thq, aux, n, studentt)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('d', [2, 9, 24, 32])
def test_b3_diag_kernel_layout_matches_pallas_interpret(d):
    """B3 over the diagonal map (the NG Gaussian predictive), its kernel
    copy against diag_predictive_pallas(dist='gaussian')."""
    rng = np.random.default_rng(50 + d)
    k, n = 11, 256
    arrays = _ng_arrays(rng, k, d)
    log_w = np.log(rng.dirichlet(np.ones(k)))
    x = rng.standard_normal((n, d)) * 2
    want = diag_predictive_pallas(
        jng.NG(**{f: jnp.asarray(v, jnp.float32) for f, v in arrays.items()}),
        jnp.asarray(log_w, jnp.float32), jnp.asarray(x, jnp.float32),
        block_size=256, dist='gaussian')
    post = NG(**{f: torch.as_tensor(v) for f, v in arrays.items()})
    thq, aux = cuda_predict.diag_gaussian_coefficients(
        post, torch.as_tensor(log_w))
    th, auxk, m = cuda_predict.kernel_coefficients(thq, aux, d, DIAG)
    got = _b3_layout_eval(th, auxk, m, d, DIAG, torch.as_tensor(x), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4)
    plain = cuda_predict.predict_plain(torch.as_tensor(x).T.contiguous(),
                                       thq, aux, n, False, DIAG)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


def _b4_layout_eval(rows, aux, d, x):
    """B4's output from its kernel layout alone, in float64: the one-log
    form h log2(prod_j (1 + u_j)) where the flag is set, the per-dim sum
    elsewhere."""
    rows, aux = rows.double(), aux.double()
    k = aux.shape[0]
    width = rows.shape[0] // k
    th = rows.view(k, width, 4)
    xp = torch.zeros((width, x.shape[0]), dtype=torch.float64)
    xp[:d] = x.T
    u = torch.clamp(th[..., 0:1] + th[..., 1:2] * xp + th[..., 2:3] * xp * xp,
                    min=0.0)                                  # (K, D, n)
    per_dim = torch.sum(th[..., 3:] * torch.log1p(u), 1)
    one_log = aux[:, 1:2] * torch.log(torch.prod(1.0 + u, 1))
    lp = aux[:, 0:1] - torch.where(aux[:, 1:2] > 0, one_log, per_dim)
    return torch.logsumexp(lp, 0)


@pytest.mark.parametrize('d', [2, 9, 24, 32])
def test_b4_kernel_layout_and_flag_match_pallas_interpret(d):
    """B4's kernel layout (rows padded to the compiled width with zero
    rows) and its h-shared flag, the one-log form where it is set,
    against diag_predictive_pallas in interpret mode (rtol 1e-4, atol
    1e-4) and the plain version in float64 (rtol 1e-12); the flag holds h
    exactly where mimo_tpu's tail exponents 0.5 (df + 1) are equal across
    dims."""
    rng = np.random.default_rng(60 + d)
    k, n = 10, 256
    arrays = _ng_arrays(rng, k, d)
    log_w = np.log(rng.dirichlet(np.ones(k)))
    x = rng.standard_normal((n, d)) * 2
    post_j = jng.NG(**{f: jnp.asarray(v, jnp.float32)
                       for f, v in arrays.items()})
    want = diag_predictive_pallas(post_j, jnp.asarray(log_w, jnp.float32),
                                  jnp.asarray(x, jnp.float32),
                                  block_size=256, dist='studentt')
    _, _, df_j = jng.predictive_studentt_params(
        jng.NG(**{f: jnp.asarray(v) for f, v in arrays.items()}))
    h_j = 0.5 * (np.asarray(df_j) + 1.0)
    equal = (h_j == h_j[:, :1]).all(1)
    post = NG(**{f: torch.as_tensor(v) for f, v in arrays.items()})
    rows, aux = cuda_diag_predict.diag_predict_coefficients(
        post, torch.as_tensor(log_w))
    width = cuda_predict.serving_width(d)
    rows_k = cuda_diag_predict.kernel_coefficients(rows, d)
    assert rows_k.shape == (k * width, 4) and aux.shape == (k, 2)
    assert bool((rows_k.view(k, width, 4)[:, d:] == 0).all())
    np.testing.assert_array_equal(aux[:, 1].numpy() > 0, equal)
    assert d == 1 or (equal[0::2].all() and not equal[1::2].any())
    np.testing.assert_array_equal(aux[equal, 1].numpy(), h_j[equal, 0])
    got = _b4_layout_eval(rows_k, aux, d, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4)
    plain = cuda_diag_predict.diag_predict_plain(
        torch.as_tensor(x).T.contiguous(), rows, aux, n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_serving_width_ladder():
    """The one ladder of compiled widths B3's and B4's hosts lay out for
    (the C entries take the width and refuse others)."""
    want = {**{d: d for d in range(1, 9)}, 9: 12, 12: 12, 13: 16, 16: 16,
            17: 24, 24: 24, 25: 32, 32: 32, 33: 0, 64: 0}
    assert {d: cuda_predict.serving_width(d) for d in want} == want


def test_cached_layout_is_built_once_per_unmodified_coefficients():
    """The wrappers' layout cache: one build while the coefficients are
    the same objects, unmodified; a new build after an in-place change to
    either, for another dependency or key; inference tensors every time."""
    builds = []

    def layout(thq, aux, key=(9, GAUSS)):
        return cuda_predict.cached_layout(
            thq, (aux,), key, lambda: builds.append(1) or
            cuda_predict.kernel_coefficients(thq, aux, 9, GAUSS))

    thq, aux = torch.randn((5, 96)), torch.randn((5, 8))
    first = layout(thq, aux)
    assert layout(thq, aux) is first and len(builds) == 1
    thq[0, 0] += 1.0
    second = layout(thq, aux)
    assert len(builds) == 2 and float(second[0][0, 0, 0]) == float(thq[0, 0])
    aux[1, 0] = 3.0
    assert float(layout(thq, aux)[1][1, 0]) == 3.0 and len(builds) == 3
    layout(thq, aux.clone())
    layout(thq, aux, (9, DIAG))
    assert len(builds) == 5
    with torch.inference_mode():
        ti, ai = torch.randn((5, 96)), torch.randn((5, 8))
    layout(ti, ai)
    layout(ti, ai)
    assert len(builds) == 7


# -- the arithmetic ------------------------------------------------------------

RCP_ERR, MUFU_ERR = 2.0 ** -23, 2.0 ** -22
LOG2E_F32 = float(np.float32(math.log2(math.e)))
C = [2.0 * math.log2(math.e) / (2 * i + 1) for i in range(7)]


def fma(a, b, c):
    """f32 fma: the exact product (48 bits fit a double) plus c, rounded
    to f32 (double rounding through f64 is off by at most an f32 tie)."""
    return (a.double() * b.double() + c.double()).float()


def rcp(x):
    return (1.0 / x.double() * (1.0 + RCP_ERR)).float()


def lg2(x):
    return (torch.log2(x.double()) * (1.0 + MUFU_ERR)).float()


def ex2(x):
    return (torch.exp2(x.double()) * (1.0 + MUFU_ERR)).float()


def log2_1p(u):
    """serving.cuh's log2_1p on f32 u >= 0."""
    c = [torch.tensor(v, dtype=torch.float32) for v in C]
    s = u * rcp(2.0 + u)
    s2 = s * s
    p = fma(c[6], s2, c[5])
    for i in (4, 3, 2, 1, 0):
        p = fma(p, s2, c[i])
    return torch.where(u <= 1.0, s * p, lg2(1.0 + u))


def blocked_fold(lp2, g=8):
    """fold_group over K (rows of lp2, log2 units) in groups of g, the
    tail one at a time; returns ln(sum_k e^lp) in f32, as fold_result."""
    k, n = lp2.shape
    mx = torch.full((n,), -math.inf)
    s = torch.zeros((n,))
    c = 0
    while c < k:
        w = g if c + g <= k else 1
        grp = lp2[c:c + w]
        m = torch.maximum(mx, grp.max(0).values)
        ms = torch.where(m == -math.inf, torch.zeros_like(m), m)
        s = s * ex2(mx - ms)
        for i in range(w):
            s = s + ex2(grp[i] - ms)
        mx, c = m, c + w
    return torch.tensor(LN2, dtype=torch.float32) * (
        mx + torch.log2(s.double()).float())


def emulated_b4(xt, rows, aux, n):
    """B4's arithmetic in f32 on its plain inputs, over the kernel's own
    copy of the rows (padded with zero rows to the compiled width, x with
    zeros): u per (k, j) as two FMAs, aux log2(e), the U fold where the
    flag is set (the per-dim sum over the d real dims for a point whose lp
    then is not > -inf: U overflowed, and a later u = 0 made inf * 0 =
    NaN), log2_1p, the blocked fold. Returns the output and the (K, n) lp
    before that guard."""
    d = xt.shape[0]
    k = aux.shape[0]
    th = cuda_diag_predict.kernel_coefficients(rows, d).view(k, -1, 4)
    aux2 = aux[:, 0] * torch.tensor(LOG2E_F32)
    x = torch.zeros((th.shape[1], n))
    x[:d] = xt[:, :n]
    lp2 = torch.empty((k, n))
    unguarded = torch.empty((k, n))
    for c in range(k):
        r = th[c]
        us = [torch.clamp(fma(r[j, 2], x[j] * x[j], fma(r[j, 1], x[j],
                                                        r[j, 0])), min=0.0)
              for j in range(th.shape[1])]
        if aux[c, 1] > 0:
            tail = torch.zeros((n,))
            for j in range(d):
                tail = fma(r[j, 3], log2_1p(us[j]), tail)
            u1 = us[0]
            for u in us[1:]:
                u1 = fma(u1, u, u1 + u)
            unguarded[c] = fma(-aux[c, 1], log2_1p(u1), aux2[c])
            lp2[c] = torch.where(unguarded[c] > -math.inf, unguarded[c],
                                 aux2[c] - tail)
        else:
            lp2[c] = aux2[c].expand(n)
            for j in range(d):
                lp2[c] = fma(-r[j, 3], log2_1p(us[j]), lp2[c])
            unguarded[c] = lp2[c]
    return blocked_fold(lp2), unguarded


def emulated_b3(xt, thq, aux, n, studentt=True):
    """B3's arithmetic in f32: the FMA chain in F's column order, the
    clip, log2_1p of q / df, the blocked fold."""
    m = cuda_predict.feature_width(GAUSS, xt.shape[0])
    f = assemble_features(xt[:, :n], thq.shape[1])
    log2e = torch.tensor(LOG2E_F32)
    lp2 = torch.empty((thq.shape[0], n))
    for c in range(thq.shape[0]):
        q = thq[c, 0].expand(n)
        for j in range(1, m):
            q = fma(thq[c, j], f[j], q)
        q = torch.clamp(q, min=0.0)
        a2 = aux[c, 0] * log2e
        if studentt:
            lp2[c] = fma(-aux[c, 1], log2_1p(q * aux[c, 2]), a2)
        else:
            lp2[c] = fma(-0.5 * log2e, q, a2)
    return blocked_fold(lp2)


def ratio(got, want, ref):
    """chip_smoke.py's precision ratio: max |got - ref| over max |want -
    ref|, the latter counted as at least 2^-24 of max |ref|."""
    ek = float((got.double() - ref).abs().max())
    ep = float((want.double() - ref).abs().max())
    return ek / max(ep, 2.0 ** -24 * float(ref.abs().max()))


def _fitted_ng(g, k, d, counts_hi, shift=0.0):
    """An NG posterior at the scales of a fit: counts 1e3..counts_hi per
    component (alpha = 1 + counts / 2 equal across dims, so h reaches
    counts_hi / 2), variances 0.25-0.75, means 4 N(0, 1) + shift."""
    counts = 1e3 + (counts_hi - 1e3) * torch.rand((k, 1), generator=g,
                                                  dtype=torch.float64)
    var = 0.25 + 0.5 * torch.rand((k, d), generator=g, dtype=torch.float64)
    return NG(mu=torch.randn((k, d), generator=g, dtype=torch.float64) * 4.0
              + shift, kappa=counts.expand(k, d), alpha=1.0 + 0.5 * counts
              .expand(k, d), beta=(0.5 * counts) * var)


def _draw(g, post, n):
    mu, lam, _ = predictive_studentt_params(post)
    idx = torch.randint(0, mu.shape[0], (n,), generator=g)
    return (mu[idx] + torch.randn(mu[idx].shape, generator=g,
                                  dtype=torch.float64) * lam[idx] ** -0.5)


@pytest.mark.parametrize('cell', ['main', 'off-origin', 'h 1e5'])
def test_emulated_b4_within_10x_of_the_plain_error(cell):
    """K=50, d=2, 20,000 points of the mixture: the main cell (counts to
    1e4), every centre >= 10 sigma off the origin (shift 60 in each dim),
    and counts to 2e5 (h to 1e5)."""
    g = torch.Generator().manual_seed(7)
    k, d, n = 50, 2, 20_000
    post = _fitted_ng(g, k, d, 2e5 if cell == 'h 1e5' else 1e4,
                      60.0 if cell == 'off-origin' else 0.0)
    x = _draw(g, post, n).float()
    log_w = torch.log_softmax(torch.randn((k,), generator=g,
                                          dtype=torch.float64), 0)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    rows, aux, xt = rows.float(), aux.float(), x.T.contiguous()
    assert bool((aux[:, 1] > 0).all())
    if cell == 'h 1e5':
        assert float(rows[:, 3].max()) > 5e4
    got, _ = emulated_b4(xt, rows, aux, n)
    want = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
    ref = cuda_diag_predict.diag_predict_plain(xt.double(), rows.double(),
                                               aux.double(), n)
    assert ratio(got, want, ref) <= 10.0


def test_emulated_b4_takes_the_per_dim_sum_where_u_overflows():
    """d=32, small counts (df ~ 10): a point 15 sigma out in every dim
    makes each 1 + u_j ~ 20, so prod_j (1 + u_j) ~ 1e41 overflows f32;
    the kernel's guard takes the per-dim sum there, and the emulation is
    finite wherever the plain version is and within 10x of its error.
    Without the guard that point would come out -inf."""
    g = torch.Generator().manual_seed(8)
    k, d, n = 4, 32, 512
    counts = torch.full((k, 1), 8.0, dtype=torch.float64)
    post = NG(mu=torch.randn((k, d), generator=g, dtype=torch.float64),
              kappa=counts.expand(k, d), alpha=(1.0 + 0.5 * counts)
              .expand(k, d), beta=0.5 * counts.expand(k, d) * 0.5)
    x = _draw(g, post, n)
    x[0] = 14.0
    log_w = torch.log_softmax(torch.randn((k,), generator=g,
                                          dtype=torch.float64), 0)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    rows, aux, xt = rows.float(), aux.float(), x.float().T.contiguous()
    got, lp = emulated_b4(xt, rows, aux, n)
    want = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
    ref = cuda_diag_predict.diag_predict_plain(xt.double(), rows.double(),
                                               aux.double(), n)
    assert int((~(lp > -math.inf)).sum()) >= k   # every component, point 0
    assert bool(torch.isfinite(want).all()) and bool(
        torch.isfinite(got).all())
    assert ratio(got, want, ref) <= 10.0


@pytest.mark.parametrize('d,far', [(9, 1e3), (17, 1e3), (30, 14.0)])
def test_emulated_b4_overflow_guard_at_padded_widths(d, far):
    """d padded to 12, 24, 32: once 1 + U overflows, the next padded dim
    (u = 0) makes U inf * 0 = NaN, not -inf; the guard (lp not > -inf)
    takes the per-dim sum there too. A point at `far` in every dim
    overflows every component (1e3 at d = 9 and 17, ~15 sigma at d = 30);
    the emulation stays finite and within 10x of the plain error, shared
    h or not."""
    g = torch.Generator().manual_seed(11)
    k, n = 4, 512
    counts = torch.full((k, 1), 8.0, dtype=torch.float64)
    alpha = (1.0 + 0.5 * counts).expand(k, d).clone()
    alpha[1] += torch.rand((d,), generator=g, dtype=torch.float64)
    post = NG(mu=torch.randn((k, d), generator=g, dtype=torch.float64),
              kappa=counts.expand(k, d), alpha=alpha,
              beta=0.5 * counts.expand(k, d) * 0.5)
    x = _draw(g, post, n)
    x[0] = far
    log_w = torch.log_softmax(torch.randn((k,), generator=g,
                                          dtype=torch.float64), 0)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    rows, aux, xt = rows.float(), aux.float(), x.float().T.contiguous()
    assert cuda_predict.serving_width(d) > d
    assert float(aux[1, 1]) == 0.0 and bool((aux[[0, 2, 3], 1] > 0).all())
    got, lp = emulated_b4(xt, rows, aux, n)
    want = cuda_diag_predict.diag_predict_plain(xt, rows, aux, n)
    ref = cuda_diag_predict.diag_predict_plain(xt.double(), rows.double(),
                                               aux.double(), n)
    assert bool(lp[[0, 2, 3], 0].isnan().all())   # inf * 0, not -inf
    assert bool(torch.isfinite(want).all()) and bool(
        torch.isfinite(got).all())
    assert ratio(got, want, ref) <= 10.0


def _fitted_niw(g, k, d, shift=0.0):
    """An NIW posterior at the scales of a fit at N ~ 1e6 (chip_smoke's
    random_posterior): kappa, nu up to 1e5, covariances ~1."""
    a = torch.randn((k, d, d), generator=g, dtype=torch.float64)
    nu = d + 2.0 + 1e5 * torch.rand((k,), generator=g, dtype=torch.float64)
    psi = (a @ a.transpose(-1, -2) / d + torch.eye(d, dtype=torch.float64)) \
        * nu[:, None, None]
    return NIW(mu=torch.randn((k, d), generator=g, dtype=torch.float64) * 4.0
               + shift, kappa=1.0 + 1e5 * torch.rand(
                   (k,), generator=g, dtype=torch.float64), psi=psi, nu=nu)


@pytest.mark.parametrize('studentt', [True, False])
@pytest.mark.parametrize('cell', ['main', 'off-origin'])
def test_emulated_b3_within_10x_of_the_plain_error(cell, studentt):
    """K=50, d=2, 20,000 points near the components; off the origin every
    centre sits >= 10 sigma out (shift 60)."""
    g = torch.Generator().manual_seed(9)
    k, d, n = 50, 2, 20_000
    post = _fitted_niw(g, k, d, 60.0 if cell == 'off-origin' else 0.0)
    idx = torch.randint(0, k, (n,), generator=g)
    x = (post.mu[idx] + torch.randn((n, d), generator=g,
                                    dtype=torch.float64)).float()
    log_w = torch.log_softmax(torch.randn((k,), generator=g,
                                          dtype=torch.float64), 0)
    thq, aux = cuda_predict.predictive_coefficients(post, log_w, studentt)
    thq, aux, xt = thq.float(), aux.float(), x.T.contiguous()
    got = emulated_b3(xt, thq, aux, n, studentt)
    want = cuda_predict.predict_plain(xt, thq, aux, n, studentt)
    ref = cuda_predict.predict_plain(xt.double(), thq.double(),
                                     aux.double(), n, studentt)
    assert ratio(got, want, ref) <= 10.0


def test_log2_1p_stays_relative_for_small_u():
    """log2_1p within 8 f32 ulps of log2(1 + u) relative, from u = 1e-30
    to 1e30, with the MUFU steps at their worst (6.1 ulps just past u = 1,
    where lg2.approx takes over; under 4 below u = 1e-3); lg2.approx(1 +
    u) alone is off by far more below u ~ 1e-3, the case h ~ 1e5
    multiplies."""
    u = torch.logspace(-30, 30, 20_001, dtype=torch.float64).float()
    want = torch.log1p(u.double()) / LN2
    rel = ((log2_1p(u).double() - want).abs() / want).max()
    assert float(rel) <= 8 * 2.0 ** -24
    small = u < 1e-3
    naive = ((lg2(1.0 + u[small]).double() - want[small]).abs()
             / want[small]).max()
    assert float(naive) > 1e3 * 2.0 ** -24


def test_blocked_fold_is_logsumexp():
    """The blocked fold in log2 units equals logsumexp in nats within
    f32 rounding, K not a multiple of the group, -inf rows included."""
    g = torch.Generator().manual_seed(10)
    lp = torch.randn((21, 1000), generator=g) * 30
    lp[3] = -math.inf
    got = blocked_fold((lp.double() / LN2).float())
    want = torch.logsumexp(lp.double(), 0)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert float(blocked_fold(torch.full((3, 4), -math.inf))[0]) == -math.inf
