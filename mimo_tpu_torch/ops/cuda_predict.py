"""Kernel B3, the fused posterior-predictive mixture density
(csrc/predict.cu), with its plain PyTorch version. Replaces
mimo_tpu/ops/pallas_predict.py::_predict_kernel.

Per point: F = [1; x; x (x) x] (kind GAUSS: NIW or HierTied posteriors)
or [1; x; x^2] (kind DIAG, the diagonal Gaussian predictive), the
quadratic forms Q = thq . F over
K (clipped at 0), then
lp = aux - h log1p(Q / df) (Student-t) or aux - Q / 2 (moment-matched
Gaussian), and out = logsumexp over K. The (N, K) Student-t matrix never
exists in device memory.

What bounds it on the H100, and what the kernel does about it: see the
note at the top of csrc/predict.cuh. The kernel works in log2 units and,
at d = 9..32, on its own layout of the coefficients
(`kernel_coefficients`, laid out once per coefficient tensor:
`cached_layout`); the plain version keeps natural units.
"""

import math

import torch

from mimo_tpu_torch.distributions import hierarchical as _hier
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.cuda_estep import (
    _CHUNK, DIAG, GAUSS, KIND_NAMES, assemble_features, feature_width)
from mimo_tpu_torch.ops.family_estep import padded_width
from mimo_tpu_torch.utils.linalg import logdet_psd
from mimo_tpu_torch.utils.logging import span, spanned
from mimo_tpu_torch.utils.stats import LOG2PI, gammaln_diff

# kernel launches by `predict`, by feature map, for run accounting
launches = {'gauss': 0, 'diag': 0}
# `cached_layout` calls that laid coefficients out anew (`built`) and that
# found their layout kept (`reused`), spans on or off
layouts = {'built': 0, 'reused': 0}

GROUP = 8    # components per group of B3's padded-width layout


def serving_width(d):
    """The width B3 and B4 compile an input width d at, which their hosts
    lay the coefficients out for (the one copy of this ladder: the C
    entries take the width and refuse one they do not compile): d itself
    up to 8, then 12, 16, 24 or 32 (d padded up with zeros), 0 past 32
    (the runtime width: d as it is)."""
    if d <= 8:
        return d
    return next((w for w in (12, 16, 24, 32) if d <= w), 0)


def cached_layout(coef, deps, key, build):
    """build(): a kernel's own layout of the coefficient tensor `coef`
    (built from coef, the tensors `deps` and `key`), kept on coef and
    reused while coef and deps are the same objects, unmodified (torch's
    version counters), with the same key: a posterior served batch after
    batch is laid out once. Inference tensors keep no version counter and
    are laid out on every call."""
    tensors = (coef,) + tuple(deps)
    if any(t.is_inference() for t in tensors):
        layouts['built'] += 1
        return build()
    stamp = (tuple(t._version for t in tensors), key)
    hit = getattr(coef, '_mimo_layout', None)
    if (hit is None or hit[1] != stamp
            or any(a is not b for a, b in zip(hit[0], deps))):
        hit = (tuple(deps), stamp, build())
        coef._mimo_layout = hit
        layouts['built'] += 1
    else:
        layouts['reused'] += 1
    return hit[2]


def kernel_coefficients(thq, aux, d, kind=GAUSS):
    """B3's own layout of (thq (K, m8), aux (K, 8)) at input width d, for
    the width the kernel compiles d at (`serving_width`): (th, aux', m).
    Up to 8 and at the runtime width (0) it is (thq, aux, m8) as they
    are. At a padded width w (12, 16, 24, 32) the map is padded to w and
    laid out group-major and term-major: th (K' / GROUP, M, GROUP) with M
    = the map's width at w and K' = K rounded up to GROUP, the extra
    components' coefficients zero and their aux rows [-inf, 0, ...]; m =
    M. Device-side copies only: nothing waits for the card."""
    width = serving_width(d)
    if width <= 8:
        return thq, aux, thq.shape[1]
    k = thq.shape[0]
    m = 1 + 2 * width if kind == DIAG else 1 + width + width * width
    kp = -(-k // GROUP) * GROUP
    th = thq.new_zeros((kp, m))
    th[:k, :1 + d] = thq[:, :1 + d]                    # [1; x]
    if kind == DIAG:                                   # x^2
        th[:k, 1 + width:1 + width + d] = thq[:, 1 + d:1 + 2 * d]
    else:                                              # x (x) x
        th[:k, 1 + width:].view(k, width, width)[:, :d, :d] = \
            thq[:, 1 + d:1 + d + d * d].view(k, d, d)
    rows = aux.new_zeros((kp, aux.shape[1]))
    rows[:, 0] = -math.inf
    rows[:k] = aux
    th = th.view(kp // GROUP, GROUP, m).transpose(1, 2).contiguous()
    return th, rows, m


def predict_plain(xt, thq, aux, n, studentt=True, kind=GAUSS):
    """Plain PyTorch version of B3: xt (d, >=n), thq (K, m8), aux (K, 8)
    holding [aux + log w, h, 1/df] -> (n,) mixture log-densities."""
    out = torch.empty((n,), dtype=thq.dtype, device=thq.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], thq.shape[1],
                              kind)
        q = torch.clamp(thq @ f, min=0.0)
        if studentt:
            lp = aux[:, 0:1] - aux[:, 1:2] * torch.log1p(q * aux[:, 2:3])
        else:
            lp = aux[:, 0:1] - 0.5 * q
        out[s:s + f.shape[1]] = torch.logsumexp(lp, 0)
    return out


def predict(xt, thq, aux, n, studentt=True, kind=GAUSS):
    """B3 over points 0..n-1 of xt (d, >=n), over the GAUSS or DIAG
    feature map. Launches the kernel for CUDA tensors (float32 only; it
    raises on anything else) and runs `predict_plain` for CPU tensors.
    Returns (n,) log-densities."""
    if not xt.is_cuda:
        return predict_plain(xt, thq, aux, n, studentt, kind)
    if kind not in (GAUSS, DIAG):
        raise ValueError(f'cuda_predict: no predictive over map {kind}')
    lib = _build.load()
    k = thq.shape[0]
    d = xt.shape[0]
    if (aux.dtype != torch.float32 or aux.shape != (k, 8)
            or not aux.is_contiguous() or aux.device != xt.device):
        raise ValueError('cuda_predict: aux must be a contiguous (K, 8) '
                         "float32 tensor on the data's device")
    _build.check_serving('cuda_predict', xt, n, thq, feature_width(kind, d),
                         f'{KIND_NAMES[kind]} map, d={d}', aux)
    width = serving_width(d)
    th, rows, m = (thq, aux, thq.shape[1]) if width <= 8 else cached_layout(
        thq, (aux,), (d, kind), lambda: kernel_coefficients(thq, aux, d,
                                                            kind))
    out = torch.empty((n,), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_predict(xt.data_ptr(), xt.stride(0), d, width, kind, n,
                              th.data_ptr(), rows.shape[0], m,
                              rows.data_ptr(), int(studentt), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_predict')
    launches[KIND_NAMES[kind]] += 1
    return out


def basis_studentt_params(post):
    """(mu (K, d), lmbda (K, d, d), df (K,)) of the per-component Student-t
    predictive of an NIW posterior (precision df / (1 + 1/kappa) psi) or
    of a HierTied one (precision df psi, the shared hyper scale, with no
    kappa factor), as mimo_tpu's _basis_studentt_params."""
    if isinstance(post, _hier.HierTied):
        return _hier.predictive_studentt_params(post)
    return _niw.predictive_studentt_params(post)


def predictive_coefficients(post, log_w, studentt=True):
    """(thq (K, m8), aux (K, 8)) of the mixture predictive of an NIW or
    HierTied posterior, in the posterior's dtype. The quad form is linear
    over [1, x, x (x) x]:
      delta_k(x) = mu'Lmu_k - 2 (Lmu_k)'x + vec(Lmbda_k) . vec(x x')."""
    mu, lmbda, df = basis_studentt_params(post)
    k, d = mu.shape
    lmu = torch.einsum('kde,ke->kd', lmbda, mu)
    m = 1 + d + d * d
    m8 = padded_width(m)
    thq = torch.cat([torch.einsum('kd,kd->k', mu, lmu)[:, None], -2.0 * lmu,
                     lmbda.reshape(k, d * d), lmu.new_zeros((k, m8 - m))], -1)
    if studentt:
        a = (gammaln_diff(0.5 * df, 0.5 * d) + 0.5 * logdet_psd(lmbda)
             - 0.5 * d * (torch.log(df) + math.log(math.pi)) + log_w)
        cols = [a, 0.5 * (df + d), 1.0 / df]
    else:   # moment-matched Gaussian predictive
        a = 0.5 * logdet_psd(lmbda) - 0.5 * d * math.log(2.0 * math.pi) + log_w
        cols = [a, torch.zeros_like(a), torch.zeros_like(a)]
    aux = torch.cat([torch.stack(cols, -1), a.new_zeros((k, 5))], -1)
    return thq.contiguous(), aux.contiguous()


def diag_gaussian_coefficients(post, log_w):
    """(thq (K, m8), aux (K, 8)) of the moment-matched Gaussian mixture
    predictive of an NG posterior over [1; x; x^2], in the posterior's
    dtype: q_k(x) = sum_j lam_kj (x_j - mu_kj)^2, one row per component
    (mimo_tpu's diag_predictive_pallas, dist='gaussian')."""
    from mimo_tpu_torch.distributions.ng import predictive_studentt_params
    mu, lam, _ = predictive_studentt_params(post)
    k, d = mu.shape
    m = 1 + 2 * d
    m8 = padded_width(m)
    thq = torch.cat([torch.sum(lam * mu * mu, -1)[:, None], -2.0 * lam * mu,
                     lam, lam.new_zeros((k, m8 - m))], -1)
    a = 0.5 * torch.sum(torch.log(lam), -1) - 0.5 * d * LOG2PI + log_w
    aux = torch.cat([a[:, None], a.new_zeros((k, 7))], -1)
    return thq.contiguous(), aux.contiguous()


def gauss_predictive_cuda(post, log_w, x, dist='studentt'):
    """logsumexp_k [log_w_k + pred_k(x)] -> (N,) for an NIW or HierTied
    posterior through B3, the counterpart of mimo_tpu's gauss_predictive_pallas.
    `dist`: 'studentt' (the posterior predictive) or 'gaussian' (its
    moment-matched approximation). x: (N, d)."""
    return gauss_predictive_cuda_sharded(post, log_w, [x], dist)[0]


@spanned('wrappers', 'b3')
def gauss_predictive_cuda_sharded(post, log_w, xs, dist='studentt'):
    """gauss_predictive_cuda over the shards of a mesh (xs: one (n_j, d)
    tensor a shard, each on its device), the counterpart of the mesh
    path of mimo_tpu's gauss_predictive_pallas: the coefficients are
    built once, and B3 serves each non-empty shard's rows in one launch
    on its device, with no collective. Returns one (n_j,) result a
    shard."""
    if dist not in ('studentt', 'gaussian'):
        raise ValueError(f'unknown dist: {dist!r}')
    studentt = dist == 'studentt'
    with span('algebra', 'coefficients'):
        thq, aux = predictive_coefficients(post, log_w, studentt)
    return [serve_shard(x, lambda xt: predict(
        xt, thq.to(xt.device, xt.dtype), aux.to(xt.device, xt.dtype),
        xt.shape[1], studentt)) for x in xs]


def serve_shard(x, serve):
    """serve(x's (d, n) transposed copy) for a shard x (n, d) with points;
    for an empty shard, launching nothing, an empty (0,) result in x's
    dtype. The copy has row stride n even at n = 1, where
    x.T.contiguous() would keep x.T's strides."""
    if not x.shape[0]:
        return x.new_empty((0,))
    xt = x.new_empty((x.shape[1], x.shape[0]))
    xt.copy_(x.T)
    return serve(xt)
