"""Fused mixture E-step and Gibbs label sweep over a family's feature map
(port of mimo_tpu/ops/family_estep.py).

The expected log-likelihood is linear in a fixed feature map of the data,
E_q[log p(data | params_k)] = t(data) . theta_k, with t = [1, x, x (x) x]
for a Gaussian, t = [1, x, x^2] for a diagonal Gaussian and
t = [1, y (x) xt, xt (x) xt, y (x) y] for a linear expert with full or
diagonal noise (xt = [x; 1] when affine); a product family (the ILR experts,
basis(x) x model(y | x)) concatenates its members' maps and keeps one
constant. A VI E-step over a block is then two matmuls:

    logp  = F @ Theta^T                      (B, K)
    stats = ex^T @ (F / denom)               (K, m)

and the N x K responsibilities never exist at full N. The blockwise
functions here are the plain PyTorch twins of kernels B1 and B2 over the
(N, d) layout; ops/cuda_estep.py and ops/cuda_gibbs.py run the kernels
over the transposed (d, N) layout.
"""

from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap

from mimo_tpu_torch.distributions import affine as _aff
from mimo_tpu_torch.distributions import mnw as _mnw
from mimo_tpu_torch.distributions import ng as _ng
from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.distributions.mnw import augment
from mimo_tpu_torch.distributions.wishart import wishart_expected_logdet
from mimo_tpu_torch.ops.philox import gumbel_max_labels, shard_seed
from mimo_tpu_torch.parallel.mesh import local_mesh
from mimo_tpu_torch.utils.linalg import cholesky, inv_psd, logdet_psd
from mimo_tpu_torch.utils.stats import LOG2PI
from mimo_tpu_torch.utils.tree import tree_map


class EStepSpec(NamedTuple):
    """Fused-E-step description of a conjugate family."""
    features: Callable[[Any], torch.Tensor]   # data tuple -> (N, m), col 0 == 1
    theta: Callable[[Any], torch.Tensor]      # posterior -> (K, m), E_q[nats]
    unpack: Callable[[torch.Tensor], Any]     # (K, m) accumulator -> stats
    # plug-in natural params for Gibbs label sweeps:
    # likelihood params -> (K, m) with log p(data|params_k) = t(data).row_k
    theta_plugin: Any = None
    # transposed feature assembler, (d_i, B) blocks -> (m, B); the kernels
    # build the Gaussian, diagonal and ILR maps on the card (cuda_estep.py)
    features_t: Any = None


class FusedEStep(NamedTuple):
    stats: Any            # family stats struct
    lse: torch.Tensor     # () sum_n logsumexp_k
    counts: torch.Tensor  # (K,)


def _outer(a, b):
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


# -- transposed (kernel-side) feature assemblers ------------------------------
# Row order MUST mirror the specs' `features` exactly: the kernels build
# these maps on the card (csrc/common.cuh) and cuda_estep.py recognises
# them by value.

def _rows_outer(at, bt):
    """Transposed _outer: rows i*db + j = a_i b_j from (da, B), (db, B)."""
    return (at[:, None, :] * bt[None, :, :]).reshape(-1, at.shape[1])


def gauss_features_t(ts):
    """[1; x; x (x) x] from a (d, B) block -> (1 + d + d^2, B)."""
    (xt,) = ts
    one = torch.ones((1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    return torch.cat([one, xt, _rows_outer(xt, xt)], 0)


def diag_gauss_features_t(ts):
    """[1; x; x^2] from a (d, B) block -> (1 + 2d, B)."""
    (xt,) = ts
    one = torch.ones((1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    return torch.cat([one, xt, xt * xt], 0)


class LinearFeaturesT(NamedTuple):
    """[1; y (x) xa; xa (x) xa; y (x) y] from (x (d, B), y (p, B)) blocks,
    xa = [x; 1] when affine."""
    affine: bool

    def __call__(self, ts):
        xt, yt = ts
        one = torch.ones((1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
        xta = torch.cat([xt, one], 0) if self.affine else xt
        return torch.cat([one, _rows_outer(yt, xta), _rows_outer(xta, xta),
                          _rows_outer(yt, yt)], 0)


def linear_features_t(affine):
    return LinearFeaturesT(affine)


class ProductFeaturesT(NamedTuple):
    """The members' maps over their data slices, concatenated, with the
    duplicate constant rows beyond the first dropped (as in `features`)."""
    members: tuple
    data_slices: tuple

    def __call__(self, ts):
        blocks = [m(tuple(ts[i] for i in sl))
                  for m, sl in zip(self.members, self.data_slices)]
        return torch.cat([blocks[0]] + [b[1:] for b in blocks[1:]], 0)


def _product_features_t(specs, data_slices):
    members = tuple(s.features_t for s in specs)
    if any(m is None for m in members):
        return None
    return ProductFeaturesT(members, tuple(tuple(sl) for sl in data_slices))


def ilr_features_t(affine, diag_basis=False):
    """The ILR product map [1; x; x (x) x; y (x) xa; xa (x) xa; y (x) y]
    over (x (d, B), y (p, B)), or with `diag_basis` [1; x; x^2; y (x) xa;
    xa (x) xa; y (x) y]: the feature map of ilr_spec."""
    basis = diag_gauss_features_t if diag_basis else gauss_features_t
    return ProductFeaturesT((basis, LinearFeaturesT(affine)), ((0,), (0, 1)))


def gaussian_spec() -> EStepSpec:
    def features(data):
        x = data[0]
        one = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([one, x, _outer(x, x)], -1)

    def theta(post):
        e_lm, e_mlm, e_l, e_logdet = _niw.expected_stats(post)
        d = post.mu.shape[-1]
        c = e_mlm + e_logdet - 0.5 * d * LOG2PI
        return torch.cat([c[:, None], e_lm, e_l.reshape(-1, d * d)], -1)

    def theta_plugin(params):
        mu, lm = params.mu, params.lmbda
        d = mu.shape[-1]
        lmu = torch.einsum('kde,ke->kd', lm, mu)
        c = (-0.5 * torch.einsum('kd,kd->k', mu, lmu) + 0.5 * logdet_psd(lm)
             - 0.5 * d * LOG2PI)
        return torch.cat([c[:, None], lmu, -0.5 * lm.reshape(-1, d * d)], -1)

    return EStepSpec(features, theta, _unpack_gauss, theta_plugin,
                     gauss_features_t)


def _unpack_gauss(acc):
    m = acc.shape[-1]
    # m = 1 + d + d^2  =>  d = (-1 + sqrt(1 + 4(m-1))) / 2
    d = int((-1 + (1 + 4 * (m - 1)) ** 0.5) / 2)
    counts = acc[:, 0]
    return _niw.GaussStats(x=acc[:, 1:1 + d], n1=counts,
                           xxT=acc[:, 1 + d:].reshape(-1, d, d), n2=counts)


# -- hierarchically-tied Gaussian | NW hyper-prior ----------------------------

def hier_gaussian_spec() -> EStepSpec:
    """The HierTied expected log-likelihood is linear in [1, x, x (x) x]
    too: the shared E[Lambda] = nu psi of the hyper-posterior, h1_k =
    E[Lambda] mus_k, and the q(mu_k) covariance term -d / (2 kappa'_k)
    folded into the constant. The features, unpack, plug-in and
    transposed map are gaussian_spec's, so the kernels run it as the
    Gaussian map."""
    g = gaussian_spec()

    def theta(post):
        h = post.hyper
        k, d = post.mus.shape
        e_l = (h.nu[:, None, None] * h.psi)[0]               # (d, d)
        e_logdet = wishart_expected_logdet(cholesky(h.psi), h.nu)[0]
        h1 = post.mus @ e_l                                  # (K, d)
        c = (-0.5 * torch.einsum('kd,kd->k', post.mus, h1)
             - 0.5 * d / post.kappas
             + 0.5 * e_logdet - 0.5 * d * LOG2PI)
        h2 = (-0.5 * e_l).reshape(1, d * d).expand(k, d * d)
        return torch.cat([c[:, None], h1, h2], -1)

    return g._replace(theta=theta)


# -- diagonal Gaussian | NG --------------------------------------------------

def diag_gaussian_spec() -> EStepSpec:
    def features(data):
        x = data[0]
        one = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([one, x, torch.square(x)], -1)

    def theta(post):
        e_l = post.alpha / post.beta                       # (K, d)
        e_logl = torch.digamma(post.alpha) - torch.log(post.beta)
        d = post.mu.shape[-1]
        c = (0.5 * (torch.sum(e_logl, -1) - d * LOG2PI)
             - 0.5 * torch.sum(e_l * torch.square(post.mu) + 1.0 / post.kappa,
                               -1))
        return torch.cat([c[:, None], e_l * post.mu, -0.5 * e_l], -1)

    def unpack(acc):
        d = (acc.shape[-1] - 1) // 2
        counts = acc[:, 0]
        return _ng.DiagGaussStats(x=acc[:, 1:1 + d], n1=counts, n2=counts,
                                  xsq=acc[:, 1 + d:])

    def theta_plugin(params):
        mu, lm = params.mu, params.lmbda_diag
        d = mu.shape[-1]
        c = (0.5 * torch.sum(torch.log(lm) - lm * torch.square(mu), -1)
             - 0.5 * d * LOG2PI)
        return torch.cat([c[:, None], lm * mu, -0.5 * lm], -1)

    return EStepSpec(features, theta, unpack, theta_plugin,
                     diag_gauss_features_t)


# -- linear expert | MNW -----------------------------------------------------

def linear_spec(affine: bool = True, p_dim: int = None,
                q_dim: int = None) -> EStepSpec:
    """data = (x, y); x augmented internally when affine. p_dim / q_dim
    (output and augmented input widths) are needed only by unpack."""

    def features(data):
        xa = augment(data[0], affine)
        y = data[1]
        one = torch.ones((xa.shape[0], 1), dtype=xa.dtype, device=xa.device)
        return torch.cat([one, _outer(y, xa), _outer(xa, xa), _outer(y, y)],
                         -1)

    def theta(post):
        e_la, e_ala, e_l, e_logdet = _mnw.expected_stats(post)
        pd, qd = post.row_dim, post.col_dim
        c = e_logdet - 0.5 * pd * LOG2PI
        return torch.cat([c[:, None], e_la.reshape(-1, pd * qd),
                          e_ala.reshape(-1, qd * qd),
                          e_l.reshape(-1, pd * pd)], -1)

    def unpack(acc, p=p_dim, q=q_dim):
        o1 = 1 + p * q
        o2 = o1 + q * q
        return _mnw.LinGaussStats(yxT=acc[:, 1:o1].reshape(-1, p, q),
                                  xxT=acc[:, o1:o2].reshape(-1, q, q),
                                  yyT=acc[:, o2:].reshape(-1, p, p),
                                  n=acc[:, 0])

    def theta_plugin(params):
        a, lm = params.A, params.lmbda
        pd, qd = a.shape[-2], a.shape[-1]
        la = lm @ a                                        # (K, p, q)
        ala = a.transpose(-1, -2) @ la                     # (K, q, q)
        c = 0.5 * logdet_psd(lm) - 0.5 * pd * LOG2PI
        return torch.cat([c[:, None], la.reshape(-1, pd * qd),
                          -0.5 * ala.reshape(-1, qd * qd),
                          -0.5 * lm.reshape(-1, pd * pd)], -1)

    return EStepSpec(features, theta, unpack, theta_plugin,
                     linear_features_t(affine))


def diag_linear_spec(affine: bool = True, p_dim: int = None,
                     q_dim: int = None) -> EStepSpec:
    """Diagonal-noise linear expert | MNG. Shares linear_spec's feature
    map (the full y (x) y block, with E[lambda] embedded as a diagonal
    matrix), so the accumulator unpacks to the LinGaussStats the MNG
    update takes and the kernels run it as the linear map."""
    base = linear_spec(affine, p_dim, q_dim)

    def rows(c, la, ala, lmat):
        k = la.shape[0]
        return torch.cat([c[:, None], la.reshape(k, -1),
                          -0.5 * ala.reshape(k, -1),
                          -0.5 * lmat.reshape(k, -1)], -1)

    def theta(post):
        pd = post.row_dim
        e_l = post.alpha / post.beta                       # (K, p)
        e_logl = torch.digamma(post.alpha) - torch.log(post.beta)
        e_ala = (pd * inv_psd(post.K_)
                 + torch.einsum('kp,kpq,kpr->kqr', e_l, post.M, post.M))
        c = 0.5 * torch.sum(e_logl, -1) - 0.5 * pd * LOG2PI
        return rows(c, e_l[..., None] * post.M, e_ala, torch.diag_embed(e_l))

    def theta_plugin(params):
        a, lm = params.A, params.lmbda_diag                # (K,p,q), (K,p)
        pd = a.shape[-2]
        la = lm[..., None] * a                             # diag(l) A
        c = 0.5 * torch.sum(torch.log(lm), -1) - 0.5 * pd * LOG2PI
        return rows(c, la, a.transpose(-1, -2) @ la, torch.diag_embed(lm))

    return EStepSpec(base.features, theta, base.unpack, theta_plugin,
                     base.features_t)


# -- tied-affine experts -----------------------------------------------------

def tied_affine_spec(input_dim, output_dim) -> EStepSpec:
    """Tied-affine experts: their expected log-likelihood is the packed
    MNW's over the augmented input [x; 1], so linear_spec applies with
    theta over the packed posterior (the Gibbs params are packed already);
    unpack turns the augmented statistics into the AffineStats the
    family's update and Gibbs draw take (ym and xm are the augmentation
    column's sub-blocks). The features and transposed map are the affine
    linear map's, so the ILR product runs on the kernels' ILR map."""
    q = input_dim
    base = linear_spec(True, output_dim, q + 1)

    def theta(post):
        return base.theta(_aff.to_packed_mnw(post))

    def unpack(acc):
        lg = base.unpack(acc)
        return _aff.AffineStats(
            ym=lg.yxT[..., :, q], xm=lg.xxT[..., :q, q],
            yxT=lg.yxT[..., :, :q], xxT=lg.xxT[..., :q, :q],
            yyT=lg.yyT, n=lg.n)

    return base._replace(theta=theta, unpack=unpack)


# -- products (ILR: basis(x) x expert(y|x)) ----------------------------------

def _join_thetas(thetas):
    """Fold the members' constant columns into the first block's."""
    c_total = sum(th[:, 0] for th in thetas)
    return torch.cat([c_total[:, None], thetas[0][:, 1:]]
                     + [th[:, 1:] for th in thetas[1:]], -1)


def product_spec(specs, data_slices, widths) -> EStepSpec:
    """Concatenate member feature maps (the joint constant is member 0's)
    and theta blocks. `widths` are the member feature widths (incl. their
    constant column)."""

    def features(data):
        blocks = [s.features(tuple(data[i] for i in sl))
                  for s, sl in zip(specs, data_slices)]
        return torch.cat([blocks[0]] + [b[:, 1:] for b in blocks[1:]], -1)

    def theta(posts):
        return _join_thetas([s.theta(q) for s, q in zip(specs, posts)])

    def unpack(acc):
        counts = acc[:, 0]
        out, off = [], 0
        for i, (s, w) in enumerate(zip(specs, widths)):
            w_eff = w if i == 0 else w - 1
            block = acc[:, off:off + w_eff]
            if i > 0:
                block = torch.cat([counts[:, None], block], -1)
            out.append(s.unpack(block))
            off += w_eff
        return tuple(out)

    def theta_plugin(params_tuple):
        return _join_thetas([s.theta_plugin(pp)
                             for s, pp in zip(specs, params_tuple)])

    return EStepSpec(features, theta, unpack, theta_plugin,
                     _product_features_t(specs, data_slices))


def gauss_width(d):
    return 1 + d + d * d


def diag_gauss_width(d):
    return 1 + 2 * d


def linear_width(p, q):
    return 1 + p * q + q * q + p * p


def ilr_width(d, p, affine=True, diag_basis=False):
    """Width of the ILR product map (both members share one constant)."""
    basis = diag_gauss_width(d) if diag_basis else gauss_width(d)
    return basis + linear_width(p, d + int(affine)) - 1


def ilr_spec(input_dim, output_dim, affine=True, diag_basis=False,
             diag_expert=False, hier_basis=False, tied_affine=False):
    """The ILR joint family's fused spec: data = (x, y), an NIW or (with
    `hier_basis`) hierarchically-tied basis x MNW experts, MNG experts
    with `diag_expert` or tied-affine experts with `tied_affine` (which
    are affine by construction), or with `diag_basis` a diagonal (NG)
    basis; `hier_basis` takes precedence over `diag_basis`, as in the JAX
    package. Every combination has the ILR feature map, over the
    diagonal basis map [1; x; x^2] with `diag_basis`."""
    if hier_basis:
        basis, bw = hier_gaussian_spec(), gauss_width(input_dim)
    elif diag_basis:
        basis, bw = diag_gaussian_spec(), diag_gauss_width(input_dim)
    else:
        basis, bw = gaussian_spec(), gauss_width(input_dim)
    if tied_affine:
        q = input_dim + 1
        expert = tied_affine_spec(input_dim, output_dim)
    else:
        q = input_dim + int(affine)
        expert = (diag_linear_spec if diag_expert else linear_spec)(
            affine, output_dim, q)
    return product_spec((basis, expert), ((0,), (0, 1)),
                        (bw, linear_width(output_dim, q)))


# -- chains ---------------------------------------------------------------------

def chain_spec(spec: EStepSpec) -> EStepSpec:
    """The spec over C chains: theta and theta_plugin map C-stacked
    posteriors or params to (C, K, m) under torch.func.vmap, and unpack
    maps a (C, K, m) accumulator to C-stacked statistics (one unpack of
    the flat (C K, m) rows). The features are the same: the chains share
    the data, so the fused sweeps below and kernels B1/B2 take every
    chain's theta over one feature map."""
    def unpack(acc):
        lead = acc.shape[:-1]
        return tree_map(lambda a: a.reshape(lead + a.shape[1:]),
                        spec.unpack(acc.reshape(-1, acc.shape[-1])))

    return spec._replace(
        theta=vmap(spec.theta),
        theta_plugin=(None if spec.theta_plugin is None
                      else vmap(spec.theta_plugin)),
        unpack=unpack)


# -- the fused sweeps ----------------------------------------------------------

def fused_estep_dense(spec: EStepSpec, post, log_pi, data) -> FusedEStep:
    """Single-shot fused E-step (all N at once)."""
    feats = spec.features(data)
    logp = feats @ spec.theta(post).T + log_pi[None, :]
    m = torch.max(logp, -1).values
    ex = torch.exp(logp - m[:, None])
    denom = torch.sum(ex, -1)
    acc = ex.T @ (feats / denom[:, None])
    return FusedEStep(stats=spec.unpack(acc),
                      lse=torch.sum(m + torch.log(denom)), counts=acc[:, 0])


def fused_estep_blockwise(spec: EStepSpec, post, log_pi, data,
                          block_size=131072) -> FusedEStep:
    """Streamed fused E-step with O(B (K + m)) live memory; any N (the
    last block may be short). With a chain spec (`chain_spec`) over
    C-stacked posteriors and log_pi (C, K), every block serves all C
    chains: stats C-stacked, lse and counts (C,) and (C, K). The
    one-shard case of `fused_estep_sharded`."""
    return fused_estep_sharded(spec, post, log_pi, [data], block_size,
                               local_mesh(data[0].device))


def estep_zeros(theta, like):
    """The zero (acc, lse) of a fused E-step over theta (..., K, m), in
    the dtype and on the device of `like`."""
    return (torch.zeros(theta.shape, dtype=like.dtype, device=like.device),
            torch.zeros(theta.shape[:-2], dtype=like.dtype,
                        device=like.device))


def estep_accumulate(features, theta, log_pi, data, block_size, acc, lse):
    """Add the fused E-step of `data` over theta (K, m), or the chains'
    (C, K, m), to (acc, lse), block_size points at a time, and return
    the sums. The streamed engines carry (acc, lse) across their blocks,
    so a stream over blocks of block_size points adds exactly what
    fused_estep_blockwise adds over the data in memory."""
    n = data[0].shape[0]
    theta_t = theta.transpose(-1, -2)
    for s in range(0, n, block_size):
        feats = features(tuple(a[s:s + block_size] for a in data))
        logp = feats @ theta_t + log_pi[..., None, :]
        m = torch.max(logp, -1).values
        ex = torch.exp(logp - m[..., None])
        denom = torch.sum(ex, -1)
        acc = acc + ex.transpose(-1, -2) @ (feats / denom[..., None])
        lse = lse + torch.sum(m + torch.log(denom), -1)
    return acc, lse


def gibbs_accumulate(features, theta, log_pi, seed, data, block_size):
    """The fused Gibbs label sweep of `data` over the plug-in theta
    (K, m), or the chains' (C, K, m) with seeds (C,), block_size points at
    a time: (labels (..., N) int32, one-hot statistics acc (..., K, m))."""
    k = theta.shape[-2]
    n = data[0].shape[0]
    acc = torch.zeros(theta.shape, dtype=data[0].dtype, device=data[0].device)
    theta_t = theta.transpose(-1, -2)
    labels = []
    for s in range(0, n, block_size):
        feats = features(tuple(a[s:s + block_size] for a in data))
        lab = gumbel_max_labels(feats @ theta_t + log_pi[..., None, :], seed,
                                s)
        oh = torch.nn.functional.one_hot(lab.long(), k).to(feats.dtype)
        acc = acc + oh.transpose(-1, -2) @ feats
        labels.append(lab)
    labels = (torch.cat(labels, -1) if labels else
              torch.zeros(theta.shape[:-2] + (0,), dtype=torch.int32,
                          device=data[0].device))
    return labels, acc


def fused_gibbs_blockwise(spec: EStepSpec, seed, params, log_pi, data,
                          block_size=131072):
    """Fused Gibbs label sweep: per block, plug-in log-densities (one
    matmul over the feature map) -> Gumbel-max labels from Philox keyed
    by (seed, global point index) -> one-hot statistics (one matmul).
    `seed` is a 0-d int64 tensor. Returns (labels (N,) int32, FusedEStep
    with lse = 0); the labels do not depend on block_size. With a chain
    spec over C-stacked params, log_pi (C, K) and seeds (C,), chain c
    draws with seed[c]: labels (C, N). The one-shard case of
    `fused_gibbs_sharded`."""
    (labels,), res = fused_gibbs_sharded(spec, seed, params, log_pi, [data],
                                         block_size,
                                         local_mesh(data[0].device))
    return labels, res


# -- over a mesh -----------------------------------------------------------------
# Each shard's partial is one packed (..., K m8 + 1) buffer [acc zero-padded
# to m8 columns, lse], the layout of kernel B1's output, so the mesh's one
# reduction a sweep (parallel.mesh.Mesh.reduce) carries the same floats on
# the plain path and the kernel path, whatever N.

def padded_width(m):
    """m8: the feature width m padded up to a multiple of 8, the width of
    the kernels' theta rows and of a packed partial's accumulator."""
    return -(-m // 8) * 8


def pack_estep(acc, lse, m8):
    """acc (..., K, m) and lse (...) -> the (..., K m8 + 1) buffer."""
    acc = torch.nn.functional.pad(acc, (0, m8 - acc.shape[-1]))
    return torch.cat([acc.flatten(-2), lse[..., None]], -1)


def unpack_estep(buf, k, m8):
    """The (..., K m8 + 1) buffer -> (acc (..., K, m8), lse (...))."""
    return buf[..., :-1].unflatten(-1, (k, m8)), buf[..., -1]


def reduce_estep(spec, parts, lead, k, m, dtype, mesh):
    """The one reduction of a sharded sweep's packed partials -> its
    FusedEStep (statistics unpacked from the first m columns)."""
    m8 = padded_width(m)
    zero = torch.zeros(lead + (k * m8 + 1,), dtype=dtype,
                       device=mesh.devices[0])
    acc, lse = unpack_estep(mesh.reduce(parts, zero), k, m8)
    acc = acc[..., :m]
    return FusedEStep(stats=spec.unpack(acc), lse=lse, counts=acc[..., 0])


def fused_estep_sharded(spec: EStepSpec, post, log_pi, shards, block_size,
                        mesh) -> FusedEStep:
    """The fused E-step over a one-row mesh (the counterpart of mimo_tpu's
    fused_estep_sharded): `shards` the data tuples of the mesh's
    positions, in order, each on its position's device. Each shard runs
    the blockwise E-step on its device with theta replicated there
    (`accumulate_shards`; an empty shard adds zeros); then one reduction. With
    a chain spec, every shard serves all C chains."""
    theta = spec.theta(post)
    k, m = theta.shape[-2:]
    m8 = padded_width(m)
    parts = [pack_estep(acc, lse, m8) for acc, lse in accumulate_shards(
        spec.features, theta, log_pi, shards, block_size)]
    return reduce_estep(spec, parts, theta.shape[:-2], k, m,
                        shards[0][0].dtype, mesh)


def accumulate_shards(features, theta, log_pi, shards, block_size,
                      carry=None):
    """The blockwise E-step of each shard's data tuple on its device, with
    theta (..., K, m) and log_pi replicated there, added to carry[j] (that
    shard's running (acc, lse), zeros where None): one (acc, lse) a
    shard, without the reduction. The streamed engines carry each shard's
    sums across the blocks of a sweep and reduce once a sweep."""
    carry = [None] * len(shards) if carry is None else carry
    out = []
    for data, prev in zip(shards, carry):
        dev = data[0].device
        th = theta.to(dev)
        acc, lse = estep_zeros(th, data[0]) if prev is None else prev
        out.append(estep_accumulate(features, th, log_pi.to(dev), data,
                                    block_size, acc, lse))
    return out


def fused_gibbs_sharded(spec: EStepSpec, seed, params, log_pi, shards,
                        block_size, mesh):
    """The fused Gibbs label sweep over a one-row mesh (the counterpart of
    mimo_tpu's fused_gibbs_sharded): each shard draws its labels on its
    device with its shard seed (`philox.shard_seed`: shard 0 draws as the
    unsharded sweep does) and point indices local to the shard; the
    one-hot statistics take one reduction. Returns (labels: one
    (..., n_j) int32 tensor a shard, FusedEStep with lse = 0)."""
    theta = spec.theta_plugin(params)
    k, m = theta.shape[-2:]
    m8 = padded_width(m)
    labels, parts = [], []
    for p, data in zip(mesh.positions, shards):
        dev = data[0].device
        lab, acc = gibbs_accumulate(
            spec.features, theta.to(dev), log_pi.to(dev),
            shard_seed(seed.to(dev), mesh.shard_index(p)), data, block_size)
        labels.append(lab)
        parts.append(pack_estep(acc, acc.new_zeros(acc.shape[:-2]), m8))
    return labels, reduce_estep(spec, parts, theta.shape[:-2], k, m,
                                shards[0][0].dtype, mesh)
