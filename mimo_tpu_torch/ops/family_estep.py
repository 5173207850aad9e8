"""Fused mixture E-step and Gibbs label sweep over a family's feature map
(port of the Gaussian slice of mimo_tpu/ops/family_estep.py).

The expected log-likelihood is linear in a fixed feature map of the data,
E_q[log p(x | params_k)] = t(x) . theta_k with t = [1, x, x (x) x] for a
Gaussian, so a VI E-step over a block is two matmuls:

    logp  = F @ Theta^T                      (B, K)
    stats = ex^T @ (F / denom)               (K, m)

and the N x K responsibilities never exist at full N. The blockwise
functions here are the plain PyTorch twins of kernels B1 and B2 over the
(N, d) layout; ops/cuda_estep.py and ops/cuda_gibbs.py run the kernels
over the transposed (d, N) layout.
"""

from typing import Any, Callable, NamedTuple

import torch

from mimo_tpu_torch.distributions import niw as _niw
from mimo_tpu_torch.ops.philox import gumbel_max_labels
from mimo_tpu_torch.utils.linalg import logdet_psd
from mimo_tpu_torch.utils.stats import LOG2PI


class EStepSpec(NamedTuple):
    """Fused-E-step description of a conjugate family."""
    features: Callable[[Any], torch.Tensor]   # data tuple -> (N, m), col 0 == 1
    theta: Callable[[Any], torch.Tensor]      # posterior -> (K, m), E_q[nats]
    unpack: Callable[[torch.Tensor], Any]     # (K, m) accumulator -> stats
    # plug-in natural params for Gibbs label sweeps:
    # likelihood params -> (K, m) with log p(data|params_k) = t(data).row_k
    theta_plugin: Any = None
    # transposed feature assembler, (d_i, B) blocks -> (m, B); the kernels
    # build exactly this map on the card (see cuda_estep.py)
    features_t: Any = None


class FusedEStep(NamedTuple):
    stats: Any            # family stats struct
    lse: torch.Tensor     # () sum_n logsumexp_k
    counts: torch.Tensor  # (K,)


def _outer(a, b):
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def gauss_features_t(ts):
    """[1; x; x (x) x] from a (d, B) block -> (1 + d + d^2, B)."""
    (xt,) = ts
    d = xt.shape[0]
    one = torch.ones((1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    outer = (xt[:, None, :] * xt[None, :, :]).reshape(d * d, -1)
    return torch.cat([one, xt, outer], 0)


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
    last block may be short)."""
    theta = spec.theta(post)
    n = data[0].shape[0]
    acc = torch.zeros(theta.shape, dtype=data[0].dtype, device=data[0].device)
    lse = torch.zeros((), dtype=data[0].dtype, device=data[0].device)
    for s in range(0, n, block_size):
        feats = spec.features(tuple(a[s:s + block_size] for a in data))
        logp = feats @ theta.T + log_pi[None, :]
        m = torch.max(logp, -1).values
        ex = torch.exp(logp - m[:, None])
        denom = torch.sum(ex, -1)
        acc = acc + ex.T @ (feats / denom[:, None])
        lse = lse + torch.sum(m + torch.log(denom))
    return FusedEStep(stats=spec.unpack(acc), lse=lse, counts=acc[:, 0])


def fused_gibbs_blockwise(spec: EStepSpec, seed, params, log_pi, data,
                          block_size=131072):
    """Fused Gibbs label sweep: per block, plug-in log-densities (one
    matmul over the feature map) -> Gumbel-max labels from Philox keyed
    by (seed, global point index) -> one-hot statistics (one matmul).
    `seed` is a 0-d int64 tensor. Returns (labels (N,) int32, FusedEStep
    with lse = 0); the labels do not depend on block_size."""
    theta = spec.theta_plugin(params)
    k = theta.shape[0]
    n = data[0].shape[0]
    acc = torch.zeros(theta.shape, dtype=data[0].dtype, device=data[0].device)
    labels = []
    for s in range(0, n, block_size):
        feats = spec.features(tuple(a[s:s + block_size] for a in data))
        lab = gumbel_max_labels(feats @ theta.T + log_pi[None, :], seed, s)
        oh = torch.nn.functional.one_hot(lab.long(), k).to(feats.dtype)
        acc = acc + oh.T @ feats
        labels.append(lab)
    labels = (torch.cat(labels) if labels else
              torch.zeros((0,), dtype=torch.int32, device=data[0].device))
    return labels, FusedEStep(
        stats=spec.unpack(acc),
        lse=torch.zeros((), dtype=data[0].dtype, device=data[0].device),
        counts=acc[:, 0])
