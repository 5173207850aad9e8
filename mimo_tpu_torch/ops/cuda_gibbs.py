"""Kernel B2, the fused blocked-Gibbs label sweep (csrc/gibbs.cuh), with
its plain PyTorch version. Replaces mimo_tpu/ops/pallas_gibbs.py::_gibbs_kernel.

Per point: plug-in logp = theta . F over K (F the Gaussian, diagonal or
ILR map, the last over a full or diagonal basis, as in B1), Gumbel noise
from Philox4x32-10 keyed by (sweep seed, global point index)
(ops/philox.py), the first-occurrence argmax over K as the label, and
acc (K, m8) += one_hot(label) F^T. The plain version draws
the same Philox numbers, so kernel and plain labels agree draw for draw
except at near-ties that the f32 summation order decides.

What bounds it on the H100, and what the kernel does about it: see the
note at the top of csrc/gibbs.cuh.

Chains: theta (C, K, m8) with seeds (C,) runs C label sweeps over the same
points in one launch and returns labels (C, N) and acc (C, K, m8); chain c
draws Philox keyed by (seed[c], point index) on the one-chain grid, so
its labels and statistics are bitwise a one-chain launch at seed[c].

Mesh: `fused_gibbs_cuda_sharded` launches B2 once per non-empty shard of
a one-row mesh with the shard's seed (philox.shard_seed) and makes the
mesh's one reduction of the one-hot statistics; the labels stay on their
shards.
"""

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.cuda_estep import (
    _CHUNK, GAUSS, KIND_NAMES, assemble_features, check_theta, feature_kind,
    feature_width, pad_theta, stack_rows, y_rows)
from mimo_tpu_torch.ops.family_estep import pack_estep, reduce_estep
from mimo_tpu_torch.ops.philox import gumbel_max_labels, shard_seed
from mimo_tpu_torch.parallel.mesh import local_mesh
from mimo_tpu_torch.utils.logging import span, spanned

# kernel launches by `gibbs`, by feature map, for run accounting
launches = {'gauss': 0, 'ilr': 0, 'diag': 0, 'ilr_diag': 0}


def gibbs_plain(xt, theta, seed, n, kind=GAUSS, p=0):
    """Plain PyTorch version of B2: xt (d + p, >=n), theta (K, m8) with
    log pi in column 0, seed a 0-d int64 tensor -> (labels (n,) int32,
    acc (K, m8)); theta (C, K, m8) with seeds (C,) -> the C chains'
    (labels (C, n), acc (C, K, m8)), one chain at a time."""
    if theta.dim() == 3:
        labs, accs = zip(*(gibbs_plain(xt, th, sd, n, kind, p)
                           for th, sd in zip(theta, seed.reshape(-1))))
        return torch.stack(labs), torch.stack(accs)
    k, m8 = theta.shape
    acc = torch.zeros((k, m8), dtype=theta.dtype, device=theta.device)
    labels = torch.empty((n,), dtype=torch.int32, device=theta.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], m8, kind, p)
        lab = gumbel_max_labels((theta @ f).T, seed, s)
        labels[s:s + lab.shape[0]] = lab
        oh = torch.nn.functional.one_hot(lab.long(), k).to(f.dtype)
        acc = acc + oh.T @ f.T
    return labels, acc


def gibbs(xt, theta, seed, n, kind=GAUSS, p=0):
    """B2 over points 0..n-1 of xt (d + p, >=n), x rows then p y rows:
    theta (K, m8) with one seed, or the C chains' theta (C, K, m8) with
    seeds (C,). Launches the kernel for CUDA tensors (float32 data, int64
    seeds on the same device; it raises on anything else) and runs
    `gibbs_plain` for CPU tensors. Returns (labels (n,) int32, acc
    (K, m8)), or (labels (C, n), acc (C, K, m8))."""
    if not xt.is_cuda:
        return gibbs_plain(xt, theta, seed, n, kind, p)
    lib = _build.load()
    k, m8 = theta.shape[-2:]
    chains = theta.shape[0] if theta.dim() == 3 else 1
    d = xt.shape[0] - p
    desc = f'{KIND_NAMES[kind]} map, d={d}, p={p}'
    check_theta('cuda_gibbs', xt, n, theta, feature_width(kind, d, p), desc)
    if (seed.dtype != torch.int64 or seed.numel() != chains
            or seed.device != xt.device):
        raise ValueError(f'cuda_gibbs: seeds must be {chains} int64 on the '
                         "data's device, one a chain")
    seed = seed.contiguous()
    labels = torch.empty((chains, n), dtype=torch.int32, device=xt.device)
    work = _build.tc_scratch('cuda_gibbs', lib, lib.mimo_gibbs_scratch, xt,
                             n, theta, desc, chains)
    acc = torch.empty((chains, k, m8), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_gibbs(xt.data_ptr(), xt.stride(0), d, p, kind, n,
                            theta.data_ptr(), k, m8, seed.data_ptr(),
                            labels.data_ptr(), work.data_ptr(),
                            acc.data_ptr(), chains,
                            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_gibbs')
    launches[KIND_NAMES[kind]] += 1
    return (labels, acc) if theta.dim() == 3 else (labels[0], acc[0])


def gumbel_fast_error(device):
    """The largest |fast draw - accurate draw| over all 2^23 uniforms u =
    m 2^-23 of B2: the MUFU draw by which the kernel picks the components
    that take the accurate draw, against -log(-log(u + 1e-20) + 1e-20) in
    float64. The labels stay exact while it is under half the kernel's
    margin of 2^-10 (csrc/gibbs.cuh fast_margin)."""
    lib = _build.load()
    out = torch.empty((1 << 23,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.mimo_gumbel_fast(out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_gibbs.gumbel_fast_error')
    u = torch.arange(1 << 23, device=device, dtype=torch.float64) * 2.0 ** -23
    ref = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return float((out.double() - ref).abs().max())


def fused_gibbs_cuda(spec, seed, params, log_pi, xts, n):
    """Spec-driven fused Gibbs label sweep through B2, the counterpart of
    mimo_tpu's fused_gibbs_pallas, over points 0..n-1 of xts (n at run
    time). Returns (labels (n,) int32, FusedEStep with one-hot stats and
    lse = 0). With a chain spec (family_estep.chain_spec) over C-stacked
    params, log_pi (C, K) and seeds (C,), one launch serves every chain:
    labels (C, n). The one-shard case of `fused_gibbs_cuda_sharded`."""
    (labels,), res = fused_gibbs_cuda_sharded(
        spec, seed, params, log_pi, [xts], local_mesh(xts[0].device), [n])
    return labels, res


@spanned('wrappers', 'b2')
def fused_gibbs_cuda_sharded(spec, seed, params, log_pi, shards, mesh,
                             ns=None):
    """The fused Gibbs label sweep over a one-row mesh through B2, the
    counterpart of mimo_tpu's fused_gibbs_pallas_sharded: `shards` the
    kernel layouts of the mesh's positions, in order, `ns` their point
    counts (by default their widths). B2 runs once per non-empty shard, on
    its device, with the shard's seed (the sweep seed XOR shard index x
    0x9E3779B9: shard 0 draws as the unsharded sweep) and point indices
    local to the shard; the labels stay on their shards, and the one-hot
    statistics, packed as B1's output is with a zero lse, take one
    reduction. Returns (labels: one (..., n_j) int32 tensor a shard,
    FusedEStep in the layout's dtype with lse = 0)."""
    kind = feature_kind(spec.features_t)
    dtype = shards[0][0].dtype
    with span('algebra', 'theta'):
        theta, m = pad_theta(spec.theta_plugin(params), log_pi, dtype)
    m8 = theta.shape[-1]
    ns = [xts[0].shape[1] for xts in shards] if ns is None else ns
    labels, parts = [], []
    for p, xts, n in zip(mesh.positions, shards, ns):
        dev = xts[0].device
        if not n:
            labels.append(torch.zeros(theta.shape[:-2] + (0,),
                                      dtype=torch.int32, device=dev))
            continue
        lab, acc = gibbs(stack_rows(xts), theta.to(dev),
                         shard_seed(seed.to(dev), mesh.shard_index(p)), n,
                         kind, y_rows(kind, xts))
        labels.append(lab)
        parts.append(pack_estep(acc, acc.new_zeros(acc.shape[:-2]), m8))
    return labels, reduce_estep(spec, parts, theta.shape[:-2],
                                theta.shape[-2], m, dtype, mesh)
