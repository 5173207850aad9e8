"""Kernel B1, the fused mixture E-step (csrc/estep.cuh), with its plain
PyTorch version. Replaces mimo_tpu/ops/pallas_estep.py::_estep_kernel2.

Per point: F = the spec's feature map (the Gaussian [1; x; x (x) x],
the diagonal [1; x; x^2] or the ILR product [1; x; x (x) x; y (x) xa;
xa (x) xa; y (x) y], for MNW and MNG experts alike, with [1; x; x^2]
for its basis block over a diagonal (NG) basis),
logp = theta . F over K (theta's column 0 holds c + log pi, so counts =
acc[:, 0]), a softmax over K with a 1e-37 denominator floor,
acc (K, m8) += (ex / denom) F^T and lse += logsumexp.

The kernels read one stacked float32 array xt = [x rows; y rows] of
shape (d + p, N); `kind` names the feature map (GAUSS, DIAG, and
ILR / ILR_LINEAR: the ILR map with and without the experts' ones column;
ILR_DIAG / ILR_DIAG_LINEAR the same over the diagonal basis)
and `p` the number of y rows. What bounds B1 on the H100, and what the
kernel does about it: see the note at the top of csrc/estep.cuh.

Chains: theta of shape (C, K, m8) runs C independent E-steps over the
same points in one launch (the counterpart of jax.vmap over the Pallas
kernel, which prepends a chain axis to its grid) and returns acc
(C, K, m8) and lse (C,); chain c is bitwise a one-chain launch at
theta[c].

Mesh: `fused_estep_cuda_sharded` launches B1 once per non-empty shard of
a one-row mesh (`estep_shards`) and makes the mesh's one reduction of the
packed outputs. `BlockEStep` adds each shard's partials across the calls
of a sweep (the streamed blocks, or the SVI chains' own minibatches),
through B1 or its blockwise twin, and reduces once a sweep.
"""

import torch

from mimo_tpu_torch.ops import _build
from mimo_tpu_torch.ops.family_estep import (
    accumulate_shards, diag_gauss_features_t, diag_gauss_width,
    gauss_features_t, gauss_width, ilr_features_t, ilr_width, pack_estep,
    padded_width, reduce_estep)
from mimo_tpu_torch.parallel.mesh import local_mesh
from mimo_tpu_torch.utils.logging import span, spanned
from mimo_tpu_torch.utils.tree import tree_map

# feature-map codes of the C entries (csrc/common.cuh kKind*)
GAUSS, ILR, ILR_LINEAR, DIAG, ILR_DIAG, ILR_DIAG_LINEAR = 0, 1, 2, 3, 4, 5
KIND_NAMES = {GAUSS: 'gauss', ILR: 'ilr', ILR_LINEAR: 'ilr', DIAG: 'diag',
              ILR_DIAG: 'ilr_diag', ILR_DIAG_LINEAR: 'ilr_diag'}
# the ILR kinds: (the experts' ones column, the diagonal basis)
ILR_FLAGS = {ILR: (True, False), ILR_LINEAR: (False, False),
             ILR_DIAG: (True, True), ILR_DIAG_LINEAR: (False, True)}

# kernel launches by `estep`, by feature map, for run accounting
launches = {'gauss': 0, 'ilr': 0, 'diag': 0, 'ilr_diag': 0}
_CHUNK = 1 << 20      # points per step of the plain versions


def feature_kind(features_t):
    """The kernels' code for a spec's transposed feature map; raises for
    a map the kernels do not assemble."""
    if features_t is gauss_features_t:
        return GAUSS
    if features_t is diag_gauss_features_t:
        return DIAG
    for kind, flags in ILR_FLAGS.items():
        if features_t == ilr_features_t(*flags):
            return kind
    raise NotImplementedError('kernels B1/B2 assemble the full-covariance '
                              'Gaussian, the diagonal Gaussian and the ILR '
                              '(NIW or NG basis x MNW or MNG experts) '
                              'feature maps only')


def feature_width(kind, d, p=0):
    """Width of a kernel feature map over d x rows and p y rows."""
    if kind == GAUSS:
        return gauss_width(d)
    if kind == DIAG:
        return diag_gauss_width(d)
    return ilr_width(d, p, *ILR_FLAGS[kind])


def y_rows(kind, xts):
    """The number of y rows the kernels read after x: p for the ILR maps,
    0 for the Gaussian ones."""
    return xts[1].shape[0] if kind in ILR_FLAGS else 0


def kernel_xts(data):
    """The kernels' layout, made once outside the sweep loop: the data
    arrays transposed and stacked into one contiguous float32
    (sum d_i, N) buffer ([x; y] for ILR), returned as its per-input
    (d_i, N) row blocks. The kernels read the buffer whole and
    bound-check the point index against N, so no padding is needed."""
    buf = torch.cat([a.to(torch.float32).T for a in data]).contiguous()
    return tuple(torch.split(buf, [a.shape[1] for a in data]))


def pad_rows(f, m8):
    """Zero-pad a (m, B) feature block to m8 rows."""
    return torch.cat([f, f.new_zeros((m8 - f.shape[0], f.shape[1]))])


def assemble_features(xt, m8, kind=GAUSS, p=0):
    """The kernels' feature map of a stacked (d + p, B) block, zero-padded
    to m8 rows."""
    if kind == GAUSS:
        return pad_rows(gauss_features_t((xt,)), m8)
    if kind == DIAG:
        return pad_rows(diag_gauss_features_t((xt,)), m8)
    d = xt.shape[0] - p
    return pad_rows(ilr_features_t(*ILR_FLAGS[kind])((xt[:d], xt[d:])), m8)


def stack_rows(xts):
    """One (sum d_i, N) array from the per-input (d_i, N) arrays: the
    kernels' layout. No copy when the inputs are consecutive row blocks
    of one buffer, as `kernel_xts` makes them."""
    if len(xts) == 1:
        return xts[0]
    base, off = xts[0], 0
    ld = base.stride(0)
    for a in xts:
        if (a.stride() != (ld, 1) or a.shape[1] != base.shape[1]
                or a.dtype != base.dtype
                or a.data_ptr() != (base.data_ptr()
                                    + off * ld * a.element_size())):
            return torch.cat(xts, 0)
        off += a.shape[0]
    return base.as_strided((off, base.shape[1]), (ld, 1))


def pad_theta(theta, log_pi, dtype):
    """Fold log_pi into the constant column and zero-pad the feature axis
    to a multiple of 8: theta (..., K, m), log_pi (..., K), the leading
    axis that of the chains where there is one. Returns (theta (..., K,
    m8) contiguous, m)."""
    m = theta.shape[-1]
    m8 = padded_width(m)
    theta = torch.cat([theta[..., :1] + log_pi[..., None], theta[..., 1:],
                       theta.new_zeros(theta.shape[:-1] + (m8 - m,))], -1)
    return theta.to(dtype).contiguous(), m


def check_theta(what, xt, n, theta, width, desc):
    """_build.check_inputs for B1 / B2's coefficients, (K, m8) or the C
    chains' (C, K, m8), which the kernels read as C K contiguous rows."""
    if theta.dim() not in (2, 3):
        raise ValueError(f'{what}: theta must be (K, m8) or (C, K, m8)')
    if theta.dim() == 3 and not 1 <= theta.shape[0] <= 65535:
        raise ValueError(f'{what}: {theta.shape[0]} chains, outside '
                         '[1, 65535]')
    _build.check_inputs(what, xt, n,
                        theta.flatten(0, -2) if theta.is_contiguous()
                        else theta, width, desc)


def estep_plain(xt, theta, n, kind=GAUSS, p=0):
    """Plain PyTorch version of B1: xt (d + p, >=n), theta (K, m8) ->
    (acc (K, m8), lse ()), in xt's dtype; theta (C, K, m8) -> the C
    chains' (acc (C, K, m8), lse (C,)), one chain at a time."""
    if theta.dim() == 3:
        accs, lses = zip(*(estep_plain(xt, th, n, kind, p) for th in theta))
        return torch.stack(accs), torch.stack(lses)
    k, m8 = theta.shape
    acc = torch.zeros((k, m8), dtype=theta.dtype, device=theta.device)
    lse = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for s in range(0, n, _CHUNK):
        f = assemble_features(xt[:, s:min(s + _CHUNK, n)], m8, kind, p)
        logp = theta @ f
        mx = torch.max(logp, 0, keepdim=True).values
        ex = torch.exp(logp - mx)
        denom = torch.clamp(torch.sum(ex, 0, keepdim=True), min=1e-37)
        acc = acc + ex @ (f / denom).T
        lse = lse + torch.sum(mx + torch.log(denom))
    return acc, lse


def estep_packed(xt, theta, n, kind=GAUSS, p=0):
    """B1 as `estep`, returning its output buffer as it is: (K m8 + 1,)
    = [acc row-major, lse], or the chains' (C, K m8 + 1): the partial of
    one shard in a mesh's reduction (family_estep.pack_estep's layout).
    CPU tensors run `estep_plain` and pack its result."""
    k, m8 = theta.shape[-2:]
    if not xt.is_cuda:
        acc, lse = estep_plain(xt, theta, n, kind, p)
        return torch.cat([acc.flatten(-2), lse[..., None]], -1)
    lib = _build.load()
    chains = theta.shape[0] if theta.dim() == 3 else 1
    d = xt.shape[0] - p
    desc = f'{KIND_NAMES[kind]} map, d={d}, p={p}'
    check_theta('cuda_estep', xt, n, theta, feature_width(kind, d, p), desc)
    work = _build.tc_scratch('cuda_estep', lib, lib.mimo_estep_scratch, xt,
                             n, theta, desc, chains)
    out = torch.empty((chains, k * m8 + 1), dtype=torch.float32,
                      device=xt.device)
    with torch.cuda.device(xt.device):
        rc = lib.mimo_estep(xt.data_ptr(), xt.stride(0), d, p, kind, n,
                            theta.data_ptr(), k, m8, work.data_ptr(),
                            out.data_ptr(), chains,
                            torch.cuda.current_stream().cuda_stream)
    lib.check(rc, 'cuda_estep')
    launches[KIND_NAMES[kind]] += 1
    return out if theta.dim() == 3 else out[0]


def estep(xt, theta, n, kind=GAUSS, p=0):
    """B1 over points 0..n-1 of xt (d + p, >=n), x rows then p y rows;
    theta (K, m8) with c + log pi in column 0, or the C chains' (C, K, m8).
    Launches the kernel for CUDA tensors (float32 only; it raises on
    anything it does not take) and runs `estep_plain` for CPU tensors.
    Returns (acc (K, m8), lse ()), or (acc (C, K, m8), lse (C,))."""
    if not xt.is_cuda:
        return estep_plain(xt, theta, n, kind, p)
    out = estep_packed(xt, theta, n, kind, p)
    return out[..., :-1].unflatten(-1, tuple(theta.shape[-2:])), out[..., -1]


def fused_estep_cuda(spec, post, log_pi, xts, n):
    """Spec-driven fused E-step through B1, the counterpart of
    mimo_tpu's fused_estep_pallas. xts: the per-input (d_i, >=n)
    transposed data (see `kernel_xts`); n: the number of
    points, at run time (a fixed buffer may hold more columns). With a
    chain spec (family_estep.chain_spec) over C-stacked posteriors and
    log_pi (C, K), one launch serves every chain. The one-shard case of
    `fused_estep_cuda_sharded`."""
    return fused_estep_cuda_sharded(spec, post, log_pi, [xts],
                                    local_mesh(xts[0].device), [n])


@spanned('wrappers', 'b1')
def fused_estep_cuda_sharded(spec, post, log_pi, shards, mesh, ns=None):
    """The fused E-step over a one-row mesh through B1, the counterpart
    of mimo_tpu's fused_estep_pallas_sharded: `shards` the kernel layouts
    (per-input (d_i, n_j) row blocks, `kernel_xts`) of the
    mesh's positions, in order, each on its position's device; `ns` their
    point counts (by default their widths). B1 runs once per non-empty
    shard (`estep_shards`), then one reduction of the packed partials
    (the buffers B1 writes, float32 on the card). With a chain spec
    (`chain_spec`) each launch serves every chain, so chains and the mesh
    compose. Returns the FusedEStep in the layout's dtype."""
    kind = feature_kind(spec.features_t)
    dtype = shards[0][0].dtype
    with span('algebra', 'theta'):
        theta, m = pad_theta(spec.theta(post), log_pi, dtype)
    ns = [xts[0].shape[1] for xts in shards] if ns is None else ns
    parts = [p for p in estep_shards(theta, kind, shards, ns) if p is not None]
    return reduce_estep(spec, parts, theta.shape[:-2], theta.shape[-2], m,
                        dtype, mesh)


def estep_shards(theta, kind, shards, ns):
    """B1 once per non-empty shard, on that shard's device and current
    stream, with the shard's point count at run time and the padded theta
    (`pad_theta`) replicated there: one packed (..., K m8 + 1) partial a
    shard, None for an empty one (it launches nothing). The launches
    without the reduction: `fused_estep_cuda_sharded` reduces them at
    once; the streamed engines add each shard's partials across the
    blocks of a sweep and reduce once a sweep."""
    parts = []
    for xts, n in zip(shards, ns):
        if not n:
            parts.append(None)
            continue
        xt = stack_rows(xts)
        parts.append(estep_packed(xt, theta.to(xt.device), n, kind,
                                  y_rows(kind, xts)))
    return parts


class BlockEStep:
    """The one accumulator of a sweep's per-shard E-step partials over the
    positions of a one-row mesh, with theta formed once (`begin`): B1's
    launch protocol (theta padded to m8 with log pi in column 0, the
    feature-map code, the kernels' layout, one packed K m8 + 1 partial a
    shard) or the blockwise twin, as `use_kernel` (the engine's resolved
    backend) says. Each `add` takes one (data, kernel views, rows) a
    position (a block's or a minibatch's shards): B1 once per non-empty
    shard on its views with its row count at run time (`estep_shards`),
    or the blockwise twin on its data (family_estep.accumulate_shards);
    each position's partial adds across the calls on its device, in the
    engine's dtype. With `own`, each shard's data carry a leading chain
    axis (C, b_j, ...) and chain c's theta runs over chain c's rows only
    (SVI's minibatches of C chains), one launch a chain and shard on its
    kernel layout made here. `end` makes the mesh's one reduction and
    unpacks it."""

    def __init__(self, spec, use_kernel, block_size, dtype, mesh, own=False):
        self.spec, self.use_kernel, self.own = spec, use_kernel, own
        self.block_size, self.dtype, self.mesh = block_size, dtype, mesh

    def begin(self, theta_src, log_pi):
        theta = self.spec.theta(theta_src)
        self.lead, (self.k, self.m) = theta.shape[:-2], theta.shape[-2:]
        if self.use_kernel:
            self.kind = feature_kind(self.spec.features_t)
            theta, _ = pad_theta(theta, log_pi, torch.float32)
        self.theta, self.log_pi = theta, log_pi
        self.parts = [None] * len(self.mesh.devices)

    def add(self, shards):
        live = [j for j, s in enumerate(shards) if s[2]]
        carry = [self.parts[j] for j in live]
        if not self.own:
            sums = self._sums(self.theta, self.log_pi,
                              [shards[j] for j in live], carry)
        else:
            per = [self._sums(self.theta[c], self.log_pi[c],
                              [self._chain(shards[j], c) for j in live],
                              [None if p is None else tree_map(
                                  lambda a: a[c], p) for p in carry])
                   for c in range(self.lead[0])]
            sums = [torch.stack(ps) if self.use_kernel
                    else tuple(map(torch.stack, zip(*ps)))
                    for ps in zip(*per)]
        for j, s in zip(live, sums):
            self.parts[j] = s

    def end(self):
        parts = [p for p in self.parts if p is not None]
        if not self.use_kernel:
            m8 = padded_width(self.m)
            parts = [pack_estep(acc, lse, m8) for acc, lse in parts]
        return reduce_estep(self.spec, parts, self.lead, self.k, self.m,
                            self.dtype, self.mesh)

    def _sums(self, theta, log_pi, shards, carry):
        """Each non-empty shard's partial over theta added to its carry
        (zeros where None)."""
        if self.use_kernel:
            outs = estep_shards(theta, self.kind, [s[1] for s in shards],
                                [s[2] for s in shards])
            return [o.to(self.dtype) if c is None else c + o.to(self.dtype)
                    for o, c in zip(outs, carry)]
        return accumulate_shards(self.spec.features, theta, log_pi,
                                 [s[0] for s in shards], self.block_size,
                                 carry)

    def _chain(self, shard, c):
        """Chain c's rows of an `own` shard, as `add` takes a shard."""
        data, _, n = shard
        data = tuple(a[c] for a in data)
        return data, kernel_xts(data) if self.use_kernel else None, n
