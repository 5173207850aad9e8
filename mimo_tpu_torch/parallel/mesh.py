"""Device mesh and data sharding: data-parallel and chain-parallel fits
(port of mimo_tpu/parallel/mesh.py).

A mesh is a ('chain', 'data') grid of mesh positions, each a
torch.device; a device may repeat (four positions on one card, or eight
on the CPU, as the JAX tests' eight virtual CPU devices). Points are
split over 'data' into contiguous shards, one per position; chains are
split over 'chain'.

The scaling contract of the JAX package holds as it did under shard_map:
the fused and streamed engines (models.mixture, models.hmix) launch their
kernel once per non-empty shard, each on its shard's device (the streamed
ones once a shard of every block), and every sweep makes ONE reduction of
the packed (K m8 + 1) buffer of statistics and lse (`Mesh.reduce`; the
dense engines one of their statistics, counts and data term): the
partials are summed in shard order, and when a process group is up one
`torch.distributed.all_reduce` of that buffer follows. Nothing N-sized
crosses the mesh: each shard draws only its own rows of a random start
(keyed by the global point index), a Gibbs fit's labels stay on their
shards (`Sharded`), and serving makes no reduction at all. An engine called without a mesh runs the same code over the
one-position `local_mesh` of its data's device.

Across processes (`init_distributed`), mesh positions are global: rank r
owns the contiguous run r L .. r L + L - 1 of them (L devices each), and
`shard_data` on rank r places only that rank's shards.
"""

import datetime
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from mimo_tpu_torch.utils.tree import on_device, tree_leaves, tree_map

# `Mesh.reduce` calls by kind ('sweep': one a sweep or SVI step; 'start':
# the random or anchor starts), and among them the dist.all_reduce calls,
# the floats reduced, the bytes all-reduced and the host seconds spent in
# all_reduce; serving adds nothing. For run accounting, like the kernel
# wrappers' `launches`.
counters = {kind: {'calls': 0, 'all_reduce': 0, 'floats': 0, 'bytes': 0,
                   'seconds': 0.0} for kind in ('sweep', 'start')}


def reset_counters():
    for c in counters.values():
        c.update(calls=0, all_reduce=0, floats=0, bytes=0, seconds=0.0)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, timeout=120.0):
    """Multi-process bring-up: one call per process before its mesh is
    made. Wraps torch.distributed.init_process_group on
    tcp://`coordinator_address` ('host:port'; None reads the env://
    variables), with `num_processes` ranks of which this is `process_id`.
    `backend`: NCCL where a card is visible, gloo on the CPU, or what is
    named (gloo all-reduces CUDA tensors through the host: the way to run
    several ranks on one card, which NCCL refuses). Every collective
    waits at most `timeout` seconds. Does nothing when a group is already
    up. Returns (rank, world size)."""
    if not dist.is_initialized():
        if backend is None:
            backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        kw = {}
        if num_processes is not None:
            kw['world_size'] = num_processes
        if process_id is not None:
            kw['rank'] = process_id
        addr = coordinator_address
        method = ('env://' if addr is None
                  else addr if addr.startswith('tcp://') else f'tcp://{addr}')
        dist.init_process_group(
            backend, init_method=method,
            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dist.get_rank(), dist.get_world_size()


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ('chain', 'data') mesh. `shape` {'chain': c, 'data': d};
    `devices` the devices of this process's positions and `positions`
    their global indices (position p is chain row p // d, data shard
    p % d); `groups` maps each chain row to the process group of its
    reduction, or None where the row lies in this process."""

    def __init__(self, shape, devices, positions, groups):
        self.shape = dict(shape)
        self.devices = tuple(devices)
        self.positions = tuple(positions)
        self.groups = dict(groups)

    def rows(self):
        """The chain rows this process holds positions of, in order."""
        d = self.shape['data']
        return sorted({p // d for p in self.positions})

    def row(self, g):
        """The one-row mesh of chain row g: its positions in this
        process and the process group of its reduction."""
        d = self.shape['data']
        keep = [(p, dev) for p, dev in zip(self.positions, self.devices)
                if p // d == g]
        if not keep:
            raise ValueError(f'chain row {g} has no position in this process')
        return Mesh({'chain': 1, 'data': d}, [dev for _, dev in keep],
                    [p for p, _ in keep], {g: self.groups[g]})

    def one_row(self):
        """This mesh, which must have one chain row (the fused engines
        and serving run over one row; fit_chains drives the rows)."""
        if self.shape['chain'] != 1:
            raise ValueError(
                f"a mesh with {self.shape['chain']} chain rows runs through "
                'parallel.fit_chains; an engine takes one row (Mesh.row)')
        return self

    def shard_index(self, p):
        """The data shard of global position p."""
        return p % self.shape['data']

    def reduce(self, parts, zero, kind='sweep'):
        """THE one reduction of a sweep: `zero` (a fresh zero buffer on
        the first position's device, (..., W)) plus the per-shard partial
        buffers `parts`, summed in shard order on that device, then, when
        the row spans processes, one all_reduce of the sum over the row's
        process group. An empty shard passes no partial: it adds zero.
        Counts the call in `counters[kind]`."""
        (g,) = self.one_row().rows()
        out = zero
        for part in parts:
            out = out + part.to(out.device)
        c = counters[kind]
        c['calls'] += 1
        c['floats'] += out.numel()
        group = self.groups[g]
        if group is not None:
            out = out.contiguous()
            t0 = time.perf_counter()
            dist.all_reduce(out, group=group)
            c['seconds'] += time.perf_counter() - t0
            c['all_reduce'] += 1
            c['bytes'] += out.numel() * out.element_size()
        return out

    def reduce_tree(self, trees, like, kind='start'):
        """`reduce` of a tree of tensors (a start's statistics and
        counts): each shard's tree packed into one flat buffer. `like` is
        a tree of the same structure giving shapes, dtype and device when
        this process holds no non-empty shard. One tree and no collective
        (an unsharded fit) is its own sum: it is counted and returned
        without the packing."""
        (g,) = self.one_row().rows()
        if len(trees) == 1 and self.groups[g] is None:
            c = counters[kind]
            c['calls'] += 1
            c['floats'] += sum(t.numel() for t in tree_leaves(trees[0]))
            return on_device(trees[0], self.devices[0])
        leaves = tree_leaves(like)
        sizes = [t.numel() for t in leaves]
        zero = torch.zeros((sum(sizes),), dtype=leaves[0].dtype,
                           device=self.devices[0])
        parts = [torch.cat([t.reshape(-1).to(zero.dtype)
                            for t in tree_leaves(tree)]) for tree in trees]
        flat = torch.split(self.reduce(parts, zero, kind), sizes)
        it = iter(t.view(s.shape) for t, s in zip(flat, leaves))
        return tree_map(lambda _: next(it), like)


def _row_groups(n_chain, n_data, local, world):
    """Each chain row's reduction group: None without a process group or
    where the row lies in one of several processes, the world group when
    it spans every process (a world of one included: its all_reduce is
    the identity), else a new group of its processes (made by every
    process, in row order, as torch.distributed requires)."""
    up = dist.is_available() and dist.is_initialized()
    groups = {}
    for g in range(n_chain):
        ranks = sorted({p // local for p in range(g * n_data,
                                                  (g + 1) * n_data)})
        if not up or (len(ranks) == 1 and world > 1):
            groups[g] = None
        elif len(ranks) == world:
            groups[g] = dist.group.WORLD
        else:
            groups[g] = dist.new_group(ranks)
    return groups


def local_mesh(device):
    """The one-position mesh of `device` in this process, with no
    collective whether or not a process group is up: the mesh of an
    engine called without `mesh=`, so that the unsharded fit is the
    one-shard case of the sharded one."""
    return Mesh({'chain': 1, 'data': 1}, [torch.device(device)], [0],
                {0: None})


def make_mesh(n_data=None, n_chain=1, devices=None):
    """Create a ('chain', 'data') mesh over `devices` (a device may
    repeat), by default every visible CUDA device; without a card that
    raises: pass e.g. [torch.device('cpu')] * 8 for a CPU mesh. Defaults
    to all positions on 'data'. With a process group up, `devices` are
    this process's and the mesh spans every process's positions (each
    process gives as many devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: make_mesh takes every visible card by '
                "default; pass devices=[torch.device('cpu')] * n for a "
                'CPU mesh')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len({d.type for d in devices}) != 1:
        raise ValueError('a mesh holds devices of one type, got '
                         f'{sorted({d.type for d in devices})}')
    rank, world = _world()
    local = len(devices)
    total = local * world
    n_data = total // n_chain if n_data is None else n_data
    size = n_chain * n_data
    if size < 1:
        raise ValueError(f'mesh ({n_chain}, {n_data}) has no position')
    if world == 1:
        if size > local:
            raise ValueError(f'mesh ({n_chain}, {n_data}) needs {size} '
                             f'positions, {local} devices given')
        devices, positions = devices[:size], range(size)
    else:
        if size != total:
            raise ValueError(
                f'across {world} processes the mesh spans every '
                f'position: ({n_chain}, {n_data}) != {total}')
        positions = range(rank * local, (rank + 1) * local)
    return Mesh({'chain': n_chain, 'data': n_data}, devices, positions,
                _row_groups(n_chain, n_data, local, world))


class Sharded(NamedTuple):
    """An array split over a mesh's 'data' axis: `shards` one tensor per
    position of this process (rows lo..hi of the global array, on the
    position's device), `positions` their global mesh positions, `n` the
    global length of axis 0. Gibbs fits return their labels so."""
    shards: tuple
    positions: tuple
    n: int

    def on(self, mesh):
        """The shards at `mesh`'s positions (e.g. one chain row's)."""
        at = dict(zip(self.positions, self.shards))
        missing = [p for p in mesh.positions if p not in at]
        if missing:
            raise ValueError(f'no shard at mesh positions {missing}')
        return Sharded(tuple(at[p] for p in mesh.positions),
                       tuple(mesh.positions), self.n)

    def map(self, fn):
        """fn over every shard."""
        return Sharded(tuple(fn(s) for s in self.shards), self.positions,
                       self.n)

    def gather(self, axis=0):
        """The shards concatenated along their points' `axis` (-1 for
        the chains' (C, n_j) labels) on the first one's device: the whole
        array when this process holds one chain row of the mesh."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], axis)


def shard_bounds(n, n_data, j):
    """Rows [lo, hi) of data shard j: ceil(n / n_data) rows a shard, the
    last shards shorter or empty."""
    s = -(-n // n_data)
    lo = min(j * s, n)
    return lo, min(lo + s, n)


def _shard(mesh, a):
    if isinstance(a, Sharded):
        return a.on(mesh)
    a = torch.as_tensor(a)
    n, d = a.shape[0], mesh.shape['data']
    shards = []
    for p, dev in zip(mesh.positions, mesh.devices):
        lo, hi = shard_bounds(n, d, p % d)
        shards.append(a[lo:hi].to(dev))
    return Sharded(tuple(shards), tuple(mesh.positions), n)


def shard_data(mesh, *arrays):
    """Split arrays with leading axis N over the mesh's 'data' axis into
    contiguous shards (`shard_bounds`), each placed on its position's
    device (a view where it already lies there); every chain row gets the
    data. Returns one Sharded per array."""
    out = tuple(_shard(mesh, a) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh, tree):
    """A tree of tensors on every position of this process: one copy a
    device (the tree itself where it already lies there), in position
    order."""
    return tuple(on_device(tree, dev) for dev in mesh.devices)


# engines that take mesh= (models.mixture, models.hmix): the fused ones,
# SVI and the dense ones (the stream engines take their own rows' reader)
MESH_ENGINES = ('fit_vi_fused', 'fit_gibbs_fused', 'fit_map_fused',
                'fit_em_fused', 'fit_svi', 'fit_vi', 'fit_gibbs', 'fit_map',
                'fit_em')


def data_parallel_fit(model, fit_name, data, mesh=None, **kw):
    """Run `model.<fit_name>` with data sharded over the mesh's 'data'
    axis (by default a mesh over every visible card). Raises on N not a
    multiple of the data-mesh size, as the JAX package does (pad first:
    `pad_to_multiple`); the engines themselves take any N."""
    mesh = make_mesh() if mesh is None else mesh
    data = data if isinstance(data, tuple) else (data,)
    n = data[0].shape[0]
    n_shards = mesh.shape['data']
    if n % n_shards != 0:
        raise ValueError(
            f'N={n} not divisible by data-mesh size {n_shards}; pad first')
    if fit_name not in MESH_ENGINES:
        raise NotImplementedError(
            f'{fit_name} has no mesh path in this port; one of '
            f'{list(MESH_ENGINES)} does')
    data = tuple(shard_data(mesh, a) for a in data)
    return getattr(model, fit_name)(data if len(data) > 1 else data[0],
                                    mesh=mesh, **kw)


def pad_to_multiple(x, multiple, axis=0):
    """Pad with zeros so shape[axis] is a multiple; returns (padded,
    n_valid). Pair it with zero point weights where an engine takes them:
    a padded point of weight 0 is an exact no-op."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], axis), n

