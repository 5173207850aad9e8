"""Run the sharded engines in several processes joined by one process
group (the counterpart of scripts/multihost_cpu.py).

`launch(fn, nprocs, args)` spawns `nprocs` worker processes; each calls
`mesh.init_distributed` on a free local port, runs `fn(*args)` and sends
its result back as numpy (bridge.state_to_numpy). Every wait has a
deadline; a worker that fails makes `launch` raise with its traceback,
and a worker still alive at the end is killed.

`run_engines(cfg)` is the worker the tests and chip_smoke.py drive: it
forms the global mesh from this process's devices, shards the global data
(each process places its own shards), runs the named engines on it and
returns their results and the mesh counters of each run. The stream
engines read their process's own file shard, written and read back
through io.write_bin and io.MmapDataset. Called in one process without a
group, it is the reference the processes are held to.
"""

import multiprocessing
import os
import queue
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mimo_tpu_torch.ops.family_estep import padded_width
from mimo_tpu_torch.parallel import mesh as _mesh


def free_port():
    """A free local TCP port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('', 0))
        return s.getsockname()[1]


def _worker(rank, world, port, backend, timeout, fn, args, results):
    from mimo_tpu_torch.bridge import state_to_numpy
    try:
        _mesh.init_distributed(f'localhost:{port}', world, rank, backend,
                               timeout)
        try:
            out = state_to_numpy(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:            # reported to the parent, then exits
        results.put((rank, False, traceback.format_exc()))


def launch(fn, nprocs, args=(), backend='gloo', timeout=120.0):
    """fn(*args) in `nprocs` spawned processes forming one process group
    of `backend` on localhost; returns their results in rank order. fn
    must be importable by name (a module-level function). Raises
    RuntimeError with a failed worker's traceback, TimeoutError when the
    workers have not all answered within `timeout` seconds."""
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(rank, nprocs, port, backend, timeout, fn,
                               args, results))
             for rank in range(nprocs)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f'{nprocs - len(out)} of {nprocs} workers did not '
                    f'answer within {timeout} s') from None
            if not ok:
                raise RuntimeError(f'worker {rank} failed:\n{payload}')
            out[rank] = payload
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=max(1.0, min(10.0,
                                            deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(nprocs)]


def run_engines(cfg):
    """Run engines over the mesh that cfg describes, in this process's
    part of it; the worker of `launch`, or with no process group the
    one-process reference. cfg keys:

      x          the global data, a numpy (N, d) array (every process
                 holds it and places only its own shards);
      dtype      'float64' or 'float32';
      devices    this process's devices, e.g. ['cpu', 'cpu'];
      n_chain    the mesh's chain rows (default 1);
      model      BayesianGMM.make's keyword arguments;
      runs       a list of (name, engine, kwargs): engine one of
                 parallel.mesh.MESH_ENGINES over the mesh,
                 'fit_chains:<engine>' with the chain keys in
                 kwargs['keys'], or a stream engine of STREAM_ENGINES
                 over this process's file shard (`stream_run`: kwargs
                 'rows', a position's rows of a minibatch, for
                 fit_svi_stream, and 'n_blocks' for the others);
                 kwargs['n'], where given, runs it on the first n points;
      threads    torch's intra-op threads (optional);
      probe      optional, with a process group up: after the runs, time
                 this many lone all_reduce calls of a (K m8 + 1) buffer
                 of the data's dtype, each after a barrier, so that a
                 call's time is the transfer alone, without the wait for
                 the slower rank or for this rank's own kernels that an
                 all_reduce inside a sweep includes.

    Returns {name: {'out': the engine's result, 'counters': the mesh
    counters of its run}} plus 'rank', 'world', 'positions' and, with
    `probe`, 'probe_seconds' (one host-clock time a call)."""
    from mimo_tpu_torch.models import BayesianGMM
    from mimo_tpu_torch.parallel.chains import fit_chains
    if cfg.get('threads'):
        torch.set_num_threads(cfg['threads'])
    dtype = getattr(torch, cfg['dtype'])
    devices = [torch.device(d) for d in cfg['devices']]
    mesh = _mesh.make_mesh(n_chain=cfg.get('n_chain', 1), devices=devices)
    model = BayesianGMM.make(**cfg['model'], dtype=dtype,
                             device=devices[0])
    x = torch.from_numpy(np.asarray(cfg['x'])).to(dtype)
    xs = _mesh.shard_data(mesh, x)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    out = {'rank': rank, 'world': world, 'positions': mesh.positions}
    for name, engine, kw in cfg['runs']:
        kw = dict(kw)
        data = (xs if kw.get('n') is None
                else _mesh.shard_data(mesh, x[:kw.pop('n')]))
        kw.pop('n', None)
        _mesh.reset_counters()
        if engine in STREAM_ENGINES:
            res = stream_run(model, engine, mesh, np.asarray(cfg['x']),
                             cfg['dtype'], kw)
        elif engine.startswith('fit_chains:'):
            res = fit_chains(model, engine.split(':', 1)[1], data,
                             kw.pop('keys'), mesh=mesh, **kw)
        else:
            res = getattr(model, engine)(data, mesh=mesh, **kw)
        if devices[0].type == 'cuda':
            torch.cuda.synchronize(devices[0])
        out[name] = {'out': res, 'counters': {
            k: dict(v) for k, v in _mesh.counters.items()}}
    if cfg.get('probe') and dist.is_initialized():
        k, m = model._estep_spec().theta(model.components_prior).shape
        buf = torch.zeros((k * padded_width(m) + 1,), dtype=dtype,
                          device=devices[0])
        out['probe_seconds'] = [_lone_all_reduce(buf)
                                for _ in range(cfg['probe'])]
    return out


# the engines run_engines drives over a file shard a process
STREAM_ENGINES = ('fit_svi_stream', 'fit_vi_stream_full',
                  'fit_map_stream_full', 'fit_em_stream_full')


def stream_run(model, engine, mesh, x, dtype, kw):
    """A stream engine over `mesh` (one row), each process streaming its
    own file shard, as scripts/multihost_cpu.py lays it out: mesh position
    p holds rows p s .. (p + 1) s - 1 of the global data x (s = N // D
    for D positions), this process writes its positions' rows as float32
    to a file of its own (io.write_bin) and reads them back through
    io.MmapDataset, and its rows of global minibatch or block i are the
    i-th run of each of its positions' rows, in position order. For
    fit_svi_stream, kw['rows'] are a position's rows of a minibatch
    (batch i takes run i mod (s // rows); batch_size is rows D); for the
    full-data engines the s rows split into kw['n_blocks'] blocks. The
    file is deleted on the way out."""
    from mimo_tpu_torch.io import MmapDataset, write_bin
    kw = dict(kw)
    d, local = mesh.shape['data'], len(mesh.positions)
    s = x.shape[0] // d
    first = mesh.positions[0] % d
    fd, path = tempfile.mkstemp(prefix='mimo_stream_shard_', suffix='.bin')
    os.close(fd)
    try:
        write_bin(path, np.ascontiguousarray(
            x[first * s:(first + local) * s], dtype=np.float32))
        ds = MmapDataset(path)
        try:
            def runs(i, b):
                return np.concatenate([ds.read_block(k * s + i * b, b)
                                       for k in range(local)]).astype(dtype)

            if engine == 'fit_svi_stream':
                b = kw.pop('rows')
                return model.fit_svi_stream(
                    lambda i: runs(i % (s // b), b), total_size=x.shape[0],
                    batch_size=b * d, mesh=mesh, **kw)
            n_blocks = kw.pop('n_blocks')
            return getattr(model, engine)(
                lambda i: runs(i, s // n_blocks), n_blocks, mesh=mesh, **kw)
        finally:
            ds.close()
    finally:
        os.unlink(path)


def _lone_all_reduce(buf):
    """Host seconds of one all_reduce of `buf` begun right after a
    barrier, with the device idle."""
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    dist.barrier()
    t0 = time.perf_counter()
    dist.all_reduce(buf)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    return time.perf_counter() - t0
