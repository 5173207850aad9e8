"""The port's mesh across processes on the CPU (the counterpart of
tests/test_multihost.py and scripts/multihost_cpu.py): two spawned
processes, joined by a gloo process group on a free local port
(parallel.launch), each holding two CPU positions of one global (1, 4)
mesh, run the sharded engines on their own shards and must equal one
process holding all four positions, in float64, to rtol 1e-12 (only the
order of the fold differs: 2 + 2 shards summed locally, then one
all_reduce); each rank makes exactly one all_reduce a sweep, of
K m8 + 1 floats whatever N. A (2, 2) chain mesh puts one chain row in
each process. Each process also streams its own file shard through
fit_svi_stream(mesh=) and fit_vi_stream_full(mesh=) (tests/
test_multihost.py's stream legs) and runs the dense engines on its
shards; each equals one process to rtol 1e-9. Every launch has its own
wall limit; the workers destroy their process group on the way out."""

import numpy as np
import pytest
import torch

from mimo_tpu_torch.bridge import state_to_numpy as to_numpy
from mimo_tpu_torch.parallel.launch import launch, run_engines

torch.set_num_threads(1)

K, M8 = 5, 8             # d = 2: m = 7
MODEL = dict(size=K, dim=2, gating='dp', alpha=1.0, kappa=0.05,
             psi_scale=0.5)
WALL = 100.0             # seconds a launch may take


def blobs(n, seed=0):
    rng = np.random.default_rng(seed)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return c[rng.integers(0, 3, n)] + 0.7 * rng.standard_normal((n, 2))


RUNS = [('vi', 'fit_vi_fused', dict(key=1, maxiter=6, block_size=256)),
        ('gibbs1', 'fit_gibbs_fused', dict(key=2, maxiter=1)),
        ('gibbs', 'fit_gibbs_fused', dict(key=2, maxiter=4)),
        ('svi', 'fit_svi', dict(key=4, maxiter=20, step_size=0.5,
                                batch_size=256)),
        ('map', 'fit_map_fused', dict(key=1, maxiter=6))]


def leaves(tree):
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, str):
        return [leaf for t in tree for leaf in leaves(t)]
    return []


def close(got, want, rtol=1e-12):
    for a, b in zip(leaves(got), leaves(want), strict=True):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


@pytest.mark.parametrize('n', [2001, 4000])
def test_two_processes_equal_one_process(n):
    cfg = dict(x=blobs(n), dtype='float64', devices=['cpu'] * 2,
               model=MODEL, runs=RUNS, threads=1, probe=3)
    ranks = launch(run_engines, 2, (cfg,), backend='gloo', timeout=WALL)
    ref = to_numpy(run_engines(dict(cfg, devices=['cpu'] * 4)))
    assert [r['positions'] for r in ranks] == [(0, 1), (2, 3)]
    assert 'probe_seconds' not in ref
    for r in ranks:
        assert r['world'] == 2
        assert len(r['probe_seconds']) == 3
        assert all(t > 0 for t in r['probe_seconds'])
        for name, _, kw in RUNS:
            got, want = r[name]['out'], ref[name]['out']
            sweep = r[name]['counters']['sweep']
            assert sweep['calls'] == sweep['all_reduce'] == kw['maxiter']
            assert sweep['floats'] == kw['maxiter'] * (K * M8 + 1)
            assert sweep['bytes'] == sweep['floats'] * 8
            assert ref[name]['counters']['sweep']['all_reduce'] == 0
            if name.startswith('gibbs'):
                # the labels of this rank's shards: those positions' of the
                # one-process run, draw for draw
                mine = dict(zip(got.labels.positions, got.labels.shards))
                for p, lab in zip(want.labels.positions, want.labels.shards):
                    if p in mine:
                        np.testing.assert_array_equal(mine[p], lab)
                got, want = got[:3], want[:3]
            close(got, want)


STREAM_RUNS = [
    ('svi-stream', 'fit_svi_stream', dict(key=5, maxiter=24, step_size=0.3,
                                          rows=16, group=8), 24),
    ('vi-stream', 'fit_vi_stream_full', dict(key=8, maxiter=4, n_blocks=4),
     4),
    ('map-stream', 'fit_map_stream_full', dict(key=8, maxiter=3,
                                               n_blocks=3), 3),
    ('vi-dense', 'fit_vi', dict(key=1, maxiter=6), 6),
    ('map-dense', 'fit_map', dict(key=1, maxiter=4), 4),
    ('em-dense', 'fit_em', dict(key=1, maxiter=4), 4),
    ('gibbs-dense', 'fit_gibbs', dict(key=2, maxiter=4, track_loglik=True),
     4)]


def test_two_processes_stream_their_own_file_shards():
    """Each process writes its positions' rows of the data to a file of
    its own and streams it (parallel.launch.stream_run): SVI from the
    random start over batch 0, the streamed VI and MAP-EM from a key, and
    the dense VI, MAP-EM, ML-EM and Gibbs over the same mesh, each equal
    to one process holding all four positions (rtol 1e-9; the dense Gibbs
    labels of each shard draw for draw, rank 1 keeping the fit's
    generator in step with rank 0, which draws shard 0's labels from
    it); one all_reduce a sweep or step on each rank."""
    runs = [r[:3] for r in STREAM_RUNS]
    cfg = dict(x=blobs(2048, 2), dtype='float64', devices=['cpu'] * 2,
               model=MODEL, runs=runs, threads=1)
    ranks = launch(run_engines, 2, (cfg,), backend='gloo', timeout=WALL)
    ref = to_numpy(run_engines(dict(cfg, devices=['cpu'] * 4)))
    for r in ranks:
        for name, _, _, sweeps in STREAM_RUNS:
            got, want = r[name]['out'], ref[name]['out']
            sweep = r[name]['counters']['sweep']
            assert sweep['calls'] == sweep['all_reduce'] == sweeps, name
            if name == 'gibbs-dense':
                state, trace = got
                mine = dict(zip(state.labels.positions, state.labels.shards))
                for p, lab in zip(want[0].labels.positions,
                                  want[0].labels.shards):
                    if p in mine:
                        np.testing.assert_array_equal(mine[p], lab)
                got, want = (state[:4], trace), (want[0][:4], want[1])
            close(got, want, rtol=1e-9)


def test_two_processes_chain_mesh():
    """A (2, 2) mesh over two processes: each process owns one chain row,
    runs its group of two keys over its two data positions with no
    collective, and the groups stacked equal the one-process run."""
    keys = [9, 10, 11, 12]
    runs = [('chains', 'fit_chains:fit_vi_fused',
             dict(keys=keys, maxiter=5))]
    cfg = dict(x=blobs(1500, 1), dtype='float64', devices=['cpu'] * 2,
               n_chain=2, model=MODEL, runs=runs, threads=1)
    ranks = launch(run_engines, 2, (cfg,), backend='gloo', timeout=WALL)
    ref = to_numpy(run_engines(dict(cfg, devices=['cpu'] * 4)))
    want_state, want_trace = ref['chains']['out']
    for rank, r in enumerate(ranks):
        state, trace = r['chains']['out']
        assert trace.shape == (2, 5)
        np.testing.assert_allclose(trace, want_trace[2 * rank:2 * rank + 2],
                                   rtol=1e-12)
        close(state, [leaf[2 * rank:2 * rank + 2]
                      for leaf in leaves(want_state)])
        assert r['chains']['counters']['sweep']['all_reduce'] == 0
        assert r['chains']['counters']['sweep']['calls'] == 5


def test_a_world_of_one_all_reduces_each_sweep():
    """With a process group up, a row that spans every process (here the
    one) reduces through it: one all_reduce a sweep, the identity, so
    the fit equals the one without a group."""
    runs = [('vi', 'fit_vi_fused', dict(key=1, maxiter=3))]
    cfg = dict(x=blobs(600), dtype='float64', devices=['cpu'] * 3,
               model=MODEL, runs=runs, threads=1)
    (r,) = launch(run_engines, 1, (cfg,), backend='gloo', timeout=WALL)
    ref = to_numpy(run_engines(cfg))
    assert r['world'] == 1
    assert r['vi']['counters']['sweep']['all_reduce'] == 3
    assert ref['vi']['counters']['sweep']['all_reduce'] == 0
    close(r['vi']['out'], ref['vi']['out'], rtol=0.0)


def svi_error(cfg):
    """run_engines in a worker, returning the ValueError it raises (or
    None), so that every rank's answer comes back."""
    try:
        run_engines(cfg)
    except ValueError as e:
        return str(e)
    return None


def test_svi_refuses_an_empty_shard_on_every_rank():
    """N = 3 on a (1, 4) mesh over two processes leaves the last shard,
    rank 1's, empty: both ranks raise at once, before any collective
    (rank 0 would otherwise wait in its all_reduce for rank 1)."""
    runs = [('svi', 'fit_svi', dict(key=4, maxiter=2, batch_size=4))]
    cfg = dict(x=blobs(3), dtype='float64', devices=['cpu'] * 2,
               model=MODEL, runs=runs, threads=1)
    errors = launch(svi_error, 2, (cfg,), backend='gloo', timeout=60.0)
    assert all(e is not None and 'empty' in e for e in errors), errors


def test_launch_reports_a_failed_worker():
    cfg = dict(x=blobs(100), dtype='float64', devices=['cpu'],
               model=MODEL, runs=[('bad', 'fit_no_such_engine', {})],
               threads=1)
    with pytest.raises(RuntimeError, match='fit_no_such_engine'):
        launch(run_engines, 2, (cfg,), backend='gloo', timeout=WALL)
