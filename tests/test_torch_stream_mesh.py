"""The port's out-of-core engines over a device mesh (fit_vi_stream_full,
fit_map_stream_full, fit_em_stream_full and fit_svi_stream with mesh=) on
the CPU in float64, over mesh positions on the CPU, where each shard of
a block goes through the blockwise twin of kernel B1:

  * against mimo_tpu's stream engines over its 8-device CPU mesh
    (tests/conftest.py) from a shared state, and fit_svi_stream from
    JAX's random start handed to the port, on the same global blocks and
    batches (every one a multiple of the mesh size, as JAX asserts),
    GMM and ILR;
  * the streamed random start, keyed by the global point index, over 4
    and 8 positions against one position;
  * the ML-EM anchor start refused over a mesh, as JAX refuses it;
  * ragged blocks and empty shards (N = 5 over 8 positions) against the
    port's own unsharded stream, and bf16 on the wire;
  * the communication contract: one reduction of K m8 + 1 floats a
    streamed sweep whatever the number of blocks, one a SVI step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.parallel import mesh as jmesh

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.parallel import make_mesh
from mimo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

N, B = 12000, 4000          # 3 blocks of 500 points a position over 8
GMM = dict(size=6, gating='dp', kappa=0.05, psi_scale=0.5)
K, M8 = 6, 8                # d = 2: m = 7


@pytest.fixture(scope='module')
def x():
    rng = np.random.default_rng(0)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return c[rng.integers(0, 3, N)] + rng.standard_normal((N, 2))


def cpu_mesh(n):
    return make_mesh(devices=[torch.device('cpu')] * n)


def blocks(a, b=B):
    return lambda i: a[i * b:(i + 1) * b]


def models():
    return (JaxGMM.make(dim=2, dtype=jnp.float64, **GMM),
            BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **GMM))


def leaves_close(got, want, rtol=1e-9):
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def jax_start(jm, data, b=B):
    st, _ = jm.fit_vi_fused(data, key=1, maxiter=1, block_size=b,
                            backend='xla')
    return st


@pytest.mark.parametrize('kind', ['vi', 'map', 'em'])
def test_stream_full_over_a_mesh_matches_jax(x, kind):
    """6 sweeps over 3 blocks from a shared state: the port over 8 CPU
    positions against mimo_tpu over its 8 CPU devices (rtol 1e-9; JAX
    reduces once a block, the port once a sweep)."""
    jm, tm = models()
    jst0 = jax_start(jm, jnp.asarray(x))
    if kind == 'em':
        jst0, _ = jm.fit_em_fused(jnp.asarray(x), key=1, maxiter=1,
                                  block_size=B, backend='xla')
    eng = f'fit_{kind}_stream_full'
    jst, jtr = getattr(jm, eng)(blocks(x), 3, maxiter=6, init_state=jst0,
                                block_size=500, mesh=jmesh.make_mesh())
    st, tr = getattr(tm, eng)(blocks(x), 3, maxiter=6,
                              init_state=state_from_numpy(jst0),
                              block_size=500, mesh=cpu_mesh(8))
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)


def test_ilr_blocks_over_a_mesh_match_jax():
    """Two-array (x, y) blocks of the ILR mixture over 8 positions
    against mimo_tpu's (rtol 1e-9)."""
    rng = np.random.default_rng(5)
    xi = rng.uniform(-6, 6, (9600, 1))
    yi = np.sin(xi) + 0.1 * rng.standard_normal((9600, 1))
    b = 3200
    kw = dict(size=8, input_dim=1, output_dim=1, alpha=2.0, kappa=0.05)
    jm = JaxILR.make(dtype=jnp.float64, **kw)
    tm = BayesianILR.make(dtype=torch.float64, device='cpu', **kw)
    jst0 = jax_start(jm, (jnp.asarray(xi), jnp.asarray(yi)), 3200)

    def read_xy(i):
        return xi[i * b:(i + 1) * b], yi[i * b:(i + 1) * b]

    jst, jtr = jm.fit_vi_stream_full(read_xy, 3, maxiter=5, init_state=jst0,
                                     block_size=400, mesh=jmesh.make_mesh())
    st, tr = tm.fit_vi_stream_full(read_xy, 3, maxiter=5,
                                   init_state=state_from_numpy(jst0),
                                   mesh=cpu_mesh(8))
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)


@pytest.mark.parametrize('kind', ['vi', 'map'])
@pytest.mark.parametrize('n_pos', [4, 8])
def test_streamed_start_is_the_one_position_start(x, monkeypatch, kind,
                                                  n_pos):
    """From a key, the streamed random start over n_pos positions is the
    start over one position up to the order of its sums (rtol 1e-12),
    and so is the fit after 3 sweeps (rtol 1e-10); chunks of 256 points
    put chunk edges inside shards."""
    monkeypatch.setattr(tmix, '_RESP_ROWS', 256)
    _, tm = models()
    eng = getattr(tm, f'fit_{kind}_stream_full')
    for sweeps, rtol in ((0, 1e-12), (3, 1e-10)):
        a, ta = eng(blocks(x), 3, key=5, maxiter=sweeps,
                    mesh=cpu_mesh(n_pos))
        b, tb = eng(blocks(x), 3, key=5, maxiter=sweeps, mesh=cpu_mesh(1))
        leaves_close(a, state_to_numpy(b), rtol)
        np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=rtol)


def test_em_anchor_start_over_a_mesh_raises_in_both_packages(x):
    jm, tm = models()
    with pytest.raises(NotImplementedError, match='anchor'):
        jm.fit_em_stream_full(blocks(x), 3, key=1, maxiter=2,
                              mesh=jmesh.make_mesh())
    with pytest.raises(NotImplementedError, match='anchor'):
        tm.fit_em_stream_full(blocks(x), 3, key=1, maxiter=2,
                              mesh=cpu_mesh(8))


def batches(x, bs):
    """The same numpy batch sequence for both packages."""
    return lambda i: x[np.random.default_rng(100 + i).choice(
        x.shape[0], size=bs, replace=False)]


@pytest.mark.parametrize('maxiter,group,forgetting', [
    (37, 8, 0.7), (21, 16, None)])
def test_svi_stream_over_a_mesh_matches_jax(x, monkeypatch, maxiter, group,
                                            forgetting):
    """fit_svi_stream over 8 positions against mimo_tpu's over its 8
    devices on the same global batches of 256, both from JAX's random
    start over batch 0 (rtol 1e-9); the port takes each step's
    statistics through the fused E-step, JAX through the dense ones."""
    jm, tm = models()
    resp = torch.from_numpy(np.array(jmix._random_resp(
        jax.random.PRNGKey(4), 256, K, jnp.float64)))
    monkeypatch.setattr(
        tmix, '_random_resp', lambda gen, n, k, dtype, device, start=0:
        resp[start:start + n].clone())
    kw = dict(total_size=N, key=4, maxiter=maxiter, step_size=0.5,
              batch_size=256, group=group, forgetting=forgetting)
    jst = jm.fit_svi_stream(batches(x, 256), mesh=jmesh.make_mesh(), **kw)
    st = tm.fit_svi_stream(batches(x, 256), mesh=cpu_mesh(8), **kw)
    leaves_close(st, jst)


def test_ilr_svi_stream_over_a_mesh_matches_jax(monkeypatch):
    """(x, y) minibatches of the ILR mixture through fit_svi_stream over 8
    positions against mimo_tpu's over its 8 devices, from JAX's random
    start over batch 0 (rtol 1e-9)."""
    rng = np.random.default_rng(6)
    xi = rng.uniform(-6, 6, (6000, 1))
    yi = np.sin(xi) + 0.1 * rng.standard_normal((6000, 1))
    kw = dict(size=8, input_dim=1, output_dim=1, alpha=2.0, kappa=0.05)
    jm = JaxILR.make(dtype=jnp.float64, **kw)
    tm = BayesianILR.make(dtype=torch.float64, device='cpu', **kw)
    resp = torch.from_numpy(np.array(jmix._random_resp(
        jax.random.PRNGKey(2), 128, 8, jnp.float64)))
    monkeypatch.setattr(
        tmix, '_random_resp', lambda gen, n, k, dtype, device, start=0:
        resp[start:start + n].clone())

    def batch(i):
        idx = np.random.default_rng(200 + i).choice(6000, 128, replace=False)
        return xi[idx], yi[idx]

    kw = dict(total_size=6000, key=2, maxiter=12, step_size=0.5,
              batch_size=128, group=4)
    jst = jm.fit_svi_stream(batch, mesh=jmesh.make_mesh(), **kw)
    st = tm.fit_svi_stream(batch, mesh=cpu_mesh(8), **kw)
    leaves_close(st, jst)


def test_svi_stream_over_a_mesh_is_the_one_position_run(x):
    """From a key (the port's own start) over 4 positions against one
    position, and against the unsharded stream (rtol 1e-10)."""
    _, tm = models()
    kw = dict(total_size=N, key=3, maxiter=20, step_size=0.5,
              batch_size=256, group=8)
    a = tm.fit_svi_stream(batches(x, 256), mesh=cpu_mesh(4), **kw)
    b = tm.fit_svi_stream(batches(x, 256), mesh=cpu_mesh(1), **kw)
    c = tm.fit_svi_stream(batches(x, 256), **kw)
    leaves_close(a, state_to_numpy(b), 1e-10)
    leaves_close(a, state_to_numpy(c), 1e-10)


@pytest.mark.parametrize('n,b', [(N, 5000), (5, 5)])
def test_ragged_blocks_and_empty_shards(x, n, b):
    """Blocks of 5000 (a 2000-point tail: shards of 625 and of 250) and
    N = 5 over 8 positions (three empty shards, one launch or blockwise
    pass per non-empty shard): the streamed VI, MAP-EM and ML-EM over the
    mesh equal the port's unsharded stream from the same state (rtol
    1e-10), and so does SVI on batches of 5."""
    _, tm = models()
    xs = x[:n]
    nb = -(-n // b)
    st0 = tm.fit_vi_fused(torch.from_numpy(x), key=1, maxiter=1)[0]
    em0 = tm.fit_em_fused(torch.from_numpy(x), key=1, maxiter=1)[0]
    for kind, init in (('vi', st0), ('map', st0), ('em', em0)):
        eng = getattr(tm, f'fit_{kind}_stream_full')
        a, ta = eng(blocks(xs, b), nb, maxiter=3, init_state=init,
                    mesh=cpu_mesh(8))
        c, tc = eng(blocks(xs, b), nb, maxiter=3, init_state=init)
        np.testing.assert_allclose(ta.numpy(), tc.numpy(), rtol=1e-10)
        leaves_close(a, state_to_numpy(c), 1e-10)
    kw = dict(total_size=N, maxiter=6, step_size=0.5, batch_size=5, group=4,
              init_state=st0)
    a = tm.fit_svi_stream(batches(x, 5), mesh=cpu_mesh(8), **kw)
    c = tm.fit_svi_stream(batches(x, 5), **kw)
    leaves_close(a, state_to_numpy(c), 1e-10)


def test_bf16_transfer_over_a_mesh_upcasts_to_the_states_dtype(x):
    """bf16 on the wire over 4 positions equals the float64 stream of the
    bf16-rounded data (rtol 1e-12): the blocks are upcast to the state's
    dtype."""
    _, tm = models()
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64).numpy()
    st0 = tm.fit_vi_fused(torch.from_numpy(xb), key=1, maxiter=1)[0]
    a, ta = tm.fit_vi_stream_full(blocks(x), 3, maxiter=3, init_state=st0,
                                  transfer_dtype=torch.bfloat16,
                                  mesh=cpu_mesh(4))
    b, tb = tm.fit_vi_stream_full(blocks(xb), 3, maxiter=3, init_state=st0,
                                  mesh=cpu_mesh(4))
    assert ta.dtype == torch.float64
    np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=1e-12)
    leaves_close(a, state_to_numpy(b), 1e-12)


@pytest.mark.parametrize('n_blocks', [3, 6])
def test_one_reduction_a_streamed_sweep_whatever_the_blocks(x, n_blocks):
    """A streamed sweep over 8 positions makes exactly one reduction of
    K m8 + 1 floats, however many blocks it reads; its random start one
    more ('start'); fit_svi_stream one a step; the unsharded stream is
    the one-position case and makes one a sweep too. No all_reduce in
    one process."""
    _, tm = models()
    b = N // n_blocks
    for mesh in (cpu_mesh(8), None):
        for kind in ('vi', 'map'):
            tmesh.reset_counters()
            getattr(tm, f'fit_{kind}_stream_full')(
                blocks(x, b), n_blocks, key=1, maxiter=4, mesh=mesh)
            sweep = tmesh.counters['sweep']
            assert sweep['calls'] == 4 and sweep['all_reduce'] == 0
            assert sweep['floats'] == 4 * (K * M8 + 1)
            assert tmesh.counters['start']['calls'] == 1
    tmesh.reset_counters()
    tm.fit_svi_stream(batches(x, 256), total_size=N, key=1, maxiter=10,
                      batch_size=256, group=4, mesh=cpu_mesh(8))
    sweep = tmesh.counters['sweep']
    assert sweep['calls'] == 10 and sweep['floats'] == 10 * (K * M8 + 1)
