"""The port's out-of-core engines (fit_vi_stream_full, fit_map_stream_full,
fit_em_stream_full, fit_svi_stream) on the CPU in float64, where the
blocks go through the blockwise twin of kernel B1:

  * against the port's in-memory fused engines from the same start over
    the same block partition (the statistics add across blocks), the
    ragged last block included;
  * against mimo_tpu's stream engines from converted states, and from the
    same random or anchor start (JAX's draws handed to the port);
  * two-array ILR blocks, fit_svi_stream's groups, schedule and prefetch
    depth, and the bf16 transfer, which upcasts to the state's dtype (the
    reference upcasts to a hard-coded float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.models import mixture as jmix
from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.ilr import BayesianILR as JaxILR

from mimo_tpu_torch.bridge import state_from_numpy, state_to_numpy
from mimo_tpu_torch.models import BayesianGMM, BayesianILR
from mimo_tpu_torch.models import mixture as tmix

torch.set_num_threads(1)

N, B = 12000, 4000
GMM = dict(size=6, gating='dp', kappa=0.05, psi_scale=0.5)


@pytest.fixture(scope='module')
def x():
    rng = np.random.default_rng(0)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return (c[rng.integers(0, 3, N)]
            + rng.standard_normal((N, 2))).astype(np.float32).astype(
                np.float64)


def blocks(a, b=B):
    return lambda i: a[i * b:(i + 1) * b]


def n_blocks(n, b=B):
    return -(-n // b)


def models(dtype=torch.float64):
    jm = JaxGMM.make(dim=2, dtype=jnp.float64 if dtype == torch.float64
                     else jnp.float32, **GMM)
    tm = BayesianGMM.make(dim=2, dtype=dtype, device='cpu', **GMM)
    return jm, tm


def leaves_close(got, want, rtol=1e-9):
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def jax_start(jm, x):
    st, _ = jm.fit_vi_fused(jnp.asarray(x), key=1, maxiter=1, block_size=B,
                            backend='xla')
    return st


@pytest.mark.parametrize('b', [B, 5000])
def test_vi_stream_equals_in_memory_fused(x, b):
    """From one start over blocks of block_size points (5000: a ragged
    2000-point last block) the streamed sweep is the in-memory one."""
    jm, tm = models()
    st0 = state_from_numpy(jax_start(jm, x))
    xt = torch.from_numpy(x)
    ref, vr = tm.fit_vi_fused(xt, maxiter=6, block_size=b, init_state=st0,
                              randomize=False)
    st, vs = tm.fit_vi_stream_full(blocks(x, b), n_blocks(N, b), maxiter=6,
                                   init_state=st0, block_size=b)
    assert torch.equal(vs, vr)
    for a, c in zip(jax.tree.leaves(state_to_numpy(ref)),
                    jax.tree.leaves(state_to_numpy(st))):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize('kind', ['vi', 'map'])
@pytest.mark.parametrize('b', [B, 5000])
def test_stream_full_matches_jax_from_a_converted_state(x, kind, b):
    jm, tm = models()
    jst0 = jax_start(jm, x)
    eng = f'fit_{kind}_stream_full'
    jst, jtr = getattr(jm, eng)(blocks(x, b), n_blocks(N, b), maxiter=6,
                                init_state=jst0, block_size=b,
                                backend='xla')
    st, tr = getattr(tm, eng)(blocks(x, b), n_blocks(N, b), maxiter=6,
                              init_state=state_from_numpy(jst0),
                              block_size=b)
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)


def test_map_stream_equals_in_memory_map_sweeps(x):
    """fit_map_fused has no warm start, so the streamed MAP from the
    in-memory fit's random start is held to the in-memory trace."""
    jm, tm = models()
    xt = torch.from_numpy(x)
    gen_resp = tmix._random_resp(tmix._as_generator(2, 'cpu'), N, tm.size,
                                 torch.float64, 'cpu')
    st0 = tm._mf_update((xt,), gen_resp)
    ref, lr = tm.fit_map_fused(xt, key=2, maxiter=5, block_size=B)
    st, ls = tm.fit_map_stream_full(blocks(x), n_blocks(N), maxiter=5,
                                    init_state=st0, block_size=B)
    assert torch.equal(ls, lr)
    leaves_close(st, state_to_numpy(ref), rtol=0)


def test_vi_stream_random_start_matches_jax(x, monkeypatch):
    """Without init_state both packages start from random
    responsibilities drawn block by block; handed JAX's, the port's fit
    is JAX's."""
    jm, tm = models()
    key = jax.random.PRNGKey(5)
    resps = [torch.from_numpy(np.array(jmix._random_resp(
        jax.random.fold_in(key, i), B, tm.size, jnp.float64)))
        for i in range(n_blocks(N))]
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: resps.pop(0))
    jst, jtr = jm.fit_vi_stream_full(blocks(x), n_blocks(N), key=5,
                                     maxiter=4, block_size=B, backend='xla')
    st, tr = tm.fit_vi_stream_full(blocks(x), n_blocks(N), key=5, maxiter=4,
                                   block_size=B)
    assert not resps
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)


def test_em_stream_matches_jax_from_the_anchor_start_and_a_state(
        x, monkeypatch):
    jm, tm = models()
    idx = torch.from_numpy(np.array(jax.random.choice(
        jax.random.PRNGKey(3), B, (tm.size,), replace=False)))
    monkeypatch.setattr(tmix, '_anchor_indices', lambda *a: idx.clone())
    jst, jtr = jm.fit_em_stream_full(blocks(x), n_blocks(N), key=3,
                                     maxiter=6, block_size=B, backend='xla')
    st, tr = tm.fit_em_stream_full(blocks(x), n_blocks(N), key=3, maxiter=6,
                                   block_size=B)
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)
    assert float(tr[-1]) > float(tr[1])
    # continue from the converted EMState
    jst2, jtr2 = jm.fit_em_stream_full(blocks(x), n_blocks(N), maxiter=4,
                                       init_state=jst, block_size=B,
                                       backend='xla')
    st2, tr2 = tm.fit_em_stream_full(blocks(x), n_blocks(N), maxiter=4,
                                     init_state=state_from_numpy(jst),
                                     block_size=B)
    np.testing.assert_allclose(tr2.numpy(), jtr2, rtol=1e-9)
    leaves_close(st2, jst2)


def test_em_stream_equals_in_memory_em_from_one_state(x):
    _, tm = models()
    xt = torch.from_numpy(x)
    em0, _ = tm.fit_em_fused(xt, key=1, maxiter=2, block_size=B)
    st, tr = tm.fit_em_stream_full(blocks(x), n_blocks(N), maxiter=4,
                                   init_state=em0, block_size=B)
    # in memory: the same sweeps from em0 by hand
    data = tmix._Shards(None, (xt,), 'torch', B)
    spec = tm._plugin_spec('fit_em')
    params, log_pi, trace = em0.params, em0.log_pi, []
    for _ in range(4):
        res = data.estep(spec, params, log_pi)
        params = tm.family.ml_update(res.stats)
        log_pi = tm._ml_log_pi(res.counts, torch.sum(res.counts))
        trace.append(res.lse)
    assert torch.equal(tr, torch.stack(trace))


def test_ilr_two_array_blocks_match_jax():
    rng = np.random.default_rng(5)
    xi = rng.uniform(-6, 6, (9000, 1))
    yi = np.sin(xi) + 0.1 * rng.standard_normal((9000, 1))
    b = 3000
    kw = dict(size=8, input_dim=1, output_dim=1, alpha=2.0, kappa=0.05)
    jm = JaxILR.make(dtype=jnp.float64, **kw)
    tm = BayesianILR.make(dtype=torch.float64, device='cpu', **kw)
    jst0, _ = jm.fit_vi_fused((jnp.asarray(xi), jnp.asarray(yi)), key=1,
                              maxiter=1, block_size=b, backend='xla')

    def read_xy(i):
        return xi[i * b:(i + 1) * b], yi[i * b:(i + 1) * b]

    jst, jtr = jm.fit_vi_stream_full(read_xy, 3, maxiter=5, init_state=jst0,
                                     block_size=b, backend='xla')
    st, tr = tm.fit_vi_stream_full(read_xy, 3, maxiter=5,
                                   init_state=state_from_numpy(jst0),
                                   block_size=b)
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-9)
    leaves_close(st, jst)


# -- fit_svi_stream -----------------------------------------------------------

def batches(x, bs):
    """The same numpy batch sequence for both packages."""
    return lambda i: x[np.random.default_rng(100 + i).choice(
        x.shape[0], size=bs, replace=False)]


@pytest.mark.parametrize('maxiter,group,forgetting', [
    (32, 8, None), (37, 8, None), (37, 8, 0.7), (21, 16, 0.55)])
def test_svi_stream_matches_jax(x, maxiter, group, forgetting):
    jm, tm = models()
    jst0 = jax_start(jm, x)
    kw = dict(total_size=N, maxiter=maxiter, step_size=0.5, batch_size=256,
              group=group, forgetting=forgetting, delay=1.0)
    jst = jm.fit_svi_stream(batches(x, 256), init_state=jst0, **kw)
    st = tm.fit_svi_stream(batches(x, 256), init_state=state_from_numpy(jst0),
                           **kw)
    leaves_close(st, jst)


def test_svi_stream_random_start_matches_jax(x, monkeypatch):
    jm, tm = models()
    resp = torch.from_numpy(np.array(jmix._random_resp(
        jax.random.PRNGKey(4), 256, tm.size, jnp.float64)))
    monkeypatch.setattr(tmix, '_random_resp', lambda *a: resp.clone())
    kw = dict(total_size=N, key=4, maxiter=20, step_size=0.5,
              batch_size=256, group=8)
    leaves_close(tm.fit_svi_stream(batches(x, 256), **kw),
                 jm.fit_svi_stream(batches(x, 256), **kw))


def test_svi_stream_does_not_depend_on_prefetch_depth(x):
    _, tm = models()
    st0 = tm.fit_vi_fused(torch.from_numpy(x), key=1, maxiter=1)[0]
    kw = dict(total_size=N, maxiter=30, step_size=0.5, batch_size=128,
              group=4, init_state=st0)
    a = tm.fit_svi_stream(batches(x, 128), prefetch=1, **kw)
    b = tm.fit_svi_stream(batches(x, 128), prefetch=3, **kw)
    for u, v in zip(jax.tree.leaves(state_to_numpy(a)),
                    jax.tree.leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(u, v)


def test_svi_stream_recovers_the_means(x):
    _, tm = models()
    st = tm.fit_svi_stream(batches(x, 512), total_size=N, key=0,
                           maxiter=200, step_size=0.5, batch_size=512)
    used = tm.used_labels(st, torch.from_numpy(x))
    est = st.components.mu[used].numpy()
    for t in np.array([[-4., 0.], [4., 0.], [0., 5.]]):
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.4


# -- transfer_dtype -----------------------------------------------------------

def test_bf16_transfer_stays_within_jaxs_tolerance(x):
    """float32 model: bf16 on the wire stays within 1e-4 of the float32
    stream (the JAX test's tolerance)."""
    _, tm = models(torch.float32)
    x32 = x.astype(np.float32)
    st0, _ = tm.fit_vi_stream_full(blocks(x32), n_blocks(N), key=1,
                                   maxiter=1)
    stf, vf = tm.fit_vi_stream_full(blocks(x32), n_blocks(N),
                                    init_state=st0, maxiter=6)
    stb, vb = tm.fit_vi_stream_full(blocks(x32), n_blocks(N),
                                    init_state=st0, maxiter=6,
                                    transfer_dtype=torch.bfloat16)
    np.testing.assert_allclose(vb.numpy(), vf.numpy(), rtol=1e-4)
    np.testing.assert_allclose(stb.components.mu.numpy(),
                               stf.components.mu.numpy(), atol=5e-3)
    st = tm.fit_svi_stream(batches(x32, 512), total_size=N, key=0,
                           maxiter=40, step_size=0.5, batch_size=512,
                           transfer_dtype=torch.bfloat16)
    assert all(np.isfinite(a).all()
               for a in jax.tree.leaves(state_to_numpy(st)))


@pytest.mark.parametrize('kind', ['vi', 'map', 'em', 'svi'])
def test_bf16_transfer_upcasts_to_the_states_dtype(x, kind):
    """A float64 state with bf16 transfer: the blocks are upcast to
    float64, so the fit equals a float64 stream of the bf16-rounded data
    (the reference upcasts to a hard-coded float32)."""
    _, tm = models()
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64).numpy()
    st0 = tm.fit_vi_fused(torch.from_numpy(xb), key=1, maxiter=1)[0]
    if kind == 'svi':
        kw = dict(total_size=N, maxiter=20, step_size=0.5, batch_size=256,
                  group=8, init_state=st0)
        a = tm.fit_svi_stream(batches(x, 256), transfer_dtype=torch.bfloat16,
                              **kw)
        b = tm.fit_svi_stream(batches(xb, 256), **kw)
    else:
        if kind == 'em':
            st0 = tm.fit_em_fused(torch.from_numpy(xb), key=1, maxiter=1)[0]
        eng = getattr(tm, f'fit_{kind}_stream_full')
        a, ta = eng(blocks(x), n_blocks(N), maxiter=4, init_state=st0,
                    block_size=B, transfer_dtype=torch.bfloat16)
        b, tb = eng(blocks(xb), n_blocks(N), maxiter=4, init_state=st0,
                    block_size=B)
        assert ta.dtype == torch.float64
        np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=1e-12)
    for u, v in zip(jax.tree.leaves(state_to_numpy(a)),
                    jax.tree.leaves(state_to_numpy(b))):
        assert u.dtype == np.float64
        np.testing.assert_allclose(u, v, rtol=1e-12, atol=1e-12)


def test_transfer_dtype_and_empty_streams_are_refused(x):
    _, tm = models()
    with pytest.raises(ValueError, match='transfer_dtype'):
        tm.fit_vi_stream_full(blocks(x), 3, transfer_dtype=torch.int8)
    with pytest.raises(ValueError, match='nothing to stream'):
        tm.fit_vi_stream_full(blocks(x), 0)


def test_stream_reads_an_mmap_dataset(x, tmp_path):
    """The README's flow: write a file, MmapDataset, read_block."""
    import shutil
    if shutil.which('g++') is None:
        pytest.skip('no C++ toolchain for the native loader')
    from mimo_tpu_torch.io import MmapDataset, write_bin
    path = str(tmp_path / 'x.bin')
    write_bin(path, x)
    ds = MmapDataset(path)
    _, tm = models()
    st0 = state_from_numpy(jax_start(models()[0], x))
    a = tm.fit_vi_stream_full(lambda i: ds.read_block(i * B, B), 3,
                              maxiter=3, init_state=st0, block_size=B)
    b = tm.fit_vi_stream_full(blocks(x), 3, maxiter=3, init_state=st0,
                              block_size=B)
    assert torch.equal(a[1], b[1])
    ds.close()
