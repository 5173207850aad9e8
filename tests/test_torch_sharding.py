"""The port's device mesh (mimo_tpu_torch/parallel/mesh.py) and the mesh=
paths of its engines on the CPU, in float64, over a mesh of eight CPU
positions (the counterpart of the JAX tests' eight virtual CPU devices,
tests/conftest.py), where kernels B1-B6 run their plain versions:

  * the mesh, shard_data's contiguous shards (views where the device
    repeats), replicate, pad_to_multiple and data_parallel_fit's
    refusals, against mimo_tpu.parallel.mesh where it has the function;
  * the dense fit_vi / fit_map / fit_em through data_parallel_fit against
    mimo_tpu's data_parallel_fit from a shared start (rtol 1e-9) and the
    port's unsharded fits from the same key (rtol 1e-10), for the GMM and
    ILR; dense Gibbs (one position bitwise the unsharded chain, eight
    shards' mass recovery), fit_chains of the dense engines over a (2, 4)
    mesh, and one reduction a dense sweep;
  * the sharded fused VI / MAP-EM / ML-EM against mimo_tpu's sharded runs
    from a shared start (rtol 1e-8) and the port's unsharded runs, for
    the flat, diagonal and nested GMMs and ILR at p = 1 and 3;
  * sharded Gibbs (one shard bitwise the unsharded sweep; eight shards:
    each shard's statistics the one-hot sums of its labels, the cluster
    mass of mimo_tpu's test_gibbs_fused_sharded_runs), sharded SVI's
    recovery, sharded serving, fit_chains over a (2, 4) mesh, empty and
    short shards, and the communication contract: one reduction a sweep
    of K m8 + 1 floats whatever N, none in serving."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu.models.gmm import BayesianGMM as JaxGMM
from mimo_tpu.models.hmix import BayesianMixtureOfMixtures as JaxHMix
from mimo_tpu.models.ilr import BayesianILR as JaxILR
from mimo_tpu.models import mixture as jmix
from mimo_tpu.parallel import mesh as jmesh

from mimo_tpu_torch.bridge import state_to_numpy
from mimo_tpu_torch.models import (
    BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models import hmix as thmix
from mimo_tpu_torch.models import mixture as tmix
from mimo_tpu_torch.ops import (
    cuda_diag_predict, cuda_estep, cuda_gibbs, cuda_ilr_predict,
    cuda_predict)
from mimo_tpu_torch.ops import family_estep as tfe
from mimo_tpu_torch.ops.philox import shard_seed
from mimo_tpu_torch.parallel import (
    Sharded, data_parallel_fit, fit_chains, make_mesh, pad_to_multiple,
    replicate, shard_data)
from mimo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

N = 1600                # 200 points a shard: mimo_tpu's sharded engines
CPU8 = [torch.device('cpu')] * 8


def tt(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def gmm_x():
    rng = np.random.default_rng(5)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return c[rng.integers(0, 3, N)] + 0.7 * rng.standard_normal((N, 2))


@pytest.fixture(scope='module')
def ilr_xy():
    rng = np.random.default_rng(3)
    x = rng.uniform(-6, 6, (N, 1))
    y = np.concatenate([np.sin(x), np.cos(x), np.sin(0.5 * x)], 1)
    return x, y + 0.1 * rng.standard_normal((N, 3))


@pytest.fixture(scope='module')
def mesh8():
    return make_mesh(devices=CPU8)


def leaves_close(got, want, rtol):
    g = jax.tree.leaves(state_to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def uniform_resp(key, shape):
    r = jax.random.uniform(key, shape, dtype=jnp.float64, minval=1e-3,
                           maxval=1.0)
    return tt(r / jnp.sum(r, -1, keepdims=True))


# -- the mesh -----------------------------------------------------------------

def test_mesh_shape_shards_and_views(mesh8):
    assert mesh8.shape == {'chain': 1, 'data': 8}
    assert mesh8.positions == tuple(range(8))
    m24 = make_mesh(n_chain=2, devices=CPU8)
    assert m24.shape == {'chain': 2, 'data': 4} and m24.rows() == [0, 1]
    assert m24.row(1).positions == (4, 5, 6, 7)
    assert m24.row(1).shape == {'chain': 1, 'data': 4}
    x = torch.arange(4093 * 2, dtype=torch.float64).reshape(4093, 2)
    xs = shard_data(mesh8, x)
    assert [s.shape[0] for s in xs.shards] == [512] * 7 + [509]
    assert xs.n == 4093 and xs.positions == tuple(range(8))
    # a repeated device holds views of the data, not copies
    assert all(s.data_ptr() == x[512 * j].data_ptr()
               for j, s in enumerate(xs.shards))
    assert torch.equal(xs.gather(), x)
    five = shard_data(mesh8, x[:5])
    assert [s.shape[0] for s in five.shards] == [1] * 5 + [0] * 3
    # every chain row gets the data
    both = shard_data(m24, x)
    assert torch.equal(both.on(m24.row(1)).gather(), x)
    a, b = shard_data(mesh8, x, x[:, :1])
    assert isinstance(a, Sharded) and b.shards[0].shape == (512, 1)
    reps = replicate(mesh8, (x, x[0]))
    assert len(reps) == 8 and reps[3][0] is x


def test_make_mesh_takes_the_cards_and_refuses_bad_shapes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(n_data=9, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(devices=['cpu', 'meta'])
    with pytest.raises(ValueError):
        make_mesh(n_chain=2, devices=CPU8).one_row()


@pytest.mark.parametrize('n,multiple,axis', [(10, 4, 0), (8, 4, 0),
                                             (7, 3, 1)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    a = np.arange(2 * n, dtype=np.float64).reshape((n, 2) if axis == 0
                                                   else (2, n))
    got, nv = pad_to_multiple(tt(a), multiple, axis)
    want, nv_j = jmesh.pad_to_multiple(jnp.asarray(a), multiple, axis)
    assert nv == nv_j == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_data_parallel_fit_raises_as_jax(gmm_x, mesh8):
    m = BayesianGMM.make(size=4, dim=2, dtype=torch.float64, device='cpu')
    x = tt(gmm_x)
    with pytest.raises(ValueError, match='not divisible'):
        data_parallel_fit(m, 'fit_vi_fused', x[:N - 3], mesh=mesh8, key=1)
    jm = JaxGMM.make(size=4, dim=2, dtype=jnp.float64)
    with pytest.raises(ValueError, match='not divisible'):
        jmesh.data_parallel_fit(jm, 'fit_vi', jnp.asarray(gmm_x[:N - 3]),
                                mesh=jmesh.make_mesh(), key=1)
    # an engine without a mesh path still raises, naming it
    for other in ('fit_vi_stream_full', 'fit_no_such_engine'):
        with pytest.raises(NotImplementedError, match=other):
            data_parallel_fit(m, other, x, mesh=mesh8, key=1)
    st, tr = data_parallel_fit(m, 'fit_map_fused', x, mesh=mesh8, key=1,
                               maxiter=3)
    st0, tr0 = m.fit_map_fused(x, key=1, maxiter=3)
    np.testing.assert_allclose(tr.numpy(), tr0.numpy(), rtol=1e-12)
    # the dense engines run over the mesh, each equal to its unsharded fit
    for dense in ('fit_vi', 'fit_map', 'fit_em'):
        st, tr = data_parallel_fit(m, dense, x, mesh=mesh8, key=1,
                                   maxiter=3)
        st0, tr0 = getattr(m, dense)(x, key=1, maxiter=3)
        np.testing.assert_allclose(tr.numpy(), tr0.numpy(), rtol=1e-10)
    gs = data_parallel_fit(m, 'fit_gibbs', x, mesh=mesh8, key=1, maxiter=2)
    assert isinstance(gs.labels, Sharded) and gs.labels.gather().shape == (N,)


# -- the fused engines against mimo_tpu's sharded runs ---------------------------

FLAT = {
    'dpgmm': dict(size=5, gating='dp', alpha=1.0, kappa=0.05,
                  psi_scale=0.5),
    'diag': dict(size=5, gating='dirichlet', diag=True, kappa=0.05),
    'ilr1': dict(size=6, alpha=2.0, kappa=0.05),
    'ilr3': dict(size=6, alpha=2.0, kappa=0.05),
}
NESTED = dict(cluster_size=2, mixture_size=3, dim=2, kappa=0.5,
              psi_scale=0.5, hierarchical=False)


def make_pair(name, gmm_x, ilr_xy):
    """(JAX model, port model, JAX data, port data, K), float64."""
    if name == 'nested':
        jm = JaxHMix.make_gmm(dtype=jnp.float64, **NESTED)
        tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                                device='cpu', **NESTED)
        return jm, tm, jnp.asarray(gmm_x), tt(gmm_x), 6
    kw = dict(FLAT[name])
    if name.startswith('ilr'):
        p = int(name[-1])
        x, y = ilr_xy[0], ilr_xy[1][:, :p]
        jm = JaxILR.make(input_dim=1, output_dim=p, dtype=jnp.float64, **kw)
        tm = BayesianILR.make(input_dim=1, output_dim=p, dtype=torch.float64,
                              device='cpu', **kw)
        jm.init_transform(jnp.asarray(x), jnp.asarray(y))
        tm.init_transform(tt(x), tt(y))
        return jm, tm, (jnp.asarray(x), jnp.asarray(y)), (tt(x), tt(y)), 6
    jm = JaxGMM.make(dim=2, dtype=jnp.float64, **kw)
    tm = BayesianGMM.make(dim=2, dtype=torch.float64, device='cpu', **kw)
    return jm, tm, jnp.asarray(gmm_x), tt(gmm_x), 5


def shared_start(monkeypatch, name, k):
    """Hand JAX's random responsibilities and anchors for key 1 to the
    port (its random streams cannot match JAX's)."""
    jkey = jax.random.PRNGKey(1)
    if name == 'nested':
        outer = uniform_resp(jkey, (N, 2))
        inner = uniform_resp(jax.random.fold_in(jkey, 1), (2, N, 3))
        idx = tt(jax.random.choice(jkey, N, (6,), replace=False))
        monkeypatch.setattr(
            thmix, '_two_level_resp',
            lambda seeds, n, m, k, dtype, device, start=0, total=None: (
                outer[start:start + n].clone(),
                inner[:, start:start + n].clone()))
        monkeypatch.setattr(thmix, '_anchor_indices',
                            lambda *a: idx.clone())
        return
    resp = tt(jmix._random_resp(jkey, N, k, jnp.float64))
    idx = tt(jax.random.choice(jkey, N, (k,), replace=False))
    monkeypatch.setattr(
        tmix, '_random_resp', lambda gen, n, k, dtype, device, start=0:
        resp[start:start + n].clone())
    monkeypatch.setattr(tmix, '_anchor_indices', lambda *a: idx.clone())


def jax_sharded(data):
    mesh = jmesh.make_mesh()
    data = data if isinstance(data, tuple) else (data,)
    out = tuple(jmesh.shard_data(mesh, a) for a in data)
    return (out if len(out) > 1 else out[0]), mesh


ENGINES = [(e, name) for name in ('dpgmm', 'diag', 'ilr1', 'ilr3',
                                  'nested')
           for e in ('fit_vi_fused', 'fit_map_fused', 'fit_em_fused')]


@pytest.mark.parametrize('engine,name', ENGINES)
def test_sharded_engines_match_jax_and_unsharded(monkeypatch, gmm_x, ilr_xy,
                                                 mesh8, engine, name):
    """5 sweeps from one start over 8 shards of 200 points: the trace and
    the final state against mimo_tpu's sharded run (rtol 1e-8) and the
    port's unsharded run (only the order of the sums differs)."""
    jm, tm, dj, dt, k = make_pair(name, gmm_x, ilr_xy)
    shared_start(monkeypatch, name, k)
    dj_sh, jm_mesh = jax_sharded(dj)
    st_j, tr_j = getattr(jm, engine)(dj_sh, key=1, maxiter=5,
                                     block_size=100, mesh=jm_mesh,
                                     backend='xla')
    dt_sh = shard_data(mesh8, *(dt if isinstance(dt, tuple) else (dt,)))
    st_t, tr_t = getattr(tm, engine)(dt_sh, key=1, maxiter=5,
                                     block_size=100, mesh=mesh8)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-8)
    leaves_close(st_t, st_j, 1e-8)
    st_u, tr_u = getattr(tm, engine)(dt, key=1, maxiter=5, block_size=100)
    np.testing.assert_allclose(tr_t.numpy(), tr_u.numpy(), rtol=1e-10)
    leaves_close(st_t, state_to_numpy(st_u), 1e-9)


# -- the sharded sweeps (ops) -----------------------------------------------------

def _map_inputs(kind, n, k=6, chains=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    d, p = (2, 1) if kind == cuda_estep.ILR else (2, 0)
    xt = torch.randn((d + p, n), generator=g, dtype=torch.float64)
    m = cuda_estep.feature_width(kind, d, p)
    m8 = -(-m // 8) * 8
    lead = (chains,) if chains else ()
    theta = 0.3 * torch.randn(lead + (k, m8), generator=g,
                              dtype=torch.float64)
    theta[..., m:] = 0.0
    return xt, theta, p


@pytest.mark.parametrize('n', [5, 1003])
@pytest.mark.parametrize('kind', [cuda_estep.GAUSS, cuda_estep.DIAG,
                                  cuda_estep.ILR])
def test_plain_b1_packed_partials_sum_to_the_unsharded(mesh8, kind, n):
    """estep_packed over each shard's column block (a view at any column
    offset) summed in shard order equals the unsharded B1 plain version,
    with and without chains; an empty shard is skipped."""
    for chains in (0, 3):
        xt, theta, p = _map_inputs(kind, n, chains=chains)
        acc, lse = cuda_estep.estep(xt, theta, n, kind, p)
        k, m8 = theta.shape[-2:]
        total = torch.zeros(theta.shape[:-2] + (k * m8 + 1,),
                            dtype=torch.float64)
        for j in range(8):
            lo, hi = tmesh.shard_bounds(n, 8, j)
            if hi > lo:
                total = total + cuda_estep.estep_packed(xt[:, lo:hi],
                                                        theta, hi - lo,
                                                        kind, p)
        got_acc, got_lse = tfe.unpack_estep(total, k, m8)
        np.testing.assert_allclose(got_acc.numpy(), acc.numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_lse.numpy(), lse.numpy(),
                                   rtol=1e-12)


def test_shard_seed_keeps_shard_zero():
    seed = torch.tensor(123456789012345, dtype=torch.int64)
    assert int(shard_seed(seed, 0)) == int(seed)
    assert int(shard_seed(seed, 3)) == int(seed) ^ (3 * 0x9E3779B9)
    seeds = torch.tensor([5, 2 ** 61 + 7], dtype=torch.int64)
    assert torch.equal(shard_seed(seeds, 0), seeds)


def f64_layout(data):
    """kernel_xts's layout kept in float64, so the plain versions run in
    float64 on the CPU."""
    buf = torch.cat([a.T for a in data]).contiguous()
    return tuple(torch.split(buf, [a.shape[1] for a in data]))


@pytest.mark.parametrize('chunk', [1 << 16, 256])
def test_random_resp_rows_are_keyed_by_the_point_index(monkeypatch, chunk):
    """Each row of the random start depends only on (seed, point index):
    any run of rows drawn alone, within one chunk of the draw or across
    chunks, is those rows of the draw over all N."""
    monkeypatch.setattr(tmix, '_RESP_ROWS', chunk)
    whole = tmix._random_resp(tmix._as_generator(3, 'cpu'), N, 5,
                              torch.float64, 'cpu')
    seed = tmix._resp_seed(tmix._as_generator(3, 'cpu'))
    for lo, hi in ((0, 1), (7, 300), (1203, N)):
        assert torch.equal(tmix._random_resp(seed, hi - lo, 5, torch.float64,
                                             'cpu', lo), whole[lo:hi])
    assert torch.allclose(torch.sum(whole, -1),
                          torch.ones(N, dtype=whole.dtype))


@pytest.mark.parametrize('name', ['dpgmm', 'nested'])
@pytest.mark.parametrize('n', [N, 5])
def test_sharded_random_start_is_the_unsharded_start(monkeypatch, gmm_x,
                                                      ilr_xy, mesh8, name, n):
    """With the port's own draw (no shared start handed in), each of the
    8 shards draws only its own rows of the random start, and the start
    equals the unsharded one up to the order of its sums (rtol 1e-12),
    also where shards are empty; chunks of 256 points put the shards'
    edges inside chunks."""
    monkeypatch.setattr(tmix, '_RESP_ROWS', 256)
    _, tm, _, x, _ = make_pair(name, gmm_x, ilr_xy)
    x = x[:n]

    def start(mesh):
        data = tmix._Shards(mesh, x, 'torch')
        gen = tmix._as_generator(3, 'cpu')
        if name == 'nested':
            return tm._random_state(gen, data)
        return tm._random_start(data, [gen], False)

    leaves_close(start(mesh8), state_to_numpy(start(None)), 1e-12)


@pytest.mark.parametrize('kind', [cuda_estep.GAUSS, cuda_estep.ILR])
def test_sharded_sweeps_over_the_kernel_layout(kind):
    """fused_estep_cuda_sharded / fused_gibbs_cuda_sharded (here on the
    plain versions) against the unsharded wrappers: statistics to rtol
    1e-12; shard 0 of the Gibbs sweep bitwise the unsharded labels on its
    points; every shard's statistics the one-hot sums of its labels."""
    spec = (tfe.gaussian_spec() if kind == cuda_estep.GAUSS
            else tfe.ilr_spec(2, 1))
    m = make_mesh(devices=[torch.device('cpu')] * 4)
    n = 1003
    g = torch.Generator().manual_seed(4)
    data = ((torch.randn((n, 2), generator=g, dtype=torch.float64),)
            if kind == cuda_estep.GAUSS else
            (torch.randn((n, 2), generator=g, dtype=torch.float64),
             torch.randn((n, 1), generator=g, dtype=torch.float64)))
    tm = (BayesianGMM.make(size=5, dim=2, dtype=torch.float64, device='cpu')
          if kind == cuda_estep.GAUSS else
          BayesianILR.make(size=5, input_dim=2, output_dim=1,
                           dtype=torch.float64, device='cpu'))
    post = tm.components_prior
    params = tm.family.mode_params(post)
    log_pi = torch.log(torch.full((5,), 0.2, dtype=torch.float64))
    shards = [tuple(a[lo:hi] for a in data)
              for lo, hi in (tmesh.shard_bounds(n, 4, j) for j in range(4))]
    xts = [f64_layout(s) for s in shards]
    whole = f64_layout(data)
    ref = cuda_estep.fused_estep_cuda(spec, post, log_pi, whole, n)
    got = cuda_estep.fused_estep_cuda_sharded(spec, post, log_pi, xts, m)
    leaves_close(got, state_to_numpy(ref), 1e-12)
    seed = torch.tensor(77, dtype=torch.int64)
    lab0, ref = cuda_gibbs.fused_gibbs_cuda(spec, seed, params, log_pi,
                                            whole, n)
    labs, got = cuda_gibbs.fused_gibbs_cuda_sharded(spec, seed, params,
                                                    log_pi, xts, m)
    lo, hi = tmesh.shard_bounds(n, 4, 0)
    assert torch.equal(labs[0], lab0[lo:hi])
    assert sum(lab.shape[0] for lab in labs) == n
    onehot = sum(torch.nn.functional.one_hot(lab.long(), 5).sum(0)
                 for lab in labs)
    np.testing.assert_array_equal(got.counts.numpy(), onehot.numpy())
    # the statistics are the one-hot sums of each shard's own labels
    sums = sum(torch.nn.functional.one_hot(lab.long(), 5).to(
        torch.float64).T @ spec.features(part)
        for lab, part in zip(labs, shards))
    leaves_close(got.stats, state_to_numpy(spec.unpack(sums)), 1e-12)
    plain = tfe.fused_gibbs_sharded(spec, seed, params, log_pi, shards,
                                    256, m)
    for a, b in zip(plain[0], labs):
        assert torch.equal(a, b)


# -- Gibbs -------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['dpgmm', 'ilr1'])
def test_one_shard_gibbs_is_the_unsharded_sweep(gmm_x, ilr_xy, name):
    _, tm, _, dt, _ = make_pair(name, gmm_x, ilr_xy)
    one = make_mesh(devices=['cpu'])
    g0 = tm.fit_gibbs_fused(dt, key=2, maxiter=4)
    g1 = tm.fit_gibbs_fused(dt, key=2, maxiter=4, mesh=one)
    assert isinstance(g1.labels, Sharded)
    assert torch.equal(g1.labels.gather(), g0.labels)
    for a, b in zip(state_to_numpy(g1.components),
                    state_to_numpy(g0.components)):
        for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(u, v)


def test_gibbs_over_eight_shards_recovers_the_mass(mesh8):
    """mimo_tpu's test_gibbs_fused_sharded_runs: 60 sweeps over 4096
    points; the labels stay on their shards."""
    rng = np.random.default_rng(0)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    x = tt(c[rng.choice(3, 4096, p=[.3, .4, .3])]
           + rng.standard_normal((4096, 2)) / np.sqrt(2.0))
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    st = m.fit_gibbs_fused(shard_data(mesh8, x), key=2, maxiter=60,
                           block_size=512, mesh=mesh8)
    assert [s.shape[0] for s in st.labels.shards] == [512] * 8
    counts = np.bincount(st.labels.gather().numpy(), minlength=8)
    assert counts.sum() == 4096
    assert np.sort(counts)[-4:].sum() > 0.8 * 4096
    assert bool(torch.isfinite(st.components.mu).all())


# -- SVI ---------------------------------------------------------------------------

def test_sharded_svi_recovers_the_centres(mesh8):
    """mimo_tpu's test_svi_sharded_runs_and_recovers: a stratified
    minibatch of 64 points a shard, 300 steps."""
    rng = np.random.default_rng(1)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    x = tt(c[rng.choice(3, 4096, p=[.3, .4, .3])]
           + rng.standard_normal((4096, 2)) / np.sqrt(2.0))
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    st, trace = m.fit_svi(shard_data(mesh8, x), key=4, maxiter=300,
                          step_size=0.5, batch_size=512, mesh=mesh8)
    mu = st.components.mu.numpy()
    assert np.isfinite(mu).all() and not trace.any()
    for centre in c:
        assert np.min(np.linalg.norm(mu - centre, axis=-1)) < 0.5
    with pytest.raises(ValueError, match='track_elbo'):
        m.fit_svi(x, mesh=mesh8, track_elbo=True, batch_size=512)
    with pytest.raises(ValueError, match='multiple'):
        m.fit_svi(x, mesh=mesh8, batch_size=500)


def test_nested_sharded_svi_runs(gmm_x, mesh8):
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **NESTED)
    tmesh.reset_counters()
    st = tm.fit_svi(tt(gmm_x), key=3, maxiter=20, batch_size=256,
                    maxsubiter=2, mesh=mesh8)
    assert all(np.isfinite(t).all()
               for t in jax.tree.leaves(state_to_numpy(st)))
    assert tmesh.counters['sweep']['calls'] == 20 * 2


# -- serving -----------------------------------------------------------------------

@pytest.mark.parametrize('name', ['dpgmm', 'diag', 'nested'])
def test_sharded_log_predictive_equals_dense(gmm_x, ilr_xy, mesh8, name):
    _, tm, _, dt, _ = make_pair(name, gmm_x, ilr_xy)
    st, _ = tm.fit_vi_fused(dt, key=1, maxiter=10)
    for dist in ('studentt', 'gaussian'):
        tmesh.reset_counters()
        lp = tm.log_predictive(st, shard_data(mesh8, dt[:N - 3]),
                               dist=dist, mesh=mesh8)
        assert isinstance(lp, Sharded) and tmesh.counters['sweep'][
            'calls'] == 0
        np.testing.assert_allclose(
            lp.gather().numpy(),
            tm.log_predictive(st, dt[:N - 3], dist=dist).numpy(),
            rtol=1e-12)


@pytest.mark.parametrize('name', ['ilr1', 'ilr3', 'nested-ilr'])
def test_sharded_predict_equals_dense(ilr_xy, mesh8, name):
    x, y = tt(ilr_xy[0]), tt(ilr_xy[1][:, :1 if name != 'ilr3' else 3])
    if name == 'nested-ilr':
        tm = BayesianMixtureOfMixtures.make_ilr(2, 3, 1, 1, kappa=0.05,
                                                dtype=torch.float64,
                                                device='cpu')
    else:
        tm = BayesianILR.make(size=6, input_dim=1, output_dim=y.shape[1],
                              alpha=2.0, kappa=0.05, dtype=torch.float64,
                              device='cpu')
    tm.init_transform(x, y)
    st, _ = tm.fit_vi_fused((x, y), key=1, maxiter=10)
    for yy in (y, None):
        got = tm.predict(st, x, yy, dist='studentt', mesh=mesh8)
        want = tm.predict(st, x, yy, dist='studentt')
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.gather().numpy(), b.numpy(),
                                       rtol=1e-12)


def test_sharded_serving_wrappers_equal_one_launch():
    """The ops-level serving entries over shards (plain versions on the
    CPU): coefficients once, one call a shard, an empty shard served
    empty, the results equal to the unsharded entry's."""
    g = torch.Generator().manual_seed(2)
    gm = BayesianGMM.make(size=4, dim=2, dtype=torch.float64, device='cpu')
    dm = BayesianGMM.make(size=4, dim=2, diag=True, dtype=torch.float64,
                          device='cpu')
    x = torch.randn((7, 2), generator=g, dtype=torch.float64)
    parts = [x[:4], x[4:], x[7:]]
    log_w = torch.log(torch.full((4,), 0.25, dtype=torch.float64))
    for fn, post in ((cuda_predict.gauss_predictive_cuda_sharded,
                      gm.components_prior),
                     (cuda_diag_predict.diag_predictive_cuda_sharded,
                      dm.components_prior)):
        for dist in ('studentt', 'gaussian'):
            outs = fn(post, log_w, parts, dist)
            assert [o.shape[0] for o in outs] == [4, 3, 0]
            whole = fn(post, log_w, [x], dist)[0]
            np.testing.assert_allclose(torch.cat(outs).numpy(),
                                       whole.numpy(), rtol=1e-12)
    # a one-point shard's layout has row stride 1 (x.T.contiguous() would
    # keep x.T's stride 2, which the kernels' checks refuse)
    one = cuda_predict.serve_shard(x[:1], lambda t: t)
    assert one.shape == (2, 1) and one.stride() == (1, 1)
    im = BayesianILR.make(size=4, input_dim=2, output_dim=1,
                          dtype=torch.float64, device='cpu')
    y = torch.randn((7, 1), generator=g, dtype=torch.float64)
    basis, experts = im.components_prior
    outs = cuda_ilr_predict.ilr_predict_cuda_sharded(
        basis, experts, log_w, parts, [y[:4], y[4:], y[7:]])
    whole = cuda_ilr_predict.ilr_predict_cuda(basis, experts, log_w, x, y)
    for i in range(3):
        np.testing.assert_allclose(
            torch.cat([o[i] for o in outs]).numpy(), whole[i].numpy(),
            rtol=1e-5)


# -- chains over a ('chain', 'data') mesh -------------------------------------------

@pytest.mark.parametrize('engine', ['fit_vi_fused', 'fit_map_fused',
                                    'fit_em_fused', 'fit_vi', 'fit_map',
                                    'fit_em', 'fit_svi'])
def test_fit_chains_over_a_chain_data_mesh(gmm_x, engine):
    """mimo_tpu's test_chain_and_data_axes_together: 4 keys over a (2, 4)
    mesh equal the unsharded fit_chains, and best_of picks the same
    chain; every engine runs each row's group batched over the row, one
    reduction a sweep. SVI draws a stratified minibatch a shard, so its
    chains are held against the fits with their keys over their row
    instead (rtol 1e-10)."""
    from mimo_tpu_torch.parallel import best_of
    m24 = make_mesh(n_chain=2, devices=CPU8)
    m = BayesianGMM.make(size=5, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    x = tt(gmm_x)
    keys = [9, 10, 11, 12]
    kw = (dict(maxiter=8) if engine != 'fit_svi'
          else dict(maxiter=20, step_size=0.3, batch_size=64))
    if engine == 'fit_svi':
        ref, ref_tr = tmix.stack_trees([
            m.fit_svi(shard_data(m24.row(i // 2), x), key=k,
                      mesh=m24.row(i // 2), **kw)
            for i, k in enumerate(keys)])
    else:
        ref, ref_tr = fit_chains(m, engine, x, keys, **kw)
    got, got_tr = fit_chains(m, engine, shard_data(m24, x), keys,
                             mesh=m24, **kw)
    np.testing.assert_allclose(got_tr.numpy(), ref_tr.numpy(), rtol=1e-10)
    leaves_close(got, state_to_numpy(ref),
                 1e-10 if engine == 'fit_svi' else 1e-9)
    if engine in ('fit_vi_fused', 'fit_vi'):
        assert int(best_of(got, got_tr)[1]) == int(best_of(ref, ref_tr)[1])


def test_fit_chains_gibbs_labels_stay_on_their_row(gmm_x):
    m24 = make_mesh(n_chain=2, devices=CPU8)
    m = BayesianGMM.make(size=5, dim=2, dtype=torch.float64, device='cpu')
    gs = fit_chains(m, 'fit_gibbs_fused', tt(gmm_x), [1, 2, 3, 4],
                    mesh=m24, maxiter=3)
    assert gs.components.mu.shape == (4, 5, 2)
    assert gs.labels.positions == tuple(range(8))
    assert [s.shape for s in gs.labels.shards] == [(2, 400)] * 8
    with pytest.raises(ValueError, match='chain rows'):
        fit_chains(m, 'fit_vi_fused', tt(gmm_x), [1, 2, 3], mesh=m24)
    # an unknown engine still raises; the dense Gibbs runs batched over
    # its row, its labels on the row's shards
    with pytest.raises(ValueError, match='unknown engine'):
        fit_chains(m, 'fit_no_such_engine', tt(gmm_x), [1, 2], mesh=m24)
    dg = fit_chains(m, 'fit_gibbs', tt(gmm_x), [1, 2, 3, 4], mesh=m24,
                    maxiter=2)
    assert dg.components.mu.shape == (4, 5, 2)
    assert [s.shape for s in dg.labels.shards] == [(2, 400)] * 8


# -- the dense engines over a mesh ---------------------------------------

DENSE = [(e, name) for name in ('dpgmm', 'diag', 'ilr1', 'ilr3', 'nested')
         for e in ('fit_vi', 'fit_map', 'fit_em')]


@pytest.mark.parametrize('engine,name', DENSE)
def test_dense_engines_match_jax_and_unsharded(monkeypatch, gmm_x, ilr_xy,
                                               mesh8, engine, name):
    """mimo_tpu's test_vi_sharded_equals_replicated and test_ilr_sharded_vi
    for each dense engine, flat and nested: 5 sweeps through
    data_parallel_fit over 8 shards of 200 points from JAX's random or
    anchor start (handed to the port): the trace and the final state
    against mimo_tpu's data_parallel_fit (rtol 1e-9) and against the
    port's unsharded fit from the same key (rtol 1e-10)."""
    jm, tm, dj, dt, k = make_pair(name, gmm_x, ilr_xy)
    shared_start(monkeypatch, name, k)
    st_j, tr_j = jmesh.data_parallel_fit(jm, engine, dj,
                                         mesh=jmesh.make_mesh(), key=1,
                                         maxiter=5)
    st_t, tr_t = data_parallel_fit(tm, engine, dt, mesh=mesh8, key=1,
                                   maxiter=5)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-9)
    leaves_close(st_t, st_j, 1e-9)
    st_u, tr_u = getattr(tm, engine)(dt, key=1, maxiter=5)
    np.testing.assert_allclose(tr_t.numpy(), tr_u.numpy(), rtol=1e-10)
    leaves_close(st_t, state_to_numpy(st_u), 1e-10)


@pytest.mark.parametrize('n', [N, 5])
def test_dense_vi_with_weights_and_a_warm_start(gmm_x, mesh8, n):
    """Point weights split as the data, a warm start from a state, and
    N = 5 over 8 positions (three empty): the sharded dense VI equals the
    unsharded one (rtol 1e-10), `tol` stopping at the same sweep."""
    m = BayesianGMM.make(size=4, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    x = tt(gmm_x[:n])
    w = torch.linspace(0.5, 1.5, n, dtype=torch.float64)
    st0, _ = m.fit_vi(x, key=2, maxiter=2)
    for kw in (dict(key=3, point_weights=w),
               dict(init_state=st0, randomize=False, tol=1e-6)):
        a, ta = m.fit_vi(x, maxiter=12, mesh=mesh8, **kw)
        b, tb = m.fit_vi(x, maxiter=12, **kw)
        np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=1e-10)
        leaves_close(a, state_to_numpy(b), 1e-10)


@pytest.mark.parametrize('name,init_labels,chains', [
    ('dpgmm', 'prior', False), ('dpgmm', 'random', False),
    ('dpgmm', 'prior', True), ('ilr1', 'prior', False)])
def test_one_position_dense_gibbs_is_the_unsharded_chain(gmm_x, ilr_xy, name,
                                                         init_labels, chains):
    """Over a one-position mesh the dense Gibbs chain is the mesh=None
    chain draw for draw: labels, every state leaf and the loglik trace
    bitwise (data shard 0 draws its labels from the fit's generator)."""
    _, tm, _, dt, _ = make_pair(name, gmm_x, ilr_xy)
    one = make_mesh(devices=['cpu'])
    key = [2, 5] if chains else 2
    kw = dict(key=key, maxiter=4, init_labels=init_labels, chains=chains,
              track_loglik=True)
    g0, l0 = tm.fit_gibbs(dt, **kw)
    g1, l1 = tm.fit_gibbs(dt, mesh=one, **kw)
    assert torch.equal(l1, l0)
    assert isinstance(g1.labels, Sharded)
    assert torch.equal(g1.labels.gather(-1), g0.labels)
    for a, b in zip(jax.tree.leaves(state_to_numpy(g1[:4])),
                    jax.tree.leaves(state_to_numpy(g0[:4]))):
        np.testing.assert_array_equal(a, b)
    # and a chain continued from its state
    key = [7, 8] if chains else 7
    more0 = tm.fit_gibbs(dt, key=key, maxiter=2, init_state=g0,
                         chains=chains)
    more1 = tm.fit_gibbs(dt, key=key, maxiter=2, init_state=g1,
                         chains=chains, mesh=one)
    assert torch.equal(more1.labels.gather(-1), more0.labels)


def test_nested_dense_gibbs_over_a_mesh(gmm_x, mesh8):
    """The nested dense Gibbs over a one-position mesh is the unsharded
    chain draw for draw; over 8 shards its outer labels stay on their
    shards and every state leaf is finite; fit_chains runs it chain by
    chain over each row of a (2, 4) mesh."""
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **NESTED)
    x = tt(gmm_x)
    g0 = tm.fit_gibbs(x, key=4, maxiter=3)
    g1 = tm.fit_gibbs(x, key=4, maxiter=3, mesh=make_mesh(devices=['cpu']))
    assert torch.equal(g1.labels.gather(), g0.labels)
    for a, b in zip(jax.tree.leaves(state_to_numpy(g1[:3])),
                    jax.tree.leaves(state_to_numpy(g0[:3]))):
        np.testing.assert_array_equal(a, b)
    g8 = data_parallel_fit(tm, 'fit_gibbs', x, mesh=mesh8, key=4, maxiter=3)
    assert [s.shape for s in g8.labels.shards] == [(200,)] * 8
    assert all(np.isfinite(t).all()
               for t in jax.tree.leaves(state_to_numpy(g8[:3])))
    m24 = make_mesh(n_chain=2, devices=CPU8)
    gc = fit_chains(tm, 'fit_gibbs', x, [1, 2, 3, 4], mesh=m24, maxiter=2)
    assert [s.shape for s in gc.labels.shards] == [(2, 400)] * 8
    vc, tr = fit_chains(tm, 'fit_vi', shard_data(m24, x), [1, 2, 3, 4],
                        mesh=m24, maxiter=3, maxsubiter=2)
    vu, tu = fit_chains(tm, 'fit_vi', x, [1, 2, 3, 4], maxiter=3,
                        maxsubiter=2)
    np.testing.assert_allclose(tr.numpy(), tu.numpy(), rtol=1e-10)
    leaves_close(vc, state_to_numpy(vu), 1e-9)


def blobs4096(seed):
    rng = np.random.default_rng(seed)
    c = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    return tt(c[rng.choice(3, 4096, p=[.3, .4, .3])]
              + rng.standard_normal((4096, 2)) / np.sqrt(2.0))


def test_dense_gibbs_over_eight_shards_recovers_the_mass(mesh8):
    """mimo_tpu's test_gibbs_sharded_runs through data_parallel_fit: 60
    sweeps over 4096 points; the labels stay on their shards."""
    x = blobs4096(0)
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    st, ll = data_parallel_fit(m, 'fit_gibbs', x, mesh=mesh8, key=2,
                               maxiter=60, track_loglik=True)
    assert [s.shape[0] for s in st.labels.shards] == [512] * 8
    counts = np.bincount(st.labels.gather().numpy(), minlength=8)
    assert counts.sum() == 4096
    assert np.sort(counts)[-4:].sum() > 0.8 * 4096
    assert ll.shape == (60,) and bool(torch.isfinite(ll).all())
    assert bool(torch.isfinite(st.components.mu).all())


def test_dense_gibbs_chains_over_a_chain_data_mesh():
    """fit_chains of the dense Gibbs over a (2, 4) mesh: each row's two
    chains run batched over its four shards, and every chain recovers the
    mass as the unsharded fit_chains' chains do."""
    x = blobs4096(1)
    m24 = make_mesh(n_chain=2, devices=CPU8)
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    keys = [3, 4, 5, 6]
    got = fit_chains(m, 'fit_gibbs', shard_data(m24, x), keys, mesh=m24,
                     maxiter=40)
    ref = fit_chains(m, 'fit_gibbs', x, keys, maxiter=40)
    assert got.components.mu.shape == ref.components.mu.shape == (4, 8, 2)
    rows = [got.labels.on(m24.row(g)).gather(-1) for g in (0, 1)]
    assert [r.shape for r in rows] == [(2, 4096)] * 2
    for chain in torch.cat(rows + [ref.labels]):
        counts = np.bincount(chain.numpy(), minlength=8)
        assert np.sort(counts)[-4:].sum() > 0.8 * 4096


# -- empty and short shards -----------------------------------------------------------

@pytest.mark.parametrize('n', [5, 1599])
def test_empty_and_short_shards(gmm_x, mesh8, n):
    """N = 5 on 8 shards (three empty) and an N that 8 does not divide:
    VI and MAP-EM equal the unsharded fits; Gibbs over one shard's worth
    of each gives finite states and N labels."""
    m = BayesianGMM.make(size=3, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    x = tt(gmm_x[:n])
    for engine in ('fit_em_fused', 'fit_map_fused', 'fit_vi_fused'):
        st, tr = getattr(m, engine)(x, key=3, maxiter=4, mesh=mesh8)
        st0, tr0 = getattr(m, engine)(x, key=3, maxiter=4)
        np.testing.assert_allclose(tr.numpy(), tr0.numpy(), rtol=1e-10)
        leaves_close(st, state_to_numpy(st0), 1e-9)
    gs = m.fit_gibbs_fused(x, key=1, maxiter=3, mesh=mesh8)
    assert gs.labels.gather().shape == (n,)
    assert bool(torch.isfinite(gs.components.mu).all())
    lp = m.log_predictive(st, x, mesh=mesh8)
    np.testing.assert_allclose(lp.gather().numpy(),
                               m.log_predictive(st, x).numpy(), rtol=1e-12)


# -- the communication contract ---------------------------------------------------------

def test_communication_contract_one_reduction_a_sweep(mesh8):
    """The counterpart of mimo_tpu's test_communication_contract_vi_gibbs_
    svi: every sweep of VI, Gibbs, MAP, ML-EM and SVI makes exactly one
    reduction of K m8 + 1 floats, the same at two N; the starts reduce
    their statistics apart ('start'); serving reduces nothing."""
    k, m8 = 8, 8                                 # d = 2: m = 7
    m = BayesianGMM.make(size=k, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    rng = np.random.default_rng(0)
    per_call = {}
    for n in (4096, 8192):
        x = shard_data(mesh8, tt(rng.normal(size=(n, 2))))
        for engine, kw in (('fit_vi_fused', {}), ('fit_gibbs_fused', {}),
                           ('fit_map_fused', {}), ('fit_em_fused', {}),
                           ('fit_svi', dict(batch_size=512))):
            tmesh.reset_counters()
            out = getattr(m, engine)(x, key=1, maxiter=3, mesh=mesh8, **kw)
            sweep = tmesh.counters['sweep']
            assert sweep['calls'] == 3, engine
            assert sweep['all_reduce'] == 0     # one process: no collective
            per_call.setdefault(engine, set()).add(sweep['floats'] // 3)
            assert sweep['floats'] == 3 * (k * m8 + 1)
        tmesh.reset_counters()
        st = out[0]
        m.log_predictive(st, x, mesh=mesh8)
        assert all(c['calls'] == 0 for c in tmesh.counters.values())
    assert all(len(v) == 1 for v in per_call.values())


def test_dense_sweeps_make_one_reduction_each(mesh8):
    """The dense engines over a mesh: one reduction a sweep of the same
    size at two N; the starts' apart (VI two, MAP-EM one, ML-EM's anchors
    three, Gibbs one), and no all_reduce in one process."""
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0, kappa=0.05,
                         psi_scale=0.5, dtype=torch.float64, device='cpu')
    rng = np.random.default_rng(0)
    starts = {'fit_vi': 2, 'fit_map': 1, 'fit_em': 3, 'fit_gibbs': 1}
    per_call = {}
    for n in (4096, 8192):
        x = shard_data(mesh8, tt(rng.normal(size=(n, 2))))
        for engine, start in starts.items():
            tmesh.reset_counters()
            getattr(m, engine)(x, key=1, maxiter=3, mesh=mesh8)
            sweep = tmesh.counters['sweep']
            assert sweep['calls'] == 3 and sweep['all_reduce'] == 0, engine
            assert tmesh.counters['start']['calls'] == start, engine
            per_call.setdefault(engine, set()).add(sweep['floats'] // 3)
    assert all(len(v) == 1 for v in per_call.values())


@pytest.mark.parametrize('maxsubiter', [1, 3])
def test_nested_dense_sweeps_count_their_inner_rounds(gmm_x, mesh8,
                                                      maxsubiter):
    """A nested dense sweep over a mesh: VI makes maxsubiter + 1
    reductions (one an inner round, one of its log-likelihood), MAP-EM
    and ML-EM maxsubiter + 2 (maxsubiter + 1 M-steps and the
    log-likelihood), Gibbs maxsubiter (one an inner round, the outer
    counts riding on the first); no all_reduce in one process."""
    tm = BayesianMixtureOfMixtures.make_gmm(dtype=torch.float64,
                                            device='cpu', **NESTED)
    x = shard_data(mesh8, tt(gmm_x))
    for engine, per in (('fit_vi', maxsubiter + 1),
                        ('fit_map', maxsubiter + 2),
                        ('fit_em', maxsubiter + 2),
                        ('fit_gibbs', maxsubiter)):
        tmesh.reset_counters()
        getattr(tm, engine)(x, key=1, maxiter=3, maxsubiter=maxsubiter,
                            mesh=mesh8)
        sweep = tmesh.counters['sweep']
        assert sweep['calls'] == 3 * per, engine
        assert sweep['all_reduce'] == 0
