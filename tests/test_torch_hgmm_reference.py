"""The hierarchical DP-GMM of the port against the benchmark's plain
reference (portbench/reference/hgmm.py), on the CPU and without JAX: the
fused VI fit from an anchor start, its ELBO trace and every posterior
leaf, in float64 and in float32 (where the reference's TF32 control must
fail); the inner rounds' counter (`hierarchical.counts`) and span
(`mimo.algebra.hyper`), one chain and chains batched under vmap; and the
reference's imports."""

import ast
import sys
from pathlib import Path

import pytest
import torch

from mimo_tpu_torch.distributions import hierarchical
from mimo_tpu_torch.distributions.gating import StickBreaking
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.niw import NIW
from mimo_tpu_torch.models import BayesianGMM
from mimo_tpu_torch.models.mixture import MFState
from mimo_tpu_torch.parallel import fit_chains
from mimo_tpu_torch.utils import logging

BENCH = Path(__file__).resolve().parents[1] / 'portbench'
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import hgmm  # noqa: E402

torch.set_num_threads(1)
MAKE = dict(size=6, dim=2, gating='dp', hierarchical=True, maxsubiter=25,
            alpha=1.0, kappa=0.05, psi_scale=0.5)
N, SWEEPS = 3000, 10
# float64: the port and the reference share the equations but not their
# order (the reference forms the hyper update's data term centred, the
# port as the upstream's sum); at N=3,000 the two read ~1e-14 apart.
RTOL_F64 = 1e-8
# float32: the port's ELBO reads ~4e-7 and its worst leaf ~5e-6 from the
# float64 reference; the reference in TF32 ~2e-3 and ~6e-3.
ELBO_F32, LEAF_F32 = 1e-5, 1e-4


def blobs(seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    c = torch.tensor([[-3., 0.], [3., 0.], [0., 4.]], dtype=torch.float64)
    x = c[torch.arange(N) % 3] + 0.7 * torch.randn(N, 2, generator=g,
                                                      dtype=torch.float64)
    return x.to(dtype)


def start(x, chains):
    return hgmm.anchor_start(x, MAKE, chains, torch.Generator().manual_seed(1),
                             sub=512)


def to_state(post, dtype, chain=None):
    """The port's MFState of a reference posterior (C, ...), or of its
    chain `chain`."""
    p = {k: (v if chain is None else v[chain]).to(dtype)
         for k, v in post.items()}
    hyper = NIW(mu=p['hyper_mu'][..., None, :],
                kappa=p['hyper_kappa'][..., None],
                psi=p['hyper_psi'][..., None, :, :],
                nu=p['hyper_nu'][..., None])
    return MFState(HierTied(hyper, p['mus'], p['kappas'], p['kappas0']),
                   StickBreaking(p['gamma'], p['delta']))


def leaves(st, chains):
    """The port's state as the reference's leaves (C, ...)."""
    c, g = st.components, st.gating
    h = c.hyper
    out = dict(hyper_mu=h.mu[..., 0, :], hyper_kappa=h.kappa[..., 0],
               hyper_psi=h.psi[..., 0, :, :], hyper_nu=h.nu[..., 0],
               mus=c.mus, kappas=c.kappas, kappas0=c.kappas0,
               gamma=g.gamma, delta=g.delta)
    return {k: v if chains else v[None] for k, v in out.items()}


def fit(x, dtype, chains=1, maxsubiter=25):
    """The port's fit_vi_fused from the anchor start: (leaves, trace
    (C, SWEEPS))."""
    m = BayesianGMM.make(**dict(MAKE, maxsubiter=maxsubiter), dtype=dtype,
                         device='cpu')
    s = start(x, chains)
    if chains == 1:
        st, tr = m.fit_vi_fused(x.to(dtype), key=0, maxiter=SWEEPS,
                                init_state=to_state(s, dtype, 0),
                                randomize=False)
        return leaves(st, False), tr[None]
    st, tr = fit_chains(m, 'fit_vi_fused', x.to(dtype), list(range(chains)),
                        maxiter=SWEEPS, init_state=to_state(s, dtype),
                        randomize=False)
    return leaves(st, True), tr


def reference(x, chains=1, mode='f64'):
    dt = torch.float64 if mode == 'f64' else torch.float32
    return hgmm.vi_fit(x, hgmm.make_prior(MAKE, 2, dt, 'cpu'),
                       start(x, chains), SWEEPS, mode=mode)


def gaps(post, trace, ref, ref_trace):
    """(the largest relative ELBO gap, the worst leaf's max |a - b| over
    its max |b|, chain by chain)."""
    elbo = ((trace.double() - ref_trace) / ref_trace.abs()).abs().max()
    worst = 0.0
    for key in hgmm.LEAVES:
        b = ref[key].double().reshape(ref[key].shape[0], -1)
        a = post[key].double().reshape(b.shape)
        worst = max(worst, float(((a - b).abs().amax(1)
                                  / b.abs().amax(1)).max()))
    return float(elbo), worst


@pytest.mark.parametrize('chains', [1, 2])
def test_port_matches_reference_f64(chains):
    """10 sweeps of fit_vi_fused on the plain path from the anchor start:
    the ELBO trace and every posterior leaf at rtol 1e-8; two chains run
    the update under vmap."""
    x = blobs()
    post, trace = fit(x, torch.float64, chains)
    ref, ref_trace = reference(x, chains)
    assert trace.shape == ref_trace.shape == (chains, SWEEPS)
    torch.testing.assert_close(trace, ref_trace, rtol=RTOL_F64, atol=0.0)
    for key in hgmm.LEAVES:
        torch.testing.assert_close(post[key], ref[key], rtol=RTOL_F64,
                                   atol=RTOL_F64 * float(ref[key].abs().max()),
                                   msg=key)
    assert bool((ref_trace[:, 1:] >= ref_trace[:, :-1] - 1e-9).all())


def test_float32_port_passes_where_tf32_fails():
    """The port in float32 stays within the tolerances of the float64
    reference; the reference with its per-point products in TF32 (the
    benchmark's control) does not."""
    x = blobs()
    ref, ref_trace = reference(x)
    elbo, leaf = gaps(*fit(x, torch.float32), ref, ref_trace)
    assert elbo < ELBO_F32 and leaf < LEAF_F32, (elbo, leaf)
    elbo_c, leaf_c = gaps(*reference(x, mode='tf32'), ref, ref_trace)
    assert elbo_c > 10 * ELBO_F32 and leaf_c > 10 * LEAF_F32, (elbo_c,
                                                                leaf_c)


@pytest.mark.parametrize('chains,maxsubiter', [(1, 25), (1, 7), (3, 25)])
def test_rounds_counter(chains, maxsubiter):
    """hierarchical.counts: one update a sweep, its maxsubiter rounds,
    counted once a call under vmap."""
    x = blobs(dtype=torch.float32)[:600]
    hierarchical.counts.update(rounds=0, updates=0)
    fit(x, torch.float32, chains, maxsubiter)
    assert hierarchical.counts == {'rounds': maxsubiter * SWEEPS,
                                   'updates': SWEEPS}


def test_svi_blend_counts_one_round():
    """fit_svi: the random start's full update, then one blend of one
    round a step."""
    m = BayesianGMM.make(**MAKE, dtype=torch.float64, device='cpu')
    hierarchical.counts.update(rounds=0, updates=0)
    m.fit_svi(blobs(), key=0, maxiter=5, step_size=0.5, batch_size=128)
    assert hierarchical.counts == {'rounds': 25 + 5, 'updates': 1 + 5}


def profiled_fit(x, chains):
    """The spans' (name, start, end) of a fit of 3 rounds an update under
    the profiler (fewer rounds, fewer events to collect)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, logging.spans():
        fit(x, torch.float64, chains, maxsubiter=3)
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith('mimo.')]


@pytest.mark.parametrize('chains', [1, 2])
def test_hyper_span_once_an_update_inside_posterior(chains):
    found = profiled_fit(blobs()[:600], chains)
    hyper = [(a, b) for name, a, b in found if name == 'mimo.algebra.hyper']
    posterior = [(a, b) for name, a, b in found
                 if name == 'mimo.algebra.posterior']
    assert len(hyper) == len(posterior) == SWEEPS
    for a, b in hyper:
        assert any(pa <= a and b <= pb for pa, pb in posterior), (a, b)


@pytest.mark.parametrize('chains', [1, 2])
def test_spans_change_no_bit(chains):
    """With the spans on the fit is bitwise the fit with them off."""
    x = blobs(dtype=torch.float32)
    off = fit(x, torch.float32, chains)
    with logging.spans():
        on = fit(x, torch.float32, chains)
    assert torch.equal(off[1], on[1])
    for key in hgmm.LEAVES:
        assert torch.equal(off[0][key], on[0][key]), key


def test_reference_imports_no_port():
    """reference/hgmm.py, and each reference module it imports, imports
    torch, math and the reference's own modules only."""
    seen, todo, allowed = set(), ['hgmm'], {'torch', 'math', 'reference'}
    while todo:
        name = todo.pop()
        seen.add(name)
        tree = ast.parse((BENCH / 'reference' / f'{name}.py').read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module] + [f'{node.module}.{a.name}'
                                        for a in node.names]
            else:
                continue
            for mod in mods:
                assert mod.split('.')[0] in allowed, (name, mod)
                parts = mod.split('.')
                if parts[0] == 'reference' and len(parts) == 2:
                    path = BENCH / 'reference' / f'{parts[1]}.py'
                    if path.is_file() and parts[1] not in seen:
                        todo.append(parts[1])
    assert {'hgmm', 'dpgmm', 'precision'} <= seen
