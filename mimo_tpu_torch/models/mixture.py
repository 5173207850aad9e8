"""Bayesian mixture engine: fused mean-field VI, fused blocked Gibbs and
the posterior predictive over a conjugate Family (port of the main-path
slice of mimo_tpu/models/mixture.py).

Update-rule contract:
  Gibbs  : post = prior (+) stats(one-hot);   params ~  post
  VI     : post = prior (+) stats(resp)

Backends. Each fused engine and `log_predictive` takes `backend`:
  'auto'   — the CUDA kernel when the data lies on a CUDA device, the plain
             PyTorch version when it lies on the CPU;
  'kernel' — the CUDA kernel; raises for CPU data;
  'torch'  — the plain PyTorch version wherever the data lies.
No path runs the plain version for CUDA data unless 'torch' asks for it:
if a kernel cannot build or launch, the call raises.
"""

from typing import Any, NamedTuple

import torch

from mimo_tpu_torch.conjugate.families import Family
from mimo_tpu_torch.utils.sanitize import finite_report

BACKENDS = ('auto', 'kernel', 'torch')


class MFState(NamedTuple):
    """Mean-field state: the variational posterior."""
    components: Any          # family posterior struct (K-batched)
    gating: Any              # Dirichlet or StickBreaking posterior


class GibbsState(NamedTuple):
    """Blocked-Gibbs state: current conditionals + sampled likelihood params."""
    components: Any          # component posterior (conditional on labels)
    gating: Any              # gating posterior (conditional on labels)
    params: Any              # sampled likelihood params
    log_pi: torch.Tensor     # log of sampled mixture weights (K,)
    labels: torch.Tensor     # (N,) int32


def _elbo_loop(step, carry, maxiter, tol):
    """Run `carry, vlb = step(carry, i)` for up to `maxiter` sweeps and
    return (carry, (maxiter,) trace).

    With tol=None every sweep runs and the loop never waits for the
    device. With `tol` (the reference's stopping rule: |vlb_t - vlb_{t-1}|
    < tol after at least two sweeps) the host compares each sweep's ELBO
    and stops early; the trace is constant-extended past the stop. A NaN
    ELBO never satisfies the rule, so divergence keeps iterating."""
    trace = []
    for i in range(maxiter):
        if tol is not None and i >= 2 and bool(
                torch.abs(trace[-1] - trace[-2]) < tol):
            break
        carry, vlb = step(carry, i)
        trace.append(vlb)
    if not trace:
        return carry, torch.zeros((0,))
    trace = torch.stack(trace)
    if trace.shape[0] < maxiter:
        trace = torch.cat([trace, trace[-1].expand(maxiter - trace.shape[0])])
    return carry, trace


def resolve_backend(backend, x):
    """True -> run the CUDA kernel; False -> the plain PyTorch version
    (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend: {backend!r}; one of {BACKENDS}')
    if backend == 'kernel' and not x.is_cuda:
        raise ValueError("backend='kernel' needs the data on a CUDA device")
    return backend != 'torch' and x.is_cuda


def model_device(device):
    """The device a model's priors are built on: `device` when given,
    else the current CUDA device. Without a card that raises: pass
    device='cpu' to build on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: models are built on the card "
                           "by default; pass device='cpu' to build on the "
                           "CPU")
    return torch.device('cuda', torch.cuda.current_device())


def kernel_xts(data):
    """The kernels' layout, made once outside the sweep loop: the data
    arrays transposed and stacked into one contiguous float32
    (sum d_i, N) buffer ([x; y] for ILR), returned as its per-input
    (d_i, N) row blocks. The kernels read the buffer whole and
    bound-check the point index against N, so no padding is needed."""
    buf = torch.cat([a.to(torch.float32).T for a in data]).contiguous()
    return tuple(torch.split(buf, [a.shape[1] for a in data]))


def _cast(tree, dtype):
    """Cast the floating leaves of a tree of NamedTuples and tuples (the
    statistics of a product family) to `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    items = [_cast(t, dtype) for t in tree]
    return type(tree)(*items) if hasattr(tree, '_fields') else tuple(items)


class BayesianMixture:
    """A Bayesian mixture of `K` conjugate-family components with a
    Dirichlet or stick-breaking (DP) gating prior. `self` holds the
    Family's functions and the prior tensors; every fit is a function of
    (priors, data, generator)."""

    def __init__(self, gating_prior, components_prior, family: Family):
        self.gating_prior = gating_prior
        self.components_prior = components_prior
        self.family = family
        self.size = gating_prior.dim

    def _mf_update(self, data, resp) -> MFState:
        """Posterior from responsibilities resp (N, K)."""
        stats = self.family.suff_stats(data, resp)
        return MFState(
            components=self.family.update(self.components_prior, stats),
            gating=self.gating_prior.update(torch.sum(resp, 0)))

    def _estep_spec(self):
        """EStepSpec for the fused engines; None when the family has none.
        Overridden by concrete models."""
        return None

    def fit_vi_fused(self, data, key=None, maxiter=250, tol=None,
                     block_size=131072, init_state=None, randomize=True,
                     backend='auto'):
        """Mean-field VI with the fused E-step (kernel B1 on CUDA, over
        the family's feature map): the N x K responsibilities never
        exist. The ELBO trace reports
        ELBO(state_t) exactly (lse identity). `tol` stops early once
        |dELBO| < tol. `key`: an int seed or a torch.Generator on the
        data's device. The kernel runs in float32; its statistics are cast
        back to the data's dtype. Returns (MFState, vlb trace)."""
        from mimo_tpu_torch.ops.cuda_estep import fused_estep_cuda
        from mimo_tpu_torch.ops.family_estep import fused_estep_blockwise
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError('no fused E-step spec for this family')
        data = _as_tuple(data)
        x0 = data[0]
        n, dtype = x0.shape[0], x0.dtype
        use_kernel = resolve_backend(backend, x0)
        gen = _as_generator(key, x0.device)
        if randomize or init_state is None:
            state = self._mf_update(
                data, _random_resp(gen, n, self.size, dtype, x0.device))
        else:
            state = init_state
        xts = kernel_xts(data) if use_kernel else None

        def step(state, _):
            log_pi = state.gating.expected_log_pi()
            if use_kernel:
                res = _cast(fused_estep_cuda(spec, state.components, log_pi,
                                             xts, n), dtype)
            else:
                res = fused_estep_blockwise(spec, state.components, log_pi,
                                            data, block_size)
            vlb = (res.lse
                   - torch.sum(self.family.kl(state.components,
                                              self.components_prior))
                   - torch.sum(state.gating.kl_divergence(self.gating_prior)))
            new = MFState(
                components=self.family.update(self.components_prior,
                                              res.stats),
                gating=self.gating_prior.update(res.counts))
            return new, vlb

        return finite_report(_elbo_loop(step, state, maxiter, tol),
                             'fit_vi_fused')

    def fit_gibbs_fused(self, data, key=None, maxiter=100, block_size=131072,
                        backend='auto'):
        """Blocked Gibbs with the fused label sweep (kernel B2 on CUDA):
        plug-in log-densities, Gumbel-max labels from Philox keyed by
        (sweep seed, point index), and one-hot statistics; the N x K
        log-probs never exist. Per-sweep seeds come from the engine's
        generator and stay on the device. A family with a `gibbs_update`
        hook draws its posterior and params after the label sweep, from
        the statistics (the sweep then uses the previous params). Returns
        the final GibbsState."""
        from mimo_tpu_torch.ops.cuda_gibbs import fused_gibbs_cuda
        from mimo_tpu_torch.ops.family_estep import fused_gibbs_blockwise
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError('no fused Gibbs spec for this family')
        data = _as_tuple(data)
        x0 = data[0]
        n, dtype, dev = x0.shape[0], x0.dtype, x0.device
        use_kernel = resolve_backend(backend, x0)
        gen = _as_generator(key, dev)
        comp, gating = self.components_prior, self.gating_prior
        params = self.family.mode_params(comp)
        log_pi = torch.log(torch.full((self.size,), 1.0 / self.size,
                                      dtype=dtype, device=dev))
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
        seeds = torch.randint(0, 2 ** 62, (maxiter,), generator=gen,
                              dtype=torch.int64, device=dev)
        xts = kernel_xts(data) if use_kernel else None
        gibbs_update = self.family.gibbs_update
        for i in range(maxiter):
            if gibbs_update is None:
                params = self.family.sample_params(gen, comp)
            log_pi = torch.log(torch.clamp(gating.sample(gen), min=1e-37))
            if use_kernel:
                labels, res = fused_gibbs_cuda(spec, seeds[i], params,
                                               log_pi, xts, n)
                res = _cast(res, dtype)
            else:
                labels, res = fused_gibbs_blockwise(spec, seeds[i], params,
                                                    log_pi, data, block_size)
            if gibbs_update is None:
                comp = self.family.update(self.components_prior, res.stats)
            else:
                comp, params = gibbs_update(gen, self.components_prior,
                                            res.stats)
            gating = self.gating_prior.update(res.counts)
        return finite_report(
            GibbsState(components=comp, gating=gating, params=params,
                       log_pi=log_pi, labels=labels), 'fit_gibbs_fused')

    # -- prediction ----------------------------------------------------------

    def predictive_log_weights(self, state: MFState):
        """log E_q[pi] — posterior-mean mixture weights."""
        return torch.log(torch.clamp(state.gating.mean(), min=1e-37))

    def log_predictive(self, state: MFState, data, dist='studentt',
                       backend='auto'):
        """Posterior-predictive mixture log-density of full observations:
        logsumexp_k [log E[pi_k] + log pred_k(data)] -> (N,). `dist`:
        'studentt' or the moment-matched 'gaussian'. The kernel path
        serves NIW and HierTied posteriors through B3 (a HierTied
        posterior's predictive is the same Student-t surface with the
        shared hyper scale) and NG posteriors through B4 (Student-t) or
        B3 over the diagonal map (Gaussian), in float32, and casts the
        result back to the data's dtype; the plain path is the dense
        (N, K) computation."""
        from mimo_tpu_torch.distributions.hierarchical import HierTied
        from mimo_tpu_torch.distributions.ng import NG
        from mimo_tpu_torch.distributions.niw import NIW
        from mimo_tpu_torch.ops.cuda_diag_predict import diag_predictive_cuda
        from mimo_tpu_torch.ops.cuda_predict import gauss_predictive_cuda
        if dist not in ('studentt', 'gaussian'):
            raise ValueError(f'unknown dist: {dist!r}')
        data = _as_tuple(data)
        x = data[0]
        log_w = self.predictive_log_weights(state)
        if resolve_backend(backend, x):
            kernels = {NIW: gauss_predictive_cuda,
                       HierTied: gauss_predictive_cuda,
                       NG: diag_predictive_cuda}
            serve = kernels.get(type(state.components))
            if serve is None:
                raise NotImplementedError(
                    'no serving kernel for '
                    f'{type(state.components).__name__} posteriors; use '
                    "backend='torch'")
            return serve(state.components, log_w, x.to(torch.float32),
                         dist).to(x.dtype)
        lp = (self.family.log_predictive(state.components, data)
              if dist == 'studentt'
              else self.family.log_predictive_gaussian(state.components,
                                                       data))
        return torch.logsumexp(lp + log_w[None, :], -1)


def _as_tuple(data):
    return data if isinstance(data, tuple) else (data,)


def _as_generator(key, device):
    """A torch.Generator on `device` from an int seed (None -> 0), or the
    given generator after checking its device."""
    if isinstance(key, torch.Generator):
        if key.device.type != torch.device(device).type:
            raise ValueError(f'generator on {key.device}, data on {device}')
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


def _random_resp(gen, n, k, dtype, device):
    """Random normalized responsibilities, uniform in [1e-3, 1) before
    normalizing, made in place on the data's device."""
    r = torch.rand((n, k), generator=gen, dtype=dtype, device=device)
    r.mul_(1.0 - 1e-3).add_(1e-3)
    return r.div_(torch.sum(r, -1, keepdim=True))
