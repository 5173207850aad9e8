"""The system under test: the port, mimo_tpu_torch, imported from the
checkout. This is the one module of the benchmark that imports it; it
hands the port the benchmark's inputs and returns the port's outputs as
plain tensors."""

import importlib

import torch

from harness.env import ROOT


def import_port():
    """Import mimo_tpu_torch and make sure it is the checkout's copy."""
    port = importlib.import_module('mimo_tpu_torch')
    path = getattr(port, '__file__', None) or ''
    if not path.startswith(str(ROOT) + '/'):
        raise ImportError(f'mimo_tpu_torch from {path!r}, not from the '
                          f'checkout at {ROOT}')
    return port


class Port:
    """One configuration's model on `device`, with the calls the traffic
    mixes make."""

    def __init__(self, config, device):
        import_port()
        from mimo_tpu_torch.distributions.gating import StickBreaking
        from mimo_tpu_torch.distributions.niw import NIW
        from mimo_tpu_torch.models import BayesianGMM
        from mimo_tpu_torch.models.mixture import MFState
        from mimo_tpu_torch.parallel import fit_chains
        if config['model'] != 'BayesianGMM':
            raise NotImplementedError(config['model'])
        if torch.backends.cuda.matmul.allow_tf32 != config['tf32']:
            raise RuntimeError(
                f"the port runs float32 products with TF32 "
                f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}; "
                f"the configuration states tf32={config['tf32']}")
        self._niw, self._sb, self._state = NIW, StickBreaking, MFState
        self._fit_chains = fit_chains
        self.device = device
        self.dtype = getattr(torch, config['dtype'])
        self.model = BayesianGMM.make(**config['make'], dtype=self.dtype,
                                      device=device)

    def state(self, post, chain=None):
        """The port's MFState of a benchmark posterior dict (C, K, ...),
        or of its chain `chain` alone."""
        p = post if chain is None else {k: v[chain] for k, v in post.items()}
        p = {k: v.to(self.dtype) for k, v in p.items()}
        return self._state(self._niw(p['mu'], p['kappa'], p['psi'],
                                     p['nu']),
                           self._sb(p['gamma'], p['delta']))

    def fit(self, engine, x, keys, maxiter, start=None):
        """One call of `engine` over the chains' keys; with `start` (C, K,
        ...) every chain from its start (randomize=False). A single chain
        calls the engine itself, more go through fit_chains. Returns the
        engine's result as the benchmark's dict of tensors with a chain
        axis."""
        kw = {} if start is None else dict(randomize=False)
        x = x.to(self.dtype)
        if len(keys) == 1:
            if start is not None:
                kw['init_state'] = self.state(start, 0)
            out = getattr(self.model, engine)(x, key=keys[0],
                                              maxiter=maxiter, **kw)
        else:
            if start is not None:
                kw['init_state'] = self.state(start)
            out = self._fit_chains(self.model, engine, x, list(keys),
                                   maxiter=maxiter, **kw)
        return self.unpack(out, chains=len(keys) > 1)

    @staticmethod
    def unpack(out, chains):
        def lead(t):
            return t if chains else t[None]
        if isinstance(out, tuple) and len(out) == 2 and not hasattr(
                out, '_fields'):                    # (MFState, trace)
            st, trace = out
            comp, gating = st.components, st.gating
            return dict(mu=lead(comp.mu), kappa=lead(comp.kappa),
                        psi=lead(comp.psi), nu=lead(comp.nu),
                        gamma=lead(gating.gamma), delta=lead(gating.delta),
                        trace=lead(trace))
        comp, gating = out.components, out.gating   # GibbsState
        return dict(mu=lead(comp.mu), kappa=lead(comp.kappa),
                    psi=lead(comp.psi), nu=lead(comp.nu),
                    gamma=lead(gating.gamma), delta=lead(gating.delta),
                    p_mu=lead(out.params.mu), p_lmbda=lead(out.params.lmbda),
                    log_pi=lead(out.log_pi), labels=lead(out.labels))

    def serve(self, state, x, dist):
        """log_predictive of points x (n, d) under the port's MFState."""
        return self.model.log_predictive(state, x.to(self.dtype), dist=dist)
