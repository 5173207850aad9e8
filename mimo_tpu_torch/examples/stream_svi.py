"""Out-of-core stochastic VI: a DP-GMM trained from a binary file streamed
by the native loader, never holding the full dataset in device memory
(the counterpart of examples/stream_svi.py).

    python -m mimo_tpu_torch.examples.stream_svi [--cpu] [--n N]
        [--batch B] [--steps S] [--plot]

  1. write the dataset in the 16-byte-header binary format
     (mimo_tpu_torch.io.write_bin) in the temp directory;
  2. MmapDataset serves shuffled minibatches, read on a host thread;
  3. a Gibbs start on an in-memory probe subset breaks the symmetric
     start, then fit_svi_stream runs one natural-gradient step per batch
     (the Robbins-Monro step via --forgetting);
  4. fit_vi_stream_full polishes with full-data sweeps, a block of the
     file at a time through kernel B1 on the card.
"""

import os
import tempfile

import numpy as np
import torch

from mimo_tpu_torch.examples._common import (
    check, generator, maybe_save_plot, setup)
from mimo_tpu_torch.utils.data import to_numpy


def main(argv=None):
    args, dev = setup('Out-of-core SVI DP-GMM via the native loader', argv,
                      n=(int, 200_000, 'dataset size'),
                      batch=(int, 4096, 'minibatch size'),
                      steps=(int, 400, 'SVI steps'),
                      step_size=(float, 0.7, 'initial step size'),
                      forgetting=(float, 0.6,
                                  'Robbins-Monro exponent (0 = fixed)'))
    from mimo_tpu_torch.distributions.niw import GaussParams
    from mimo_tpu_torch.io import MmapDataset, write_bin
    from mimo_tpu_torch.models.gmm import BayesianGMM
    from mimo_tpu_torch.models.mixture import MFState

    # a 4-component GMM dataset, written as a binary file
    dt = args.dtype
    true_mu = torch.tensor([[-5., 0.], [5., 0.], [0., 5.], [0., -5.]],
                           dtype=dt, device=dev)
    true_lm = torch.eye(2, dtype=dt, device=dev).expand(4, 2, 2) * 1.5
    x, _ = BayesianGMM.generate(generator(args, dev),
                                GaussParams(true_mu, true_lm),
                                [.25, .25, .25, .25], args.n)
    path = os.path.join(tempfile.gettempdir(),
                        f'stream_svi_{os.getpid()}.bin')
    write_bin(path, to_numpy(x).astype(np.float32))
    del x
    ds = MmapDataset(path)
    try:
        print(f'dataset: {ds.shape[0]} rows x {ds.shape[1]} cols '
              f'({os.path.getsize(path) / 1e6:.1f} MB on disk)')
        model = BayesianGMM.make(size=16, dim=2, gating='dp', alpha=1.0,
                                 kappa=0.05, psi_scale=0.5, dtype=dt,
                                 device=dev)
        rng = np.random.default_rng(args.seed)

        def rows(count):
            return torch.as_tensor(ds.sample(rng, count), dtype=dt,
                                   device=dev)

        # break the symmetric start: Gibbs on an in-memory probe subset,
        # then stream the whole file through SVI (host batches: the
        # stream stages them onto the device itself)
        g = model.fit_gibbs(rows(min(16384, ds.shape[0])), key=args.seed,
                            maxiter=20, init_labels='random')
        state = model.fit_svi_stream(
            lambda i: ds.sample(rng, args.batch), total_size=ds.shape[0],
            key=args.seed, maxiter=args.steps, step_size=args.step_size,
            batch_size=args.batch,
            init_state=MFState(g.components, g.gating),
            forgetting=args.forgetting or None)

        # evaluate on an in-memory probe subset
        probe = rows(8192)
        used = model.used_labels(state, probe)
        elbo = float(model.elbo(state, (probe,),
                                model.expected_responsibilities(
                                    state, (probe,))))

        def recovery(st):
            return float(torch.cdist(true_mu, st.components.mu).min(1)
                         .values.max())

        err = recovery(state)
        print(f'probe ELBO {elbo:.4g} | used components {int(used.sum())} '
              f'| max mean-recovery error {err:.3f}')
        check(np.isfinite(elbo) and err < 0.5,
              'streaming SVI failed to recover the means')

        # polish with full-data sweeps, one pass over the file each (the
        # last block may be short)
        bb = max(4096, ds.shape[0] // 8)
        nb = -(-ds.shape[0] // bb)
        state2, trace = model.fit_vi_stream_full(
            lambda i: ds.read_block(i * bb, bb), nb, init_state=state,
            maxiter=10)
        err2 = recovery(state2)
        print(f'full-data streamed VI polish: ELBO {float(trace[-1]):.6g} '
              f'(rising: {bool(trace[1] < trace[-1])}) | max recovery '
              f'error {err2:.3f}')
        check(bool(torch.isfinite(trace).all()) and err2 < 0.5,
              'the streamed full-data polish failed')
        print('OK')

        if args.plot:
            from mimo_tpu_torch.utils.plot import plot_mixture
            plot_mixture(probe, model.family.mean_params(state.components),
                         state.gating.mean())
            maybe_save_plot(args, 'stream_svi')
    finally:
        ds.close()
        os.unlink(path)
    return {'probe_elbo': elbo, 'used': int(used.sum()),
            'recovery_error': err, 'polish_elbo': float(trace[-1]),
            'polish_recovery_error': err2}


if __name__ == '__main__':
    main()
