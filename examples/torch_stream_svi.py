"""Out-of-core stochastic VI with the PyTorch port: a DP-GMM trained from
a binary file streamed by the native loader, never holding the full
dataset in device memory (the recipe of examples/stream_svi.py).

    python examples/torch_stream_svi.py [--cpu] [--n N] [--steps S]

  1. write the dataset in the 16-byte-header binary format
     (mimo_tpu_torch.io.write_bin);
  2. MmapDataset serves shuffled minibatches, read on a host thread;
  3. fit_svi_stream runs one natural-gradient step per batch (the
     Robbins-Monro step via --forgetting), then fit_vi_stream_full
     polishes with full-data sweeps, a block of the file at a time
     through kernel B1 on the card.

Runs on the card unless --cpu asks for the CPU.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from mimo_tpu_torch.distributions.niw import GaussParams  # noqa: E402
from mimo_tpu_torch.io import MmapDataset, write_bin  # noqa: E402
from mimo_tpu_torch.models import BayesianGMM  # noqa: E402
from mimo_tpu_torch.models.mixture import MFState  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=1337)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    ap.add_argument('--n', type=int, default=200_000, help='dataset size')
    ap.add_argument('--batch', type=int, default=4096, help='minibatch size')
    ap.add_argument('--steps', type=int, default=400, help='SVI steps')
    ap.add_argument('--step-size', type=float, default=0.7,
                    help='initial step size')
    ap.add_argument('--forgetting', type=float, default=0.6,
                    help='Robbins-Monro exponent (0 = fixed step)')
    args = ap.parse_args()
    dev = torch.device('cpu' if args.cpu else 'cuda')

    # a 4-component GMM dataset, written as a binary file
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    true_mu = torch.tensor([[-5., 0.], [5., 0.], [0., 5.], [0., -5.]],
                           device=dev)
    true_lm = torch.eye(2, device=dev).expand(4, 2, 2) * 1.5
    x, _ = BayesianGMM.generate(gen, GaussParams(true_mu, true_lm),
                                [.25, .25, .25, .25], args.n)
    path = os.path.join(tempfile.gettempdir(),
                        f'torch_stream_svi_{os.getpid()}.bin')
    write_bin(path, x.cpu().numpy())
    del x
    ds = MmapDataset(path)
    try:
        print(f'dataset: {ds.shape[0]} rows x {ds.shape[1]} cols '
              f'({os.path.getsize(path) / 1e6:.1f} MB on disk, '
              f'{ds.backend} loader)')
        model = BayesianGMM.make(size=16, dim=2, gating='dp', alpha=1.0,
                                 kappa=0.05, psi_scale=0.5, device=dev)
        rng = np.random.default_rng(args.seed)
        # break the symmetric start: Gibbs on an in-memory probe subset,
        # then stream the whole file through SVI
        init_batch = torch.from_numpy(
            ds.sample(rng, min(16384, ds.shape[0]))).to(dev)
        g = model.fit_gibbs(init_batch, key=args.seed, maxiter=20,
                            init_labels='random')
        state = model.fit_svi_stream(
            lambda i: ds.sample(rng, args.batch), total_size=ds.shape[0],
            key=args.seed, maxiter=args.steps, step_size=args.step_size,
            batch_size=args.batch,
            init_state=MFState(g.components, g.gating),
            forgetting=args.forgetting or None)

        probe = torch.from_numpy(ds.sample(rng, 8192)).to(dev)
        used = model.used_labels(state, probe)
        elbo = float(model.elbo(state, (probe,),
                                model.expected_responsibilities(
                                    state, (probe,))))

        def recovery(st):
            return float(torch.cdist(true_mu, st.components.mu).min(1)
                         .values.max())

        err = recovery(state)
        print(f'probe ELBO {elbo:.6g} | used components {int(used.sum())} '
              f'| max mean-recovery error {err:.3f}')
        if not (np.isfinite(elbo) and err < 0.5):
            raise SystemExit('streaming SVI failed to recover the means')

        # polish with full-data sweeps, one pass over the file each
        bb = max(4096, ds.shape[0] // 8)
        nb = -(-ds.shape[0] // bb)
        state2, trace = model.fit_vi_stream_full(
            lambda i: ds.read_block(i * bb, bb), nb, init_state=state,
            maxiter=10)
        err2 = recovery(state2)
        print(f'full-data streamed VI polish: ELBO {float(trace[-1]):.6g} '
              f'(rising: {bool(trace[1] < trace[-1])}) | max recovery '
              f'error {err2:.3f}')
        if not (bool(torch.isfinite(trace).all()) and err2 < 0.5):
            raise SystemExit('the streamed full-data polish failed')
        print('OK')
    finally:
        ds.close()
        os.unlink(path)


if __name__ == '__main__':
    main()
