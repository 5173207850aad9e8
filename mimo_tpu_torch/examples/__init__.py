"""The port's example drivers, one a JAX driver of `examples/`, each with
the JAX driver's name and output:

    python -m mimo_tpu_torch.examples.<name> [--cpu] [--x64] [--seed S]
                                              [--plot] [driver flags]

Each module's `main(argv=None)` parses `argv`, prints what the JAX
driver prints and returns a dict of those numbers. The drivers run on the
CUDA card unless `--cpu` is given (without a card they raise); `--x64`
runs in float64; `--plot` saves a PNG into the working directory and
needs matplotlib. Importing a driver runs nothing.
"""

DRIVERS = ('gauss', 'lingauss', 'dp_sticks', 'dpgmm', 'gmm_toy', 'ilr_sine',
           'ilr_eval', 'ilr_sinc_study', 'hgmm', 'hilr', 'chains_smc',
           'stream_svi')
