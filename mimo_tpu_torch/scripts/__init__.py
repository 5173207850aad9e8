"""Certification and study scripts of the port (counterparts of the JAX
repository's scripts/, under the same names): run each as
`python -m mimo_tpu_torch.scripts.<name>`. Importing a module here parses
no arguments and touches no device; `main(argv)` does."""
