"""The benchmark harness: one general driver for every cell."""
