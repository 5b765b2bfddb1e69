"""Kernels of the port: CUDA sources in ``csrc/``, their wrappers and plain
versions here."""
