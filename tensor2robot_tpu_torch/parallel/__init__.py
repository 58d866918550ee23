"""Attention kernels of the port (the JAX package's ``parallel/``)."""
