"""Chunked SSD scan: the CUDA kernel (its plain version and dispatcher are
``kernels/ssd``, as in the JAX package)."""
