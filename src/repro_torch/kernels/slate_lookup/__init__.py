"""Slate lookup: CUDA kernel, plain version and dispatcher."""
