"""Slate update: CUDA kernel, plain version and dispatcher."""
