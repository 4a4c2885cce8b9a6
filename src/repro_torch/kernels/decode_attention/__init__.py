"""Decode attention over a KV cache: CUDA kernel, plain version and
dispatcher."""
