"""Fused RMSNorm: CUDA kernel, plain version and dispatcher."""
