"""Slate lookup: CUDA kernel, plain version and dispatcher."""
from repro_torch.kernels.slate_lookup.ops import lookup_slots, slate_lookup

__all__ = ["slate_lookup", "lookup_slots"]
