"""Latency-histogram update: CUDA kernel, plain version and dispatcher."""
from repro_torch.kernels.histogram.ops import (histogram_update,
                                               histogram_update_ages)

__all__ = ["histogram_update", "histogram_update_ages"]
