"""Count-min sketch update: CUDA kernel, plain version and dispatcher."""
from repro_torch.kernels.countmin.ops import countmin_update

__all__ = ["countmin_update"]
