"""Count-min sketch update: CUDA kernel, plain version and dispatcher."""
from repro_torch.kernels.countmin.ops import (countmin_update,
                                              countmin_update_keys)

__all__ = ["countmin_update", "countmin_update_keys"]
