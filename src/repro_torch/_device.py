"""Device resolution shared by the port's entry points.

Entry points (``Engine``, ``EventBatch.of``, ``init_state``, the table
and queue constructors) run on ``cuda`` unless the caller names another
device.  Without a card and without an explicit ``device="cpu"`` they
raise instead of falling back quietly: a run that meant to measure the
GPU must not measure the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is requested but absent.  A
    CUDA device without an index gets the current one (``cuda`` ->
    ``cuda:0``), the device its tensors report, so device checks compare
    like with like."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA requested (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# numpy dtype name <-> torch dtype for specs and state conversion
_NP_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """Accept a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dt, torch.dtype):
        return dt
    import numpy as np
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    try:
        return _NP_TO_TORCH[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dt!r}") from None
