"""CUDA wrapper for the count-min sketch update (``csrc/countmin.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/countmin/kernel.py::
countmin_update``: fold a batch of hashed key columns into the
``[depth, width]`` sketch in place.  The same source serves
``kernels/histogram``, which computes the same function.

What bounds it on the H100: bytes (the columns and the 0/1 increments
read once, the counters read and written once), far below launch
latency at the engine's sizes.  The design keeps a private copy of the
counters in shared memory per block, groups the lanes of a warp that
hit one counter (``__match_any_sync``) so a hot column costs one atomic
per warp, and adds the private copies into the sketch with one global
atomic per nonzero counter.  Sketches above 48 KB take the global
atomics directly.  Column hashing stays outside the kernel, as on the
TPU.

The wrapper checks device, dtype, shape and contiguity, launches on the
current stream, and counts launches in ``countmin_update.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "countmin"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.countmin_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(counts: torch.Tensor, cols: torch.Tensor, add: torch.Tensor,
           who: str) -> bool:
    """Check the arguments and launch the kernel; ``who`` names the
    wrapper in errors.  Returns whether a kernel was launched (not for an
    empty batch)."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{who} kernel: {msg}")

    dev = counts.device
    for name, t in (("counts", counts), ("cols", cols), ("add", add)):
        require(t.is_cuda and t.device == dev, f"{name} must be on {dev} "
                "(a CUDA device)")
        require(t.dtype == torch.int32, f"{name} must be int32")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(counts.ndim == 2 and 0 < counts.numel() < 2**31,
            "counts must be [rows, width] with rows * width < 2**31")
    rows, width = counts.shape
    require(cols.ndim == 2 and cols.shape[0] == rows,
            f"cols must be [{rows}, B]")
    B = cols.shape[1]
    require(add.shape == (B,), f"add must be [{B}]")
    if B == 0:
        return False
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.countmin_launch(counts.data_ptr(), cols.data_ptr(),
                               add.data_ptr(), rows, width, B, stream)
    _build.check(lib, _NAME, code)
    return True


def countmin_update(counts: torch.Tensor, cols: torch.Tensor,
                    add: torch.Tensor) -> torch.Tensor:
    """counts: [depth, width] int32, updated in place and returned; cols:
    [depth, B] int32; add: [B] int32 (an event counts where > 0)."""
    if launch(counts, cols, add, "countmin_update"):
        countmin_update.launches += 1
    return counts


countmin_update.launches = 0
