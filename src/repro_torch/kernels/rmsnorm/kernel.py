"""CUDA wrapper for fused RMSNorm (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/kernel.py::
rmsnorm``: ``x [..., D]`` (f32 or bf16) normalised over its last
dimension in f32, times ``w [D]`` (f32) or ``(1 + w)``, cast back to
x's dtype; one launch for what the plain version does in ~7.

What bounds it on the H100, and the design: see the source.  The
wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on the current stream and counts launches in
``rmsnorm.launches``.  It takes any D >= 1 (the TPU kernel's
``supported()`` asks D % 8 == 0); anything else raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "rmsnorm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            scale_offset: bool = False) -> torch.Tensor:
    """x: [..., D] f32/bf16, contiguous; w: [D] f32, on x's device.
    Returns x's shape and dtype."""
    dev = x.device

    def require(cond, msg):
        if not cond:
            raise ValueError(f"rmsnorm kernel: {msg}")

    require(x.is_cuda and w.device == dev, f"x and w must be on one CUDA "
            f"device, got {x.device} and {w.device}")
    require(x.dtype in DTYPES and w.dtype == torch.float32,
            f"x must be float32 or bfloat16 and w float32, got {x.dtype}, "
            f"{w.dtype}")
    require(x.ndim >= 1 and x.shape[-1] > 0 and w.shape == x.shape[-1:],
            f"w must be [{x.shape[-1] if x.ndim else '?'}], got "
            f"{tuple(w.shape)} for x {tuple(x.shape)}")
    require(x.is_contiguous() and w.is_contiguous(),
            "x and w must be contiguous")
    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty_like(x)
    if rows == 0:
        return out
    vec = (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
           and D % (16 // x.element_size()) == 0)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              rows, D, float(eps), int(scale_offset),
                              DTYPES[x.dtype], int(vec), stream)
    rmsnorm.launches += 1
    _build.check(lib, _NAME, code)
    return out


rmsnorm.launches = 0
