"""CUDA wrapper for the fused slate update (``csrc/slate_update.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/slate_update/kernel.py::
slate_update``: segmented combine of sorted (key, delta) runs, then an
in-place read-modify-write of each run-last row's slate row.

What bounds it on the H100: bytes.  Per call it reads the keys, the int32
slots and the deltas once and reads and writes one random 32-byte sector per
updated slate row (D = 8 f32 columns); the arithmetic is a few adds per
byte.  The design gives each updated row one warp that walks its run
backward with a ballot and keeps the partial sums in registers, so the
deltas are read once and the table row is touched once, with no atomics
(slots of distinct runs are unique).  A single hot run is walked by one
warp, 32 rows a step: under Zipf skew that warp sets the kernel's time.

The wrapper checks device, dtype, shape, alignment and contiguity,
launches on the current stream, and counts launches in
``slate_update.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "slate_update"
_OPS = {"sum": 0, "max": 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.slate_update_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"slate_update kernel: {msg}")


def slate_update(keys_sorted: torch.Tensor, deltas: torch.Tensor,
                 slots: torch.Tensor, table_vals: torch.Tensor, *,
                 op: str = "sum") -> torch.Tensor:
    """keys_sorted: [B] int32/int64, sorted (invalid rows at the sink
    key); deltas: [B, D] f32 with D % 8 == 0; slots: [B] int32 slate row
    for run-last rows, -1 elsewhere (the JAX package's index width);
    table_vals: [N, D] f32 with N < 2**31, updated in place and
    returned."""
    _require(op in _OPS, f"unknown op {op!r}")
    dev = table_vals.device
    for name, t in (("keys_sorted", keys_sorted), ("deltas", deltas),
                    ("slots", slots), ("table_vals", table_vals)):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}"
                 " (a CUDA device)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(keys_sorted.dtype in (torch.int32, torch.int64)
             and keys_sorted.ndim == 1, "keys_sorted must be [B] int32/int64")
    B = keys_sorted.shape[0]
    _require(deltas.dtype == torch.float32 and deltas.ndim == 2
             and deltas.shape[0] == B, "deltas must be [B, D] float32")
    D = deltas.shape[1]
    _require(D % 8 == 0 and D > 0, f"D={D} must be a positive multiple of 8")
    _require(slots.dtype == torch.int32 and slots.shape == (B,),
             "slots must be [B] int32")
    _require(table_vals.dtype == torch.float32 and table_vals.ndim == 2
             and table_vals.shape[1] == D
             and table_vals.shape[0] < 2**31,
             "table_vals must be [N, D] float32 with N < 2**31")
    _require(deltas.data_ptr() % 16 == 0 and table_vals.data_ptr() % 16 == 0,
             "deltas and table_vals must be 16-byte aligned")
    if B == 0:
        return table_vals
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slate_update_launch(
        keys_sorted.data_ptr(), deltas.data_ptr(), slots.data_ptr(),
        table_vals.data_ptr(), B, D, _OPS[op], keys_sorted.element_size(),
        stream)
    slate_update.launches += 1
    _build.check(lib, _NAME, code)
    return table_vals


slate_update.launches = 0
