"""CUDA wrapper for the fused slate update (``csrc/slate_update.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/slate_update/kernel.py::
slate_update``: segmented combine of sorted (key, delta) runs, then an
in-place read-modify-write of each slotted row's slate row with the
inclusive prefix of its run.

What bounds it on the H100: bytes.  Per call it reads the keys, the int32
slots and the deltas once and reads and writes one random 32-byte sector
per updated slate row and 8-column group; the arithmetic is a few adds per
byte.  At the engine's sizes that is about a microsecond of traffic, so
the kernel's time is its chain of dependent steps.  The design is a
tile-parallel segmented scan whose work per block is fixed by the tile
(512 rows, one 8-column group), not by the run: each block scans its
tile in a fixed order (in the thread, across lanes, across warps),
publishes the aggregate of its last segment with a head flag, and the
rows of a run that began in an earlier tile add the published aggregates
back to the run's head, summed by a fixed tree.  No sum depends on
timing, so two calls give the same bits; no atomics touch the table.

The look-back needs a scratch buffer of status words, one per device,
owned here: allocated zeroed when a call first needs more than the one
it has, and left zero by every launch (the last block clears it), so a
call is one launch and needs no host state.  Launches on one device
must not overlap (the engine issues them on one stream).

The wrapper checks device, dtype, shape, alignment and contiguity,
launches on the current stream, and counts launches in
``slate_update.launches`` and, by monoid, in
``slate_update.launches_by_op``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build

_NAME = "slate_update"
_OPS = {"sum": 0, "max": 1}

_scratch: Dict[torch.device, torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures set (once)."""
    lib = _build.load(_NAME)
    fn = lib.slate_update_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.slate_update_scratch_bytes
    size.argtypes = [ctypes.c_longlong, ctypes.c_int]
    size.restype = ctypes.c_longlong
    return lib


def scratch(dev: torch.device, nbytes: int) -> torch.Tensor:
    """The device's status-word buffer, at least ``nbytes``: zeroed once
    when it grows, then kept zero by the kernel itself."""
    buf = _scratch.get(dev)
    if buf is None or buf.numel() * 4 < nbytes:
        buf = torch.zeros(max(nbytes // 4, 4096), dtype=torch.int32,
                          device=dev)
        _scratch[dev] = buf
    return buf


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
    buf = scratch(dev, lib.slate_update_scratch_bytes(B, D))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slate_update_launch(
        keys_sorted.data_ptr(), deltas.data_ptr(), slots.data_ptr(),
        table_vals.data_ptr(), buf.data_ptr(), B, D, _OPS[op],
        keys_sorted.element_size(), stream)
    slate_update.launches += 1
    slate_update.launches_by_op[op] += 1
    _build.check(lib, _NAME, code)
    return table_vals


slate_update.launches = 0
slate_update.launches_by_op = dict.fromkeys(_OPS, 0)
