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
atomics directly.

Two routes share the kernel: ``countmin_update`` takes the columns
(``cols``, the TPU kernel's interface, hashed outside), and
``countmin_update_keys`` takes the keys and the salts and hashes each
column in the kernel in native uint32 (``keys``, the telemetry path's
route: it saves the ~24 launches of the int64-emulated hash).  Both
count in ``countmin_update.launches`` and, by route, in
``countmin_update.launches_by_route``.

The wrappers check device, dtype, shape and contiguity and launch on the
current stream.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

_NAME = "countmin"
MAX_DEPTH = 8          # salts travel as kernel arguments


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures set (once)."""
    lib = _build.load(_NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in ((lib.countmin_launch, [p, p, p, i, i, ll, p]),
                     (lib.countmin_keys_launch, [p, p, p, p, i, i, ll, i, p]),
                     (lib.countmin_ages_launch, [p, p, p, p, i, i, p, i,
                                                 ll, p])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check_args(counts: torch.Tensor, ins, who: str, dtypes=None) -> int:
    """Check the counters and the inputs ``ins`` (name, tensor; each
    [.., B] or 0-d, the last [B]) for a launch; ``dtypes`` maps an
    input's name to the dtypes it may have (int32 otherwise).  Returns
    B."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{who} kernel: {msg}")

    dev = counts.device
    for name, t in (("counts", counts),) + tuple(ins):
        require(t.is_cuda and t.device == dev, f"{name} must be on {dev} "
                "(a CUDA device)")
        ok = (dtypes or {}).get(name, (torch.int32,))
        require(t.dtype in ok, f"{name} must be "
                + " or ".join(str(d)[6:] for d in ok))
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(counts.ndim == 2 and 0 < counts.numel() < 2**31,
            "counts must be [rows, width] with rows * width < 2**31")
    B = ins[-1][1].shape[-1]
    for name, t in ins:
        require(t.ndim == 0 or t.shape[-1] == B, f"{name} must end in B={B}")
    return B


def launch(counts: torch.Tensor, cols: torch.Tensor, add: torch.Tensor,
           who: str) -> bool:
    """Check the arguments and launch the kernel on given columns; ``who``
    names the wrapper in errors.  Returns whether a kernel was launched
    (not for an empty batch)."""
    B = check_args(counts, (("cols", cols), ("add", add)), who)
    rows, width = counts.shape
    if cols.ndim != 2 or cols.shape[0] != rows or add.ndim != 1:
        raise ValueError(f"{who} kernel: cols must be [{rows}, B] and add "
                         "[B]")
    if B == 0:
        return False
    lib = _lib()
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    code = lib.countmin_launch(counts.data_ptr(), cols.data_ptr(),
                               add.data_ptr(), rows, width, B, stream)
    _build.check(lib, _NAME, code)
    return True


def _count(route: str) -> None:
    countmin_update.launches += 1
    countmin_update.launches_by_route[route] += 1


def countmin_update(counts: torch.Tensor, cols: torch.Tensor,
                    add: torch.Tensor) -> torch.Tensor:
    """counts: [depth, width] int32, updated in place and returned; cols:
    [depth, B] int32; add: [B] int32 (an event counts where > 0)."""
    if launch(counts, cols, add, "countmin_update"):
        _count("cols")
    return counts


def countmin_update_keys(counts: torch.Tensor, keys: torch.Tensor,
                         add: torch.Tensor, salts) -> torch.Tensor:
    """The sketch update with the columns hashed in the kernel: counts
    [depth, width] int32, updated in place and returned; keys: [B] int32
    or int64; add: [B] int32; salts: the ``depth`` uint32 row salts on
    the host (``telemetry.sketch.make_salts``), passed as kernel
    arguments, so the call copies nothing to the device."""
    who = "countmin_update_keys"
    B = check_args(counts, (("keys", keys), ("add", add)), who,
                   {"keys": (torch.int32, torch.int64)})
    depth, width = counts.shape
    s = np.ascontiguousarray(salts, dtype=np.uint32)
    if keys.ndim != 1 or add.ndim != 1 or s.shape != (depth,) \
            or depth > MAX_DEPTH:
        raise ValueError(f"{who} kernel: keys and add must be [B] and salts "
                         f"[{depth}], depth <= {MAX_DEPTH}")
    if B == 0:
        return counts
    lib = _lib()
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    code = lib.countmin_keys_launch(
        counts.data_ptr(), keys.data_ptr(), add.data_ptr(),
        s.ctypes.data, depth, width, B, keys.element_size(), stream)
    _build.check(lib, _NAME, code)
    _count("keys")
    return counts


countmin_update.launches = 0
countmin_update.launches_by_route = {"cols": 0, "keys": 0}
