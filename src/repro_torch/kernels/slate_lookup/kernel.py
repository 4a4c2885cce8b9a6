"""CUDA wrapper for the batched slate point-lookup
(``csrc/slate_lookup.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/slate_lookup/kernel.py::
slate_lookup`` (int32 keys) and ``::slate_lookup_wide`` (int64 keys,
split into 32-bit planes for TPU SMEM): one kernel templated on the key
type serves both widths.

What bounds it on the H100: bytes, as random 32-byte sectors — up to P
key probes and one D-wide row per query.  The design gives each query
one warp whose lanes issue all P probes at once, so a query costs one
round of memory latency for its probes and one for its row, and takes
the first hit in probe order with a ballot.  Candidates are computed
outside the kernel (``slates.table._probe_seq``).  There is no cap on
the number of queries.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on the current stream, and counts launches in
``slate_lookup.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "slate_lookup"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.slate_lookup_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"slate_lookup kernel: {msg}")


def slate_lookup(table_keys: torch.Tensor, query: torch.Tensor,
                 cand: torch.Tensor, table_vals: torch.Tensor):
    """``table_keys``: [N] int32/int64 with N < 2**31; ``query``: [Q],
    same dtype; ``cand``: [P, Q] int32 probe candidates (P <= 32,
    values < N); ``table_vals``: [N, D] with 4-byte elements.  Returns
    ``(slot [Q] int32, found [Q] bool, rows [Q, D])`` with rows of
    missing keys zeroed.  Indices are int32, as in the JAX package."""
    dev = table_vals.device
    for name, t in (("table_keys", table_keys), ("query", query),
                    ("cand", cand), ("table_vals", table_vals)):
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}"
                 " (a CUDA device)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(table_keys.dtype in (torch.int32, torch.int64)
             and table_keys.ndim == 1 and table_keys.shape[0] < 2**31,
             "table_keys must be [N] int32/int64 with N < 2**31")
    _require(query.dtype == table_keys.dtype and query.ndim == 1,
             "query must be [Q] of the table's key dtype")
    Q = query.shape[0]
    _require(cand.dtype == torch.int32 and cand.ndim == 2
             and cand.shape[1] == Q and 0 < cand.shape[0] <= 32,
             "cand must be [P, Q] int32 with P <= 32")
    _require(table_vals.ndim == 2 and table_vals.element_size() == 4
             and table_vals.shape[0] == table_keys.shape[0],
             "table_vals must be [N, D] with 4-byte elements")
    P, D = cand.shape[0], table_vals.shape[1]
    slot = torch.empty(Q, dtype=torch.int32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    rows = torch.empty((Q, D), dtype=table_vals.dtype, device=dev)
    if Q == 0:
        return slot, found, rows
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.slate_lookup_launch(
        table_keys.data_ptr(), query.data_ptr(), cand.data_ptr(),
        table_vals.data_ptr(), slot.data_ptr(), found.data_ptr(),
        rows.data_ptr(), Q, P, D, table_keys.element_size(), stream)
    slate_lookup.launches += 1
    _build.check(lib, _NAME, code)
    return slot, found, rows


slate_lookup.launches = 0
