"""CUDA wrappers for the batched slate point-lookup
(``csrc/slate_lookup.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/slate_lookup/kernel.py::
slate_lookup`` (int32 keys) and ``::slate_lookup_wide`` (int64 keys,
split into 32-bit planes for TPU SMEM): one kernel templated on the key
type serves both widths.

Three routes share the kernel, one wrapper each:

- ``slate_lookup`` (``cand``): the TPU kernel's interface — probe walk
  over given candidates ``[P, Q]``, first hit over all P, then the row
  gather.
- ``slate_lookup_keys`` (``keys``): the probe chain hashed in the kernel
  in native uint32, bitwise ``slates.table._probe_seq``, with the same
  stop rule and gather (rows optional).  The read path on the card:
  it saves the ~57 launches of the int64-emulated hash a read.
- ``find_slots`` (``find``): the chain hashed, the walk stopping at the
  first probe that hits or finds ``EMPTY``, on the rows where
  ``pending``; the rest give (-1, False).  ``slates.table._lookup_keys``
  masked by ``pending``: the walk of each ``insert_or_find`` round.

What bounds it on the H100: random 32-byte sectors and the latency of
the dependent steps between them.  A thread takes a query: it reads
probe 0's key first and only where that does not stop the chain reads
probes 1..P-1 together, so a chain costs at most two dependent memory
steps and a query that its first probe decides one sector; it then
copies the row as 16-byte vectors where it can.

The wrappers check device, dtype, shape and contiguity, allocate the
outputs, launch on the current stream (nothing for an empty batch; no
host sync), and count launches in ``slate_lookup.launches`` and, by
route, in ``slate_lookup.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.slates.table import PROBES

_NAME = "slate_lookup"
ROUTES = ("cand", "keys", "find")
MAX_PROBES = 32


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.slate_lookup_launch
    fn.argtypes = [i] + [p] * 8 + [ll, i, i, ll, i, i, p]
    fn.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"slate_lookup kernel: {msg}")


def _check(table_keys, query, capacity, **more):
    """Check the common arguments and ``more`` (name -> tensor or None);
    returns the hashed capacity."""
    dev = table_keys.device
    for name, t in (("table_keys", table_keys), ("query", query),
                    *more.items()):
        if t is None:
            continue
        _require(t.is_cuda and t.device == dev, f"{name} must be on {dev}"
                 " (a CUDA device)")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    N = table_keys.shape[0] if table_keys.ndim == 1 else 0
    _require(table_keys.dtype in (torch.int32, torch.int64)
             and table_keys.ndim == 1 and 0 < N < 2**31,
             "table_keys must be [N] int32/int64 with 0 < N < 2**31")
    _require(query.dtype == table_keys.dtype and query.ndim == 1,
             "query must be [Q] of the table's key dtype")
    vals = more.get("table_vals")
    if vals is not None:
        _require(vals.ndim == 2 and vals.element_size() == 4
                 and vals.shape[0] == N,
                 "table_vals must be [N, D] with 4-byte elements")
    C = N if capacity is None else int(capacity)
    _require(2 <= C <= N, f"capacity must be in [2, {N}]")
    return C


def _launch(route, table_keys, query, slot, found, *, cand=None,
            pending=None, table_vals=None, rows=None, P=PROBES, C=0):
    Q = query.shape[0]
    if Q == 0:
        return
    D = table_vals.shape[1] if table_vals is not None else 0
    vec = (table_vals is not None and D % 4 == 0
           and table_vals.data_ptr() % 16 == 0
           and (rows is None or rows.data_ptr() % 16 == 0))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    code = lib.slate_lookup_launch(
        ROUTES.index(route), table_keys.data_ptr(), query.data_ptr(),
        ptr(cand), ptr(pending), ptr(table_vals), slot.data_ptr(),
        found.data_ptr(), ptr(rows), Q, P, D, C, table_keys.element_size(),
        int(vec), stream)
    slate_lookup.launches += 1
    slate_lookup.launches_by_route[route] += 1
    _build.check(lib, _NAME, code)


def slate_lookup(table_keys: torch.Tensor, query: torch.Tensor,
                 cand: torch.Tensor, table_vals: torch.Tensor):
    """The ``cand`` route.  ``table_keys``: [N] int32/int64 with
    N < 2**31; ``query``: [Q], same dtype; ``cand``: [P, Q] int32 probe
    candidates (P <= 32, values < N); ``table_vals``: [N, D] with 4-byte
    elements.  Returns ``(slot [Q] int32, found [Q] bool, rows [Q, D])``
    with rows of missing keys zeroed.  Indices are int32, as in the JAX
    package."""
    _check(table_keys, query, None, cand=cand, table_vals=table_vals)
    Q = query.shape[0]
    _require(cand.dtype == torch.int32 and cand.ndim == 2
             and cand.shape[1] == Q and 0 < cand.shape[0] <= MAX_PROBES,
             f"cand must be [P, Q] int32 with P <= {MAX_PROBES}")
    dev = query.device
    slot = torch.empty(Q, dtype=torch.int32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    rows = torch.empty((Q, table_vals.shape[1]), dtype=table_vals.dtype,
                       device=dev)
    _launch("cand", table_keys, query, slot, found, cand=cand,
            table_vals=table_vals, rows=rows, P=cand.shape[0])
    return slot, found, rows


def slate_lookup_keys(table_keys: torch.Tensor, query: torch.Tensor,
                      table_vals=None, *, capacity=None):
    """The ``keys`` route: the probe chain of ``query`` over the first
    ``capacity`` slots (default N) hashed in the kernel.  Arguments as
    :func:`slate_lookup` without ``cand``; ``table_vals`` may be None.
    Returns ``(slot [Q] int32, found [Q] bool, rows [Q, D] or None)``."""
    C = _check(table_keys, query, capacity, table_vals=table_vals)
    Q, dev = query.shape[0], query.device
    slot = torch.empty(Q, dtype=torch.int32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    rows = None if table_vals is None else torch.empty(
        (Q, table_vals.shape[1]), dtype=table_vals.dtype, device=dev)
    _launch("keys", table_keys, query, slot, found, table_vals=table_vals,
            rows=rows, C=C)
    return slot, found, rows


def find_slots(table_keys: torch.Tensor, query: torch.Tensor,
               pending: torch.Tensor, *, capacity=None):
    """The ``find`` route: on each row where ``pending`` ([Q] bool), the
    first probe of the hashed chain over ``capacity`` slots (default N)
    that holds ``query`` or ``EMPTY``.  Returns ``(slot [Q] int64,
    found [Q] bool)``: that slot or -1, and whether it holds the key;
    (-1, False) on rows not pending."""
    C = _check(table_keys, query, capacity, pending=pending)
    Q, dev = query.shape[0], query.device
    _require(pending.dtype == torch.bool and pending.shape == (Q,),
             "pending must be [Q] bool")
    slot = torch.empty(Q, dtype=torch.int64, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    _launch("find", table_keys, query, slot, found, pending=pending, C=C)
    return slot, found


slate_lookup.launches = 0
slate_lookup.launches_by_route = dict.fromkeys(ROUTES, 0)
