"""CUDA wrappers for fused RMSNorm (``csrc/rmsnorm.cu``) and its backward
(``csrc/rmsnorm_bwd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/kernel.py::
rmsnorm``: ``x [..., D]`` (f32 or bf16) normalised over its last
dimension in f32, times ``w [D]`` (f32) or ``(1 + w)``, cast back to
x's dtype; one launch for what the plain version does in ~7.

What bounds it on the H100, and the design: see the source.  The
wrapper checks device, dtype, shape and contiguity, allocates the
output, picks the route and its sizes (:func:`plan`, plain Python:
``"regs"``, a row held in registers by one warp or a small block, for
rows of whole 16-byte vectors; ``"loop"``, a 256-thread block walking
the row, for the rest), launches on the current stream and counts
launches in ``rmsnorm.launches`` and, by route, in
``rmsnorm.launches_by_route``.  It takes any D >= 1 (the TPU kernel's
``supported()`` asks D % 8 == 0); anything else raises.

:func:`rmsnorm_bwd` replaces no TPU kernel (the JAX package trains
through XLA's autodiff of its norms): it gives ``(dx, dw)`` for every
shape the forward takes (D up to ``BWD_MAX_D``), in two launches (the
rows and their per-block dw partials, then the partials' fixed-order
sum).  Its plan (:func:`bwd_plan`, plain Python, a function of the shape,
dtype and alignment alone) picks the route: ``"regs"``, a warp a row held
in registers, for rows of at most ``WARP_VECTORS`` 16-byte vectors a
lane; ``"loop"``, a 256-thread block walking its rows, for the rest.
Calls are counted in ``rmsnorm_bwd.launches`` and, by route, in
``rmsnorm_bwd.launches_by_route``.

A row split across ranks (``kernels/rmsnorm/ops.py``): :func:`rmsnorm_sums`
gives each row's f32 partial sum of squares over the rank's columns (and,
with ``dy``, the partial ``sum (w' dy) x`` the backward needs), one launch
counted in ``rmsnorm_sums.launches``; the ranks' partials summed, both
:func:`rmsnorm` (``ss``) and :func:`rmsnorm_bwd` (``sums``) take the rows'
totals over a whole row of ``d_norm`` elements in place of their own
reductions (those launches also counted in ``partial_launches``), on the
same routes and plans.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_NAME = "rmsnorm"
_BWD = "rmsnorm_bwd"
BWD_MAX_D = 12288      # the backward's dw partial in 48 KB of shared memory
BWD_MAX_BLOCKS = 1024  # the backward's row blocks on the loop route
BWD_WARPS = 8          # the backward's warps a block on the regs route
#                        (csrc/rmsnorm_bwd.cu::kRegsWarps)
BWD_REGS_BLOCKS = 256  # its blocks at most: a ~1 MB dw partial at D = 896
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("regs", "loop")
MAX_BLOCK = 1024       # threads a block
WARP_VECTORS = 4       # 16-byte vectors a lane holds on the one-warp route
DECODE_ROWS = 64       # at most this many rows: one vector a thread


class Plan(NamedTuple):
    """A launch: ``threads_per_row`` (a multiple of 32) and
    ``rows_per_block`` threads and rows, ``vec`` elements a 16-byte
    vector (1 on the loop route, which reads element by element) and
    ``per_thread`` vectors a thread holds (0: the loop route)."""
    threads_per_row: int
    rows_per_block: int
    vec: int
    per_thread: int

    @property
    def route(self) -> str:
        return "regs" if self.per_thread else "loop"


def max_block(per_thread: int) -> int:
    """Threads a block may have on the register route: a thread holding
    four or more vectors needs more than the 64 registers a thread of a
    1024-thread block gets (``csrc/rmsnorm.cu::max_block``)."""
    return 256 if per_thread >= 4 else MAX_BLOCK


def plan(rows: int, D: int, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The launch for ``rows`` rows of ``D`` elements of ``dtype``.

    A row of whole 16-byte vectors on 16-byte aligned tensors stays in
    registers ("regs"): one warp a row, 4 rows a block, while a lane
    holds at most ``WARP_VECTORS`` vectors (D <= 1024 bf16, 512 f32);
    past that a small block a row with one barrier, one vector a thread
    for at most ``DECODE_ROWS`` rows (decode: the most loads in flight)
    and for more rows (prefill) as many as keep the row to ~128 threads,
    doubled until the row fits a block (:func:`max_block`); sizes chosen
    among those timed on the H100 at D = 896, 2048 and 4096.  Everything
    else (odd D, unaligned, D past 8 vectors x 1024 threads) takes the
    256-thread loop."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if not aligned or D % vec:
        return Plan(256, 1, 1, 0)
    nv = D // vec
    if nv <= 32 * WARP_VECTORS:
        per = 1
        while 32 * per < nv:
            per *= 2
        return Plan(32, 4, vec, per)
    per = 1
    if rows > DECODE_ROWS:          # about 128 threads a row
        while 128 * per < nv:
            per *= 2
    while per <= 8:
        tpr = 32 * -(-nv // (32 * per))
        if tpr <= max_block(per):
            return Plan(tpr, 1, vec, per)
        per *= 2
    return Plan(256, 1, 1, 0)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.rmsnorm_sums_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward's library with its entry point's signature set."""
    lib = _build.load(_BWD)
    fn = lib.rmsnorm_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def bwd_rows_per_block(rows: int) -> int:
    """Rows a block of the backward's loop route takes: the fewest that
    keep the blocks at most ``BWD_MAX_BLOCKS`` (a function of the shape
    alone, so a shape always sums dw in the same order)."""
    return max(1, -(-rows // BWD_MAX_BLOCKS))


class BwdPlan(NamedTuple):
    """A backward launch: ``per_thread`` 16-byte vectors a lane holds (0:
    the loop route), ``rows_each`` consecutive rows a warp takes (regs,
    ``BWD_WARPS`` warps a block) or a block takes (loop, 256 threads),
    ``blocks`` row blocks (the dw partial's rows) and ``vec`` elements a
    vector (1 on the loop route)."""
    per_thread: int
    rows_each: int
    blocks: int
    vec: int

    @property
    def route(self) -> str:
        return "regs" if self.per_thread else "loop"


def bwd_plan(rows: int, D: int, dtype: torch.dtype,
             aligned: bool = True) -> BwdPlan:
    """The backward's launch for ``rows`` rows of ``D`` elements: a
    function of the shape, dtype and alignment alone, never of the
    device, so a shape always sums dw in one order.

    Rows of whole 16-byte vectors, at most ``WARP_VECTORS`` a lane (the
    forward's one-warp limit: D <= 1,024 bf16, 512 f32), on 16-byte
    aligned tensors take "regs": a warp a row, ``BWD_WARPS`` warps a
    block, each warp the fewest consecutive rows that keep the blocks at
    most ``BWD_REGS_BLOCKS`` (4,096 rows: 2 a warp, 256 blocks).  The
    rest take the 256-thread "loop" (:func:`bwd_rows_per_block`)."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    nv = D // vec
    if aligned and D % vec == 0 and 0 < nv <= 32 * WARP_VECTORS:
        per = 1
        while 32 * per < nv:
            per *= 2
        rpw = max(1, -(-rows // (BWD_WARPS * BWD_REGS_BLOCKS)))
        return BwdPlan(per, rpw, -(-rows // (BWD_WARPS * rpw)), vec)
    rpb = bwd_rows_per_block(rows)
    return BwdPlan(0, rpb, -(-rows // rpb), 1)


def _check_sums(name, t, shape, dev, d_norm, D):
    if t is None:
        if d_norm not in (None, D):
            raise ValueError(f"{name} kernel: d_norm needs the rows' sums")
        return D
    if not (t.device == dev and t.dtype == torch.float32
            and tuple(t.shape) == tuple(shape) and t.is_contiguous()):
        raise ValueError(f"{name} kernel: the rows' sums must be "
                         f"{list(shape)} float32, contiguous, on {dev}; "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if d_norm is None or d_norm < D:
        raise ValueError(f"{name} kernel: d_norm, the whole row's length, "
                         f"must be at least D={D}, got {d_norm}")
    return int(d_norm)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            scale_offset: bool = False, ss: torch.Tensor = None,
            d_norm: int = None) -> torch.Tensor:
    """x: [..., D] f32/bf16, contiguous; w: [D] f32, on x's device.
    Returns x's shape and dtype.  With ``ss`` ([...] f32, each row's sum
    of squares over a whole row of ``d_norm`` elements, of which x holds
    D) it normalises by that in place of its own sum."""
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
    d_norm = _check_sums("rmsnorm", ss, x.shape[:-1], dev, d_norm, D)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    aligned = (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
               and w.data_ptr() % 16 == 0)
    p = plan(rows, D, x.dtype, aligned)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              rows, D, float(eps), int(scale_offset),
                              DTYPES[x.dtype], p.threads_per_row,
                              p.rows_per_block, p.per_thread,
                              None if ss is None else ss.data_ptr(), d_norm,
                              stream)
    rmsnorm.launches += 1
    rmsnorm.launches_by_route[p.route] += 1
    rmsnorm.partial_launches += int(ss is not None)
    _build.check(lib, _NAME, code)
    return out


rmsnorm.launches = 0
rmsnorm.launches_by_route = {r: 0 for r in ROUTES}
rmsnorm.partial_launches = 0


def rmsnorm_sums(x: torch.Tensor, w: torch.Tensor = None,
                 dy: torch.Tensor = None, *,
                 scale_offset: bool = False) -> torch.Tensor:
    """Each row's f32 partial sums over x's columns: ``x [..., D]``
    (f32/bf16, contiguous) gives ``[...]``, the sum of squares; with
    ``dy`` (as x) and ``w [D]`` f32, ``[..., 2]``: the sum of squares and
    ``sum (dy w') x``, w' = w or 1 + w."""
    dev = x.device

    def require(cond, msg):
        if not cond:
            raise ValueError(f"rmsnorm_sums kernel: {msg}")

    require(x.is_cuda and x.dtype in DTYPES and x.ndim >= 1
            and x.shape[-1] > 0 and x.is_contiguous(),
            f"x must be [..., D] float32 or bfloat16, contiguous, on a CUDA "
            f"device, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if dy is not None:
        require(dy.device == dev and dy.dtype == x.dtype
                and dy.shape == x.shape and dy.is_contiguous(),
                f"dy must be x's shape and dtype, contiguous, on {dev}")
        require(w is not None and w.device == dev
                and w.dtype == torch.float32 and w.shape == x.shape[-1:]
                and w.is_contiguous(),
                f"w must be [{x.shape[-1]}] float32 on {dev} with dy")
    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty(x.shape[:-1] + ((2,) if dy is not None else ()),
                      dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    vec = 16 // x.element_size()
    aligned = (D % vec == 0 and x.data_ptr() % 16 == 0
               and (dy is None or dy.data_ptr() % 16 == 0))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.rmsnorm_sums_launch(
        x.data_ptr(), None if w is None else w.data_ptr(),
        None if dy is None else dy.data_ptr(), out.data_ptr(), rows, D,
        int(scale_offset), DTYPES[x.dtype], int(aligned), stream)
    rmsnorm_sums.launches += 1
    _build.check(lib, _NAME, code)
    return out


rmsnorm_sums.launches = 0


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6, scale_offset: bool = False,
                sums: torch.Tensor = None, d_norm: int = None):
    """The gradients of :func:`rmsnorm` with respect to x and w: x and dy
    [..., D] (one dtype, f32 or bf16, contiguous), w [D] f32.  Returns
    ``(dx, dw)``: dx in x's shape and dtype, dw [D] f32.  With ``sums``
    ([..., 2] f32: each row's sum of squares and ``sum (dy w') x`` over a
    whole row of ``d_norm`` elements, of which x holds D) it takes those
    in place of its own row sums."""
    dev = x.device

    def require(cond, msg):
        if not cond:
            raise ValueError(f"rmsnorm_bwd kernel: {msg}")

    require(x.is_cuda and w.device == dev and dy.device == dev,
            f"x, w and dy must be on one CUDA device, got {x.device}, "
            f"{w.device} and {dy.device}")
    require(x.dtype in DTYPES and dy.dtype == x.dtype
            and w.dtype == torch.float32,
            f"x and dy must share float32 or bfloat16 and w be float32, got "
            f"{x.dtype}, {dy.dtype}, {w.dtype}")
    require(x.ndim >= 1 and 0 < x.shape[-1] <= BWD_MAX_D
            and w.shape == x.shape[-1:] and dy.shape == x.shape,
            f"need x [..., D] with 1 <= D <= {BWD_MAX_D}, w [D] and dy as x, "
            f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(dy.shape)}")
    require(x.is_contiguous() and w.is_contiguous() and dy.is_contiguous(),
            "x, w and dy must be contiguous")
    D = x.shape[-1]
    rows = x.numel() // D
    d_norm = _check_sums("rmsnorm_bwd", sums, x.shape[:-1] + (2,), dev,
                         d_norm, D)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    if rows == 0:
        return dx, dw
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy, dx))
    p = bwd_plan(rows, D, x.dtype, aligned)
    part = torch.empty((p.blocks, D), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.rmsnorm_bwd_launch(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                                  dx.data_ptr(), part.data_ptr(),
                                  dw.data_ptr(), rows, D, p.rows_each,
                                  float(eps), int(scale_offset),
                                  DTYPES[x.dtype], p.per_thread,
                                  None if sums is None else sums.data_ptr(),
                                  d_norm, stream)
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.launches_by_route[p.route] += 1
    rmsnorm_bwd.partial_launches += int(sums is not None)
    _build.check(lib, _BWD, code)
    return dx, dw


rmsnorm_bwd.launches = 0
rmsnorm_bwd.partial_launches = 0
rmsnorm_bwd.launches_by_route = {r: 0 for r in ROUTES}
