"""CUDA wrappers for the flash attention forward (``csrc/flash_attention.cu``)
and backward (``csrc/flash_attention_bwd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``: causal (with ``q_offset``), sliding-window or
bidirectional attention of ``q [B,Sq,H,Dh]`` over ``k [B,Skv,Hkv,Dh]``,
``v [B,Skv,Hkv,Dv]`` with GQA (kv head ``h // (H // Hkv)``), an f32
online softmax, and key tiles no row needs skipped.

What bounds it on the H100, and the design: see the source.  The
wrapper checks device, dtype, shape and strides (the last dimension
contiguous; the others any), allocates the output, picks the route
(:func:`route`: ``"wgmma"``, the tensor cores, for bf16 with head dims
that are multiples of 16 read 16 bytes at a time; ``"simt"``, the f32
CUDA cores, for the rest), launches on the current stream and counts
launches in ``flash_attention.launches`` and, by route, in
``flash_attention.launches_by_route``.  It takes every shape the TPU
kernel's ``supported()`` takes (and more: any ``Sq``, ``Skv`` >= 1,
head dims 1-256); anything else raises.  With ``lse=True`` it also
returns each row's log-sum-exp (``[B, H, Sq]`` f32), which
:func:`flash_attention_bwd` reads.

:func:`flash_attention_bwd` replaces no TPU kernel (the JAX package
trains through XLA's autodiff of its plain attention): it gives
``(dq, dk, dv)`` for every shape the forward takes.  Its route
(:func:`bwd_route`) follows the forward's rule over q, k, v, o and dO:
``"wgmma"`` (tensor cores: a dQ launch, a dK/dV launch a query head and,
for a GQA group, a launch that sums the heads' f32 partials in order) or
``"simt"`` (f32 CUDA cores: a dQ launch and a dK/dV launch a kv head).
Calls are counted in ``flash_attention_bwd.launches`` and, by route, in
``flash_attention_bwd.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "flash_attention"
_BWD = "flash_attention_bwd"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}   # the C entry point's route codes


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward's library with its entry point's signature set."""
    lib = _build.load(_BWD)
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def strides_of(*ts: torch.Tensor):
    """The (batch, seq, head) element strides of [B, S, heads, D]
    tensors, in one ctypes array (the kernels' layout argument)."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def vec_ok(*ts: torch.Tensor) -> bool:
    """Whether every tensor can be read 16 bytes at a time: 16-byte
    aligned base, and D and the outer strides whole 16-byte units."""
    for t in ts:
        unit = 16 // t.element_size()
        if (t.data_ptr() % 16 or t.shape[-1] % unit
                or any(s % unit for s in t.stride()[:3])):
            return False
    return True


def route_of(dtype: torch.dtype, Dh: int, Dv: int, aligned: bool) -> str:
    """The kernel route for a dtype, head dims and alignment: "wgmma"
    (tensor cores) for bf16 with Dh and Dv multiples of 16 up to 256 and
    16-byte aligned tensors, else "simt" (f32 CUDA cores; f32 stays
    there, the tensor cores would round it to TF32)."""
    if (dtype == torch.bfloat16 and aligned and Dh % 16 == 0
            and Dv % 16 == 0 and Dh <= MAX_HEAD_DIM and Dv <= MAX_HEAD_DIM):
        return "wgmma"
    return "simt"


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route :func:`flash_attention` takes for these tensors."""
    return route_of(q.dtype, q.shape[-1], v.shape[-1], vec_ok(q, k, v))


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, do: torch.Tensor) -> str:
    """The route :func:`flash_attention_bwd` takes for these tensors: the
    forward's rule (:func:`route_of`) with o and dO read 16 bytes at a
    time too."""
    return route_of(q.dtype, q.shape[-1], v.shape[-1],
                    vec_ok(q, k, v, o, do))


def check_layout(who: str, dev, **ts: torch.Tensor) -> None:
    """Device, rank and contiguity checks shared by the attention
    wrappers."""
    for name, t in ts.items():
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{who} kernel: {name} must be on {dev} "
                             "(a CUDA device)")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{who} kernel: {name} must be [B, S, heads, "
                             "D] with the last dimension contiguous")
        if t.dtype not in DTYPES:
            raise ValueError(f"{who} kernel: {name} must be float32 or "
                             f"bfloat16, got {t.dtype}")


def check_shapes(who: str, q, k, v, window: int) -> None:
    """The shape checks the forward and backward wrappers share."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape

    def require(cond, msg):
        if not cond:
            raise ValueError(f"{who} kernel: {msg}")

    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k and v must share one dtype")
    require(k.shape == (B, Skv, Hkv, Dh) and v.shape[0] == B,
            f"k must be [{B}, Skv, Hkv, {Dh}] and v [{B}, Skv, Hkv, Dv]")
    require(Hkv > 0 and H % Hkv == 0, f"H={H} must be a multiple of "
            f"Hkv={Hkv}")
    require(0 < Dh <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM,
            f"head dims must be in [1, {MAX_HEAD_DIM}], got {Dh}, {Dv}")
    require(Skv > 0 and window >= 0, "need Skv >= 1 and window >= 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, lse: bool = False):
    """q: [B,Sq,H,Dh]; k: [B,Skv,Hkv,Dh]; v: [B,Skv,Hkv,Dv], one dtype
    (f32 or bf16).  Returns [B,Sq,H,Dv] in q's dtype; with ``lse`` also
    each row's log-sum-exp of the scaled scores, [B,H,Sq] f32."""
    dev = q.device
    check_layout("flash_attention", dev, q=q, k=k, v=v)
    check_shapes("flash_attention", q, k, v, window)
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    stats = torch.empty((B, H, Sq), dtype=torch.float32,
                        device=dev) if lse else None
    if o.numel() == 0:
        return (o, stats) if lse else o
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vec = vec_ok(q, k, v)
    path = route_of(q.dtype, Dh, Dv, vec)
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        stats.data_ptr() if lse else None, B, Sq, Skv,
        H, Hkv, Dh, Dv, strides_of(q, k, v, o), int(causal), int(window),
        int(q_offset), float(Dh ** -0.5), DTYPES[q.dtype], int(vec),
        ROUTES[path], stream)
    flash_attention.launches += 1
    flash_attention.launches_by_route[path] += 1
    _build.check(lib, _NAME, code)
    return (o, stats) if lse else o


flash_attention.launches = 0
flash_attention.launches_by_route = {r: 0 for r in ROUTES}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """The gradients of :func:`flash_attention` with respect to q, k and
    v, given its output ``o`` and row statistics ``lse`` (``lse=True``)
    and the output's gradient ``do`` ([B,Sq,H,Dv], any strides with the
    last dimension contiguous; another layout is copied once).  Returns
    ``(dq, dk, dv)`` in q's dtype, contiguous."""
    dev = q.device
    if do.stride(-1) != 1:
        do = do.contiguous()
    check_layout("flash_attention_bwd", dev, q=q, k=k, v=v, o=o, do=do)
    check_shapes("flash_attention_bwd", q, k, v, window)
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    if not (o.shape == do.shape == (B, Sq, H, Dv)
            and o.dtype == do.dtype == q.dtype):
        raise ValueError(f"flash_attention_bwd kernel: o and do must be "
                         f"[{B}, {Sq}, {H}, {Dv}] {q.dtype}")
    if not (lse.shape == (B, H, Sq) and lse.dtype == torch.float32
            and lse.is_contiguous() and lse.device == dev):
        raise ValueError(f"flash_attention_bwd kernel: lse must be "
                         f"[{B}, {H}, {Sq}] float32, contiguous, on {dev}")
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    path = bwd_route(q, k, v, o, do)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    # each query head's f32 partials of dK and dV, summed in head order by
    # the wgmma route's last launch (a GQA group only)
    dkp = dvp = None
    if path == "wgmma" and H != Hkv:
        dkp = torch.empty((B, H, Skv, Dh), dtype=torch.float32, device=dev)
        dvp = torch.empty((B, H, Skv, Dv), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if dkp is None else dkp.data_ptr(),
        None if dvp is None else dvp.data_ptr(), B, Sq, Skv, H, Hkv, Dh, Dv,
        strides_of(q, k, v, o, do, dq, dk, dv), int(causal), int(window),
        int(q_offset), float(Dh ** -0.5), DTYPES[q.dtype], ROUTES[path],
        stream)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[path] += 1
    _build.check(lib, _BWD, code)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {r: 0 for r in ROUTES}
