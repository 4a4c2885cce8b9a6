"""CUDA wrapper for the flash attention forward (``csrc/flash_attention.cu``).

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
head dims 1-256); anything else raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "flash_attention"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}   # the C entry point's route codes


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,Dh]; k: [B,Skv,Hkv,Dh]; v: [B,Skv,Hkv,Dv], one dtype
    (f32 or bf16).  Returns [B,Sq,H,Dv] in q's dtype."""
    dev = q.device
    check_layout("flash_attention", dev, q=q, k=k, v=v)
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape

    def require(cond, msg):
        if not cond:
            raise ValueError(f"flash_attention kernel: {msg}")

    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k and v must share one dtype")
    require(k.shape == (B, Skv, Hkv, Dh) and v.shape[0] == B,
            f"k must be [{B}, Skv, Hkv, {Dh}] and v [{B}, Skv, Hkv, Dv]")
    require(Hkv > 0 and H % Hkv == 0, f"H={H} must be a multiple of "
            f"Hkv={Hkv}")
    require(0 < Dh <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM,
            f"head dims must be in [1, {MAX_HEAD_DIM}], got {Dh}, {Dv}")
    require(Skv > 0 and window >= 0, "need Skv >= 1 and window >= 0")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vec = vec_ok(q, k, v)
    path = route_of(q.dtype, Dh, Dv, vec)
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Skv,
        H, Hkv, Dh, Dv, strides_of(q, k, v, o), int(causal), int(window),
        int(q_offset), float(Dh ** -0.5), DTYPES[q.dtype], int(vec),
        ROUTES[path], stream)
    flash_attention.launches += 1
    flash_attention.launches_by_route[path] += 1
    _build.check(lib, _NAME, code)
    return o


flash_attention.launches = 0
flash_attention.launches_by_route = {r: 0 for r in ROUTES}
