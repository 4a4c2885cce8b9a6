"""CUDA wrapper for decode attention (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py
::decode_attention``: ``q [B,Sq,H,Dh]`` (Sq small) attends over caches
``[B,S,Hkv,Dh/Dv]`` up to ``lengths [B]`` (int32, on the device), with
an optional sliding ``window`` and GQA; scores, probabilities and the
accumulator in f32; tiles past a request's length skipped.

What bounds it on the H100, and the design (split-cache flash
decoding): see the source.  The wrapper checks device, dtype, shape and
strides, allocates the output in q's dtype, splits each request's cache
over :func:`plan_splits` blocks, launches on the current stream and
counts launches in ``decode_attention.launches``.  The kernel reads
``lengths`` on the device: no host sync.  Any shape the TPU kernel's
``supported()`` takes is taken (and any ``S`` >= 1, head dims 1-256);
anything else raises.

With ``partial=True`` it is the local half of the route over a cache
whose sequence is split across ranks (``kernels/decode_attention/
ops.py``): the cache is the slice whose row 0 is global position
``seq_offset`` of a ``seq_total``-row cache, the mask is tested in
global positions, and it returns ``(o, lse)`` in f32: each row's output
over the slice and its log-sum-exp (``-inf``, with ``o = 0``, for a row
with no visible key there).  Those launches are also counted in
``decode_attention.partial_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (DTYPES,
                                                        MAX_HEAD_DIM,
                                                        check_layout,
                                                        strides_of, vec_ok)

_NAME = "decode_attention"
TILE = 64          # cache rows a block stages at a time
MAX_SPLITS = 8     # the splits of one (b, kv head) form one cluster


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def plan_splits(B: int, Hkv: int, S: int, sms: int = 132) -> int:
    """Blocks each (request, kv head) gets: enough for about two blocks
    an SM across the ``B * Hkv`` groups, no more than the cache has
    tiles, at most :data:`MAX_SPLITS`.  A function of shapes alone, never
    of ``lengths`` (reading them would sync the host)."""
    want = -(-2 * sms // max(B * Hkv, 1))
    return max(1, min(-(-S // TILE), want, MAX_SPLITS))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, partial: bool = False,
                     seq_offset: int = 0, seq_total: int = None):
    """q: [B,Sq,H,Dh] f32/bf16; caches: [B,S,Hkv,Dh] / [B,S,Hkv,Dv]
    f32/bf16 (one dtype); lengths: [B] int32, the number of valid cache
    rows.  Returns [B,Sq,H,Dv] in q's dtype; with ``partial``, ``(o
    [B,Sq,H,Dv], lse [B,Sq,H])`` in f32 over the slice at
    ``seq_offset`` of a ``seq_total``-row cache."""
    dev = q.device
    check_layout("decode_attention", dev, q=q, k_cache=k_cache,
                 v_cache=v_cache)
    B, Sq, H, Dh = q.shape
    _, S, Hkv, Dv = v_cache.shape

    def require(cond, msg):
        if not cond:
            raise ValueError(f"decode_attention kernel: {msg}")

    require(k_cache.dtype == v_cache.dtype, "the caches must share a dtype")
    require(k_cache.shape == (B, S, Hkv, Dh) and v_cache.shape[0] == B,
            f"k_cache must be [{B}, S, Hkv, {Dh}] and v_cache "
            f"[{B}, S, Hkv, Dv]")
    require(Hkv > 0 and H % Hkv == 0, f"H={H} must be a multiple of "
            f"Hkv={Hkv}")
    require(0 < Dh <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM,
            f"head dims must be in [1, {MAX_HEAD_DIM}], got {Dh}, {Dv}")
    require(S > 0 and window >= 0, "need S >= 1 and window >= 0")
    total = S if seq_total is None else int(seq_total)
    require(partial or (seq_offset == 0 and total == S),
            "a slice of the cache (seq_offset, seq_total) needs partial")
    require(0 <= seq_offset and seq_offset + S <= total < 2**31,
            f"the slice [{seq_offset}, {seq_offset + S}) must lie in the "
            f"{total}-row cache")
    require(lengths.is_cuda and lengths.device == dev
            and lengths.dtype == torch.int32 and lengths.shape == (B,)
            and lengths.is_contiguous(),
            f"lengths must be [{B}] int32, contiguous, on {dev}")
    o = torch.empty((B, Sq, H, Dv), device=dev,
                    dtype=torch.float32 if partial else q.dtype)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
           if partial else None)
    if o.numel() == 0:
        return (o, lse) if partial else o
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), B, Sq, S, H, Hkv, Dh, Dv,
        strides_of(q, k_cache, v_cache, o), int(window), float(Dh ** -0.5),
        DTYPES[q.dtype], DTYPES[k_cache.dtype],
        int(vec_ok(k_cache, v_cache)),
        plan_splits(B, Hkv, S, _sm_count(dev.index)), int(seq_offset),
        total, lse.data_ptr() if partial else None, stream)
    decode_attention.launches += 1
    decode_attention.partial_launches += int(partial)
    _build.check(lib, _NAME, code)
    return (o, lse) if partial else o


decode_attention.launches = 0
decode_attention.partial_launches = 0
