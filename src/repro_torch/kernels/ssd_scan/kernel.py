"""CUDA wrapper for the chunked SSD scan (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan``: the Mamba-2 / mLSTM linear recurrence ``S_t = exp(log_a_t)
S_{t-1} + k_t^T v_t``, ``y_t = q_t S_t`` over ``q, k [B,S,H,N]``,
``v [B,S,H,P]``, ``log_a [B,S,H]`` from a zero state (or a given f32
``initial_state [B,H,N,P]``), computed chunk by chunk; returns ``y
[B,S,H,P]`` in v's dtype and the final f32 state ``[B,H,N,P]``.

What bounds it on the H100, and the design: see the source.  The
wrapper checks device, dtype, shape and strides (the last dimension
contiguous, the others any, so q and k may be head-broadcast views),
allocates the outputs, picks the route (:func:`route_of`: ``"mma"``, the
tensor cores, for bf16 with N and P of 16, 32, 64 or 128 and a chunk
whose tiles fit shared memory; ``"simt"``, the f32 CUDA cores, for the rest),
launches on the current stream and counts launches in ``ssd_scan.launches`` and, by route, in
``ssd_scan.launches_by_route``.  The TPU kernel starts from a zero
state only; this one also takes an initial state, which the route over
a sequence split across ranks (``kernels/ssd/ops.py``) passes to each
rank's second scan (those launches are also counted in
``ssd_scan.partial_launches``).  ``ssd_step`` carries the state in
decode.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import vec_ok

_NAME = "ssd_scan"
MAX_NP = 128        # state dims the kernel's shared memory holds
MAX_CHUNK = 2048
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "mma": 1}   # the C entry point's route codes
MMA_MAX_CHUNK = 256  # rows a chunk on the tensor-core route (one a thread)
MMA_DIMS = (16, 32, 64, 128)   # N and P the tensor-core route takes
MMA_SMEM = 232448 - 1024   # dynamic shared memory a block may ask
PAD = 8              # bf16 of padding a staged row


def smem_bytes(L: int, N: int, P: int, carry: bool = True) -> int:
    """Shared memory of the "mma" route for an L-row chunk
    (``csrc/ssd_scan.cu::mma::smem_bytes``): Q, K [L, N + 8] and V
    [L, P + 8] in bf16, cum and wend [L] in f32, and, when a chunk
    follows another (``carry``), the bf16 state [N, P + 8]."""
    return (2 * L * (2 * (N + PAD) + P + PAD) + 4 * 2 * L
            + (2 * N * (P + PAD) if carry else 0))


def route_of(dtype: torch.dtype, N: int, P: int, chunk: int,
             aligned: bool) -> str:
    """The kernel route: "mma" (tensor cores) for bf16 with N and P each
    one of ``MMA_DIMS`` (the kernel is compiled for each, so that its
    loops over N and P unroll), a chunk that is a multiple of 16 up to
    ``MMA_MAX_CHUNK`` whose tiles fit shared memory, and
    16-byte aligned tensors; else "simt" (f32 CUDA cores; f32 stays
    there, the tensor cores would round it)."""
    if (dtype == torch.bfloat16 and aligned and N in MMA_DIMS
            and P in MMA_DIMS and chunk % 16 == 0
            and 0 < chunk <= MMA_MAX_CHUNK
            and smem_bytes(chunk, N, P) <= MMA_SMEM):
        return "mma"
    return "simt"


def mma_chunk(S: int, chunk: int) -> int:
    """The chunk the "mma" route runs: ``chunk``, or S rounded up to 16
    when the sequence fits one chunk (rows past S read as 0)."""
    return chunk if S > chunk else -(-S // 16) * 16


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          chunk: int = 256) -> str:
    """The route :func:`ssd_scan` takes for these tensors."""
    return route_of(q.dtype, q.shape[-1], v.shape[-1],
                    mma_chunk(q.shape[1], chunk), vec_ok(q, k, v))


def supported(q, k, v) -> bool:
    """The JAX package's shape rule (``repro/kernels/ssd_scan/kernel.py::
    supported``: N and P multiples of 8), within the sizes this kernel
    holds in shared memory."""
    N, P = q.shape[-1], v.shape[-1]
    return N % 8 == 0 and P % 8 == 0 and N <= MAX_NP and P <= MAX_NP


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry point's signature set (once)."""
    lib = _build.load(_NAME)
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor = None):
    """q, k: [B,S,H,N]; v: [B,S,H,P] (one dtype, f32 or bf16); log_a:
    [B,S,H] f32; initial_state: None (zero) or [B,H,N,P] f32.  Returns (y
    [B,S,H,P] in v's dtype, final [B,H,N,P] f32)."""
    dev = q.device

    def require(cond, msg):
        if not cond:
            raise ValueError(f"ssd_scan kernel: {msg}")

    for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a)):
        require(t.is_cuda and t.device == dev,
                f"{name} must be on {dev} (a CUDA device)")
    require(q.ndim == 4 and v.ndim == 4 and log_a.ndim == 3,
            "q, k, v must be [B, S, H, D] and log_a [B, S, H]")
    B, S, H, N = q.shape
    P = v.shape[-1]
    require(k.shape == q.shape and v.shape == (B, S, H, P)
            and log_a.shape == (B, S, H),
            f"k must be {tuple(q.shape)}, v [{B}, {S}, {H}, P], log_a "
            f"[{B}, {S}, {H}]; got {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(log_a.shape)}")
    require(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    require(log_a.dtype == torch.float32, "log_a must be float32")
    require(all(t.stride(-1) == 1 for t in (q, k, v)),
            "q, k, v need a contiguous last dimension")
    require(0 < N <= MAX_NP and 0 < P <= MAX_NP,
            f"N and P must be in [1, {MAX_NP}], got {N}, {P}")
    require(0 < chunk <= MAX_CHUNK, f"chunk must be in [1, {MAX_CHUNK}]")
    require(S > 0, "need S >= 1")
    h0 = initial_state
    if h0 is not None:
        require(h0.device == dev and h0.dtype == torch.float32
                and h0.shape == (B, H, N, P),
                f"initial_state must be [{B}, {H}, {N}, {P}] float32 on "
                f"{dev}, got {tuple(h0.shape)} {h0.dtype} on {h0.device}")
        if not h0.is_contiguous() or h0.data_ptr() % 16:
            h0 = h0.contiguous().clone()
    y = torch.empty((B, S, H, P), dtype=v.dtype, device=dev)
    fin = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, fin
    flat = [s for t in (q, k, v, log_a, y) for s in t.stride()[:3]]
    path = route(q, k, v, chunk)
    L = mma_chunk(S, chunk) if path == "mma" else min(chunk, S)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.ssd_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        y.data_ptr(), fin.data_ptr(), B, S, H, N, P, L,
        (ctypes.c_longlong * len(flat))(*flat), DTYPES[q.dtype],
        ROUTES[path], None if h0 is None else h0.data_ptr(), stream)
    ssd_scan.launches += 1
    ssd_scan.partial_launches += int(h0 is not None)
    ssd_scan.launches_by_route[path] += 1
    _build.check(lib, _NAME, code)
    return y, fin


ssd_scan.launches = 0
ssd_scan.partial_launches = 0
ssd_scan.launches_by_route = {r: 0 for r in ROUTES}
