"""The plain-Python halves of the training slice's backward kernels, on
the CPU: which route ``flash_attention_bwd`` takes (the forward's rule
over q, k, v, o and dO: tensor cores for bf16 with head dims that are
multiples of 16 read 16 bytes at a time, CUDA cores for the rest), and
``rmsnorm_bwd``'s plan (a warp a row held in registers for rows of at
most four 16-byte vectors a lane on aligned tensors, a 256-thread block
walking its rows for the rest; a function of the shape alone, with a dw
partial near 1 MB at the training shape).

Then the ``wgmma`` route's arithmetic, emulated in plain torch: P and dS
formed in f32 from S, dP, the forward's lse and delta = rowsum(dO o O)
under the kernel's masks, rounded to bf16 before the products that
consume them, every sum in f32, each query head's dK and dV summed over
its group.  Without the roundings it is the plain backward within f32
noise; with them it is held against the plain version
(``kernels/attention/ref.py::mha_bwd``) and the JAX package's gradient
(``jax.vjp`` of ``repro.kernels.attention.ref.mha``) within the card
tests' tolerance, 2**-5 of each reference gradient's largest magnitude.
The kernels themselves run only on the card
(``tests/test_torch_train_kernel.py``)."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.attention import ref as j_attn
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.rmsnorm import kernel as rk

BF16, F32 = torch.bfloat16, torch.float32


def _qkvo(B, S, H, Hkv, Dh, Dv, dt=BF16):
    z = lambda *sh: torch.zeros(sh, dtype=dt)
    return z(B, S, H, Dh), z(B, S, Hkv, Dh), z(B, S, Hkv, Dv), z(B, S, H, Dv)


@pytest.mark.parametrize("Dh,Dv,dt,want", [
    (64, 64, BF16, "wgmma"),       # qwen2-0.5b's training shape
    (256, 256, BF16, "wgmma"),     # gemma3-1b
    (192, 128, BF16, "wgmma"),     # MLA
    (16, 32, BF16, "wgmma"),
    (64, 64, F32, "simt"),         # f32 would round to TF32
    (72, 72, BF16, "simt"),        # not a multiple of 16
    (24, 40, BF16, "simt"),
])
def test_bwd_route_by_dtype_and_head_dims(Dh, Dv, dt, want):
    q, k, v, o = _qkvo(2, 10, 4, 2, Dh, Dv, dt)
    assert fk.bwd_route(q, k, v, o, o.clone()) == want
    assert fk.bwd_route(q, k, v, o, o.clone()) == fk.route(q, k, v)


def test_bwd_route_reads_every_input():
    """A transposed dO ([B, H, S, Dv] memory) keeps the tensor cores; an
    unaligned view of any one of q, k, v, o or dO sends the backward to
    the CUDA cores, though the forward may keep them."""
    q, k, v, o = _qkvo(2, 10, 4, 2, 64, 64)
    do = torch.zeros(2, 4, 10, 64, dtype=BF16).transpose(1, 2)
    assert not do.is_contiguous()
    assert fk.bwd_route(q, k, v, o, do) == "wgmma"

    def unaligned(t):
        buf = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype)
        return buf[..., 1:]

    ins = [q, k, v, o, do]
    for i in range(5):
        moved = list(ins)
        moved[i] = unaligned(ins[i])
        assert fk.bwd_route(*moved) == "simt", i
    assert fk.route(q, k, v) == "wgmma"


def test_bwd_route_counters_start_at_zero_for_every_route():
    assert set(fk.flash_attention_bwd.launches_by_route) == set(fk.ROUTES)
    assert set(rk.rmsnorm_bwd.launches_by_route) == set(rk.ROUTES) == {
        "regs", "loop"}


@pytest.mark.parametrize("rows,D,dtype,aligned,want", [
    (4096, 896, BF16, True, (4, 2, 256, 8)),     # phase 17: 2 rows a warp
    (4097, 896, BF16, True, (4, 3, 171, 8)),     # 3 a warp, ragged block
    (1024, 896, BF16, True, (4, 1, 128, 8)),
    (8, 896, BF16, True, (4, 1, 1, 8)),
    (3, 256, BF16, True, (1, 1, 1, 8)),          # a vector a lane
    (37, 512, F32, True, (4, 1, 5, 4)),          # f32: 4 elements a vector
    (32768, 1024, BF16, True, (4, 16, 256, 8)),  # the widest regs row
    (4096, 2048, BF16, True, (0, 4, 1024, 1)),   # past 4 vectors a lane
    (1000, 2048, F32, True, (0, 1, 1000, 1)),
    (5, 99, BF16, True, (0, 1, 5, 1)),           # odd D
    (4096, 896, BF16, False, (0, 4, 1024, 1)),   # unaligned
])
def test_rmsnorm_bwd_plan(rows, D, dtype, aligned, want):
    p = rk.bwd_plan(rows, D, dtype, aligned)
    assert tuple(p) == want
    assert p.route == ("regs" if want[0] else "loop")


def test_rmsnorm_bwd_plan_depends_on_the_shape_alone(monkeypatch):
    """The plan takes (rows, D, dtype, alignment) and asks the device
    nothing: a shape sums dw in one order on every card."""
    assert list(inspect.signature(rk.bwd_plan).parameters) == [
        "rows", "D", "dtype", "aligned"]

    def no_device(*a, **kw):
        raise AssertionError("bwd_plan asked the device")

    for name in ("get_device_properties", "device_count",
                 "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert rk.bwd_plan(4096, 896, BF16) == rk.bwd_plan(4096, 896, BF16)


def test_rmsnorm_bwd_partial_near_1_mb_at_the_training_shape():
    """4 x 1,024 rows of 896: 256 blocks of 16 rows, a 917,504-byte f32
    dw partial (the loop route's 1,024 blocks write 3.67 MB)."""
    p = rk.bwd_plan(4096, 896, BF16)
    assert p.blocks * 896 * 4 == 917_504
    loop = rk.bwd_plan(4096, 896, BF16, aligned=False)
    assert loop.blocks * 896 * 4 == 3_670_016


def test_rmsnorm_bwd_plan_covers_each_row():
    """Every row falls in one block; the regs route's lanes hold every
    vector of a row, its blocks stay at most BWD_REGS_BLOCKS and the
    loop's at most BWD_MAX_BLOCKS."""
    for rows in (1, 7, 8, 64, 2047, 2048, 2049, 4096, 100_000):
        for D in (8, 16, 256, 896, 1000, 1024, 2048, 4096):
            for dt in (BF16, F32):
                p = rk.bwd_plan(rows, D, dt)
                if p.route == "regs":
                    per_block = rk.BWD_WARPS * p.rows_each
                    assert 32 * p.per_thread * p.vec >= D
                    assert p.per_thread in (1, 2, 4)
                    assert p.blocks <= rk.BWD_REGS_BLOCKS
                else:
                    per_block = p.rows_each
                    assert p.blocks <= rk.BWD_MAX_BLOCKS
                assert (p.blocks - 1) * per_block < rows <= (
                    p.blocks * per_block)


# --------------------------------------------- the wgmma route's arithmetic
def _mask(Sq, Skv, causal, window, q_offset):
    """[Sq, Skv]: the pairs the kernel's masks keep."""
    pos = torch.arange(Sq)[:, None] + q_offset
    key = torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= key <= pos
    if window:
        keep &= key > pos - window
    return keep


def emulate_wgmma_bwd(q, k, v, do, *, causal=True, window=0, q_offset=0,
                      rounded=True):
    """(dq, dk, dv) as the wgmma route computes them, in f32 with P and
    dS rounded to bf16 (``rounded``) before the products that consume
    them; the gradients rounded once to q's dtype."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    rep, scale = H // Hkv, Dh ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
    keep = _mask(Sq, Skv, causal, window, q_offset)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    s = s.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)       # the forward's
    p = torch.exp(s - lse).masked_fill(~keep, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype).float()
    delta = (dof * o).sum(-1).transpose(1, 2)[..., None]   # [B, H, Sq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta)
    if rounded:
        p, ds = p.to(BF16).float(), ds.to(BF16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    fold = lambda t: t.reshape(B, Skv, Hkv, rep, -1).sum(3)
    return dq.to(q.dtype), fold(dk).to(q.dtype), fold(dv).to(q.dtype)


CASES = [
    ((1, 128, 128, 14, 2, 64, 64), {}),                       # qwen2
    ((1, 96, 96, 4, 1, 256, 256), {"window": 32}),            # gemma3
    ((2, 40, 72, 4, 2, 32, 48), {"window": 30, "q_offset": 40}),
    ((1, 64, 80, 6, 6, 64, 64), {"causal": False}),           # cross
    ((1, 64, 64, 4, 4, 192, 128), {}),                        # MLA
]


def _inputs(B, Sq, Skv, H, Hkv, Dh, Dv, dt, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    arrs = r(B, Sq, H, Dh), r(B, Skv, Hkv, Dh), r(B, Skv, Hkv, Dv), r(
        B, Sq, H, Dv)
    return arrs, [torch.from_numpy(a).to(dt) for a in arrs]


def _within(got, want, tol):
    for g, w in zip(got, want):
        w = (w.float() if isinstance(w, torch.Tensor)
             else torch.from_numpy(np.array(w, dtype=np.float32)))
        err = float((g.float() - w).abs().max())
        assert err <= tol * float(w.abs().max()), (err, float(w.abs().max()))


@pytest.mark.parametrize("shape,kw", CASES)
def test_wgmma_arithmetic_unrounded_is_the_plain_backward(shape, kw):
    """In f32 without the bf16 roundings the route's formula, masks and
    group sums are the plain backward's within f32 noise."""
    _, (q, k, v, do) = _inputs(*shape, F32)
    got = emulate_wgmma_bwd(q, k, v, do, rounded=False, **kw)
    _within(got, attn_ref.mha_bwd(q, k, v, do, **kw), 1e-4)


@pytest.mark.parametrize("shape,kw", CASES)
def test_wgmma_roundings_match_plain_and_jax(shape, kw):
    """bf16 inputs, P and dS rounded to bf16: within 2**-5 of the plain
    version's bf16 gradients and of JAX's gradient of its reference
    attention on the same values."""
    arrs, (q, k, v, do) = _inputs(*shape, BF16)
    got = emulate_wgmma_bwd(q, k, v, do, **kw)
    _within(got, attn_ref.mha_bwd(q, k, v, do, **kw), 2.0**-5)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: j_attn.mha(a, b, c, **kw), jq, jk, jv)
    _within(got, vjp(jdo), 2.0**-5)
