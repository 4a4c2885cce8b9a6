"""The plain-Python halves of the SSM kernels' launches, on the CPU: which
route ``ssd_scan`` takes (tensor cores for bf16 with N and P of 16, 32, 64
or 128, a chunk whose tiles fit shared memory and 16-byte aligned views;
CUDA cores for the rest), the chunk and shared memory of the tensor-core
route, and how ``rmsnorm`` spreads a row over threads.

Then the tensor-core route's arithmetic, emulated in plain torch: the
decayed scores rounded to bf16 before the product with V, the carried
state rounded to bf16 before the product with q, and the state update's
k * exp(cum_last - cum) split into a bf16 high and a bf16 low part, two
products summed in f32.  It is held against the plain version
(``kernels/ssd/ref.py``) and the JAX package's ``repro.kernels.ssd.ref``
within the kernel tests' tolerances (y within 2e-2 of max|y| + 1, the
state within 5e-4 of max|state| + 1); one bf16 rounding of k * wend
misses the state's tolerance.  The kernels themselves run only on the
card (``tests/test_torch_ssm_kernel.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ssd.ref import ssd as j_ssd
from repro_torch.kernels.rmsnorm import kernel as rk
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd_scan import kernel as sk

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,N,P,chunk,aligned,want", [
    (BF16, 64, 64, 256, True, "mma"),     # zamba2-1.2b's prefill
    (F32, 64, 64, 256, True, "simt"),     # f32 would round on the tensor cores
    (BF16, 12, 64, 256, True, "simt"),    # N not a multiple of 16
    (BF16, 48, 64, 256, True, "simt"),    # N not compiled for the route
    (BF16, 64, 16, 64, True, "mma"),      # P 16
    (BF16, 64, 8, 256, True, "simt"),     # P = 8
    (BF16, 128, 64, 256, True, "mma"),    # N = 128
    (BF16, 128, 128, 256, True, "simt"),  # one head's tiles overflow smem
    (BF16, 128, 32, 32, True, "mma"),     # chunk 32
    (BF16, 64, 64, 8, True, "simt"),      # chunk not a multiple of 16
    (BF16, 64, 64, 512, True, "simt"),    # chunk past 256 rows
    (BF16, 64, 64, 256, False, "simt"),   # an unaligned view
])
def test_ssd_route_of(dtype, N, P, chunk, aligned, want):
    assert sk.route_of(dtype, N, P, chunk, aligned) == want


def test_ssd_route_reads_the_tensors():
    """Mamba-2's head-broadcast q and k (head stride 0) are aligned views
    (the tensor-core route); a view one element into a buffer is not; a
    sequence shorter than its chunk runs one chunk of S rounded to 16."""
    B, S, H, N, P = 2, 40, 4, 16, 16
    q = torch.zeros((B, S, 1, N), dtype=BF16).expand(B, S, H, N)
    v = torch.zeros((B, S, H, P), dtype=BF16)
    assert sk.route(q, q, v) == "mma"
    assert sk.route(q.float(), q.float(), v.float()) == "simt"
    buf = torch.zeros((B, S, H, N + 1), dtype=BF16)[..., 1:]
    assert sk.route(buf, buf, v) == "simt"
    assert sk.route(q, q, v, chunk=24) == "simt"
    assert sk.mma_chunk(S, 256) == 48


@pytest.mark.parametrize("S,chunk,want", [
    (256, 256, 256), (2048, 256, 256), (200, 64, 64), (130, 256, 144),
    (1, 256, 16), (96, 32, 32)])
def test_ssd_mma_chunk(S, chunk, want):
    assert sk.mma_chunk(S, chunk) == want


def test_ssd_smem_at_the_serving_shape():
    """One chunk: Q, K and V [256, 72] in bf16 and cum and wend in f32,
    112,640 bytes, under the 227 KB a block may have (two blocks an SM);
    a carried chunk adds the bf16 state [64, 72]."""
    assert sk.smem_bytes(256, 64, 64, False) == 112640 <= sk.MMA_SMEM
    assert sk.smem_bytes(256, 64, 64, True) == 112640 + 64 * 72 * 2
    assert sk.smem_bytes(256, 128, 128, True) > sk.MMA_SMEM


def test_route_counters_start_at_zero_for_every_route():
    assert set(sk.ssd_scan.launches_by_route) == set(sk.ROUTES) == {
        "mma", "simt"}
    assert set(rk.rmsnorm.launches_by_route) == set(rk.ROUTES) == {
        "regs", "loop"}


@pytest.mark.parametrize("rows,D,want", [
    (8, 896, (32, 4, 8, 4)),         # qwen2 decode: one warp a row
    (8, 2048, (256, 1, 8, 1)),       # zamba2 decode: a vector a thread
    (8, 4096, (512, 1, 8, 1)),       # Mamba-2's gated norm in decode
    (2048, 896, (32, 4, 8, 4)),      # prefill
    (2048, 2048, (128, 1, 8, 2)),
    (2048, 4096, (128, 1, 8, 4)),
])
def test_rmsnorm_plan_serving_shapes(rows, D, want):
    p = rk.plan(rows, D, BF16)
    assert tuple(p) == want and p.route == "regs"


@pytest.mark.parametrize("rows,D,dtype,aligned,want", [
    (5, 99, BF16, True, (256, 1, 1, 0)),          # odd D: the loop
    (2048, 2048, F32, True, (128, 1, 4, 4)),      # f32: 4 elements a vector
    (37, 1000, F32, True, (256, 1, 4, 1)),
    (8, 2048, BF16, False, (256, 1, 1, 0)),       # unaligned: the loop
    (4, 2 ** 17, BF16, True, (256, 1, 1, 0)),     # past 8 x 1024 vectors
    (2, 8, BF16, True, (32, 4, 8, 1)),
])
def test_rmsnorm_plan_other_shapes(rows, D, dtype, aligned, want):
    assert tuple(rk.plan(rows, D, dtype, aligned)) == want


def test_rmsnorm_plan_covers_each_row():
    """On the register route the row's threads hold every vector of it
    and a block has at most the threads its registers allow."""
    for rows in (1, 8, 64, 65, 2048):
        for D in (8, 16, 256, 896, 1000, 2048, 4096, 8192, 65536):
            for dt in (BF16, F32):
                p = rk.plan(rows, D, dt)
                if p.route == "loop":
                    continue
                assert p.threads_per_row % 32 == 0
                assert (p.threads_per_row * p.rows_per_block
                        <= rk.max_block(p.per_thread) <= rk.MAX_BLOCK)
                assert p.per_thread in (1, 2, 4, 8)
                assert p.threads_per_row * p.per_thread * p.vec >= D
                assert D % p.vec == 0


# ------------------------------------------------- the mma route emulated
def _inputs(B, S, H, N, P, seed, shared):
    """bf16 q, k (head-broadcast views when ``shared``), v and f32 log_a
    <= 0, as the JAX package's sweep makes them."""
    rng = np.random.default_rng(seed)
    Hq = 1 if shared else H
    q = rng.standard_normal((B, S, Hq, N)).astype(np.float32)
    k = (rng.standard_normal((B, S, Hq, N)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    q, k = (torch.from_numpy(x).to(BF16).expand(B, S, H, N) for x in (q, k))
    return q, k, torch.from_numpy(v).to(BF16), torch.from_numpy(la)


def _emulate_mma(q, k, v, log_a, chunk, split=True):
    """The "mma" route's arithmetic in f32: the chunk of ``mma_chunk``,
    bf16 decayed scores into the product with V, bf16 carried state into
    the product with q, and k * wend split into bf16 hi + lo parts (one
    bf16 rounding when ``split`` is False)."""
    f32 = torch.float32
    B, S, H, N = q.shape
    L = sk.mma_chunk(S, chunk)
    pad = (-S) % L
    zp = lambda x: torch.nn.functional.pad(x.to(f32),
                                           (0, 0) * (x.ndim - 2) + (0, pad))
    q, k, v, log_a = zp(q), zp(k), zp(v), zp(log_a)
    bf = lambda x: x.to(BF16).to(f32)
    state = torch.zeros((B, H, N, v.shape[-1]), dtype=f32)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    ys = []
    for c in range((S + pad) // L):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, vb = q[:, sl], k[:, sl], v[:, sl]
        cum = torch.cumsum(log_a[:, sl], dim=1)                   # [B,L,H]
        ct = cum.transpose(1, 2)
        decay = torch.where(tri, torch.exp(ct[..., :, None]
                                           - ct[..., None, :]), 0.0)
        g = bf(torch.einsum("blhn,bmhn->bhlm", qb, kb) * decay)
        y = torch.einsum("bhlm,bmhp->blhp", g, vb)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "blhn,bhnp->blhp", qb, bf(state))
        x = kb * torch.exp(cum[:, -1:] - cum)[..., None]
        hi = bf(x)
        s_chunk = torch.einsum("blhn,blhp->bhnp", hi, vb)
        if split:
            s_chunk = s_chunk + torch.einsum("blhn,blhp->bhnp", bf(x - hi),
                                             vb)
        state = torch.exp(cum[:, -1])[..., None, None] * state + s_chunk
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(BF16), state


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1.0)


# the card tests' "mma" shapes, with the serving shape's B and H cut
# (S, N, P and the chunk kept) so that the CPU keeps up
@pytest.mark.parametrize("B,S,H,N,P,chunk,shared", [
    (2, 256, 16, 64, 64, 256, True),     # the serving shape, fewer heads
    (1, 1024, 8, 64, 64, 256, True),     # 4 chunks
    (1, 200, 3, 32, 16, 64, False),      # ragged last chunk
    (2, 256, 4, 64, 32, 256, False),     # P != N
    (1, 96, 2, 128, 32, 32, False),      # N 128, chunk 32
])
def test_mma_roundings_match_plain_and_jax(B, S, H, N, P, chunk, shared):
    q, k, v, la = _inputs(B, S, H, N, P, S + N + P, shared)
    assert sk.route(q, k, v, chunk) == "mma"
    y, fin = _emulate_mma(q, k, v, la, chunk)
    wy, wfin = ssd_ref.ssd(q, k, v, la, chunk=chunk)
    assert _rel(y.float(), wy.float()) < 2e-2
    assert _rel(fin, wfin) < 5e-4
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jy, jfin = j_ssd(j(q), j(k), j(v), jnp.asarray(la.numpy()), chunk=chunk)
    assert _rel(y.float(), jy) < 2e-2
    assert _rel(fin, jfin) < 5e-4


def test_one_bf16_rounding_of_the_state_update_misses_the_tolerance():
    """At the serving shape's S, N, P and chunk, k * wend rounded to bf16
    once puts the final state past 5e-4 of max|state| + 1; the hi/lo
    split keeps it near 1e-5."""
    q, k, v, la = _inputs(2, 256, 16, 64, 64, 256 + 128, True)
    _, wfin = ssd_ref.ssd(q, k, v, la, chunk=256)
    _, once = _emulate_mma(q, k, v, la, 256, split=False)
    _, split = _emulate_mma(q, k, v, la, 256, split=True)
    assert _rel(once, wfin) > 5e-4
    assert _rel(split, wfin) < 5e-5
