"""The port's cells and cost counter on a ``fake`` (4, 2) world on the CPU
(``launch/cells.py``, ``analysis/cost.py``; JAX's
``tests/test_dryrun_small.py`` lowers the same four cells).

The fake world's collectives move nothing and every tensor is ``meta``,
so these tests check shapes, placements and counts, not values: the
four cells build with the arguments' local shapes, a small decode cell's
FLOPs equal a hand count, the eager form of the walker's scan test
counts its products and gathers, a sharded restore puts each rank's
shard in place bit for bit, and a kernel route on DTensors sees local
shards, or, where a reduced dim is split, the rank's slice and one
all-gather of partials.  The fixture destroys the world at teardown.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import cost
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.launch import cells
from repro_torch.launch import mesh as tmesh

CASES = [
    ("qwen2-0.5b", "train_4k"),
    ("gemma3-1b", "decode_32k"),
    ("xlstm-350m", "long_500k"),
    ("whisper-tiny", "prefill_32k"),
]


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh
    tmesh.start_fake_world(8)
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    tmesh.close_world()


def _leaves(t):
    if isinstance(t, torch.nn.Module):
        return list(t.parameters())
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t] if isinstance(t, torch.Tensor) else []


@pytest.mark.parametrize("arch,shape", CASES)
def test_build_cell_on_fake_mesh(mesh, arch, shape):
    from torch.distributed.tensor import DTensor
    cell = cells.build_cell(arch, shape, mesh)
    args = [t for t in _leaves(cell.abstract_args) if t.ndim]
    assert args and all(isinstance(t, DTensor) for t in args)
    assert all(t.device.type == "meta" for t in args)
    rules = cell.rules
    for t in args:
        # every placement is a divisor-respecting shard or a replica
        shape_ = t.to_local().shape
        for p, n in zip(t.placements, (4, 2)):
            if p.is_shard():
                assert t.shape[p.dim] % n == 0
        assert np.prod(shape_) <= np.prod(t.shape)
    batch = cell.abstract_args[-1] if cell.shape.phase != "decode" else \
        cell.abstract_args[1]
    # the batch dim is split over "data" where it divides
    lead = batch if isinstance(batch, torch.Tensor) else \
        next(iter(batch.values()))
    want = lead.shape[0] // 4 if lead.shape[0] % 4 == 0 else lead.shape[0]
    assert lead.to_local().shape[0] == want
    assert rules["act_batch"] == ("data",)


def _tiny():
    return get_config("qwen2-0.5b").replace(
        n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512)


def test_small_decode_cell_flops_equal_hand_count(mesh, monkeypatch):
    """One qwen2 layer at decode_32k (B = 128, a 32,768-row cache):
    every product of the step is split evenly over the 8 ranks (batch
    over "data"; heads, ffn and vocab over "model"), so a rank does an
    eighth of the step's matmul FLOPs."""
    cfg = _tiny()
    monkeypatch.setattr(cells, "get_config", lambda arch: cfg)
    cell = cells.build_cell("qwen2-0.5b", "decode_32k", mesh)
    low = cells.lower_cell(cell)
    B, S, D, H, Hkv, Dh, F, V = 128, 32768, 64, 4, 2, 16, 128, 512
    total = (2 * B * D * H * Dh                  # q
             + 2 * 2 * B * D * Hkv * Dh          # k, v
             + 2 * 2 * B * H * S * Dh            # scores, p @ v
             + 2 * B * H * Dh * D                # out projection
             + 3 * 2 * B * D * F                 # gated ffn
             + 2 * B * D * V)                    # logits
    assert low.cost.flops == total / 8, (low.cost.flops, total / 8)
    # the caches (bf16 [1, B, S, Hkv, Dh] k and v) are the arguments'
    # bulk: a rank holds an eighth
    cache = 2 * B * S * Hkv * Dh * 2 // 8
    assert cache <= low.argument_bytes < cache * 1.1
    assert low.peak_bytes >= low.argument_bytes
    assert low.cost.hbm_bytes > 0
    assert low.cost.collective_bytes["all-reduce"] > 0


def _scan_inputs(mesh1d):
    from torch.distributed.tensor import Shard, distribute_tensor
    x = distribute_tensor(torch.empty(128, 256, device="meta"), mesh1d,
                          [Shard(0)])
    w = distribute_tensor(torch.empty(256, 256, device="meta"), mesh1d,
                          [Shard(1)])
    return x, w


@pytest.fixture(scope="module")
def mesh8(mesh):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))


def test_eager_scan_counts_hoisted_gather(mesh8):
    """``test_walker_counts_scan_trip_counts`` eagerly: 16 chained
    products of x [128, 256] (rows over 8 ranks) with w [256, 256]
    (columns over 8 ranks), w gathered once before the loop (XLA hoists
    that gather): FLOPs 16 x 2 x 16 x 256 x 256 and one all-gather of a
    rank's w shard, 256 x 32 x 4 bytes -- the JAX test's numbers."""
    from torch.distributed.tensor import Replicate

    def f(x, w):
        w = w.redistribute(w.device_mesh, [Replicate()])
        c = x
        for _ in range(16):
            c = torch.tanh(c @ w)
        return c

    c = cost.lower(f, *_scan_inputs(mesh8)).cost
    assert c.flops == 16 * 2 * 16 * 256 * 256
    assert c.collective_bytes["all-gather"] == 256 * 32 * 4
    assert c.total_collective_bytes == 256 * 32 * 4


def test_eager_scan_counts_every_relayout_without_hoisting(mesh8):
    """The same loop without the hoist: nothing is hoisted eagerly, and
    DTensor's sharding propagation picks each product's layout.  The
    first product gathers x (a [16, 256] f32 row shard, 16,384 bytes)
    and leaves c split on its columns; the next one then takes w to row
    shards (an all-to-all of a [256, 32] shard, 32,768 bytes), contracts
    over the split dim and all-reduces the partial [128, 256] product
    (131,072 bytes) for the tanh, which leaves c whole, and the one
    after that splits columns again with no communication.  So: one
    all-gather, then 8 x (all-to-all, all-reduce).  Every product is
    split 8 ways, so the FLOPs are the hoisted loop's."""
    def f(x, w):
        c = x
        for _ in range(16):
            c = torch.tanh(c @ w)
        return c

    low = cost.lower(f, *_scan_inputs(mesh8))
    assert low.cost.flops == 16 * 2 * 16 * 256 * 256
    kinds = [(k, b) for k, b, _ in low.collectives]
    assert kinds == [("all-gather", 16384.0)] + [
        ("all-to-all", 32768.0), ("all-reduce", 131072.0)] * 8, kinds


def test_transition_kinds(mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard
    t = cost.transition_bytes
    assert t((Shard(0), Shard(1)), (Shard(0), Replicate()), mesh, 64) == [
        ("all-gather", 64.0)]
    assert t((Partial(), Replicate()), (Replicate(), Replicate()), mesh,
             64) == [("all-reduce", 64.0)]
    assert t((Replicate(), Partial()), (Replicate(), Shard(0)), mesh,
             64) == [("reduce-scatter", 64.0)]
    assert t((Shard(0), Replicate()), (Shard(1), Replicate()), mesh, 64) == [
        ("all-to-all", 64.0)]
    assert t((Replicate(), Replicate()), (Shard(0), Shard(1)), mesh, 64) == []


def test_restore_with_shardings_round_trips(mesh, tmp_path):
    """A checkpoint restored onto the (4, 2) mesh: each leaf comes back a
    DTensor in the given placements whose local shard is rank 0's slice
    of what was saved, bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 6)).astype(
                np.float32)).to(torch.bfloat16),
            "b": [torch.from_numpy(rng.standard_normal((4, 4)).astype(
                np.float32))],
            "count": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree, blocking=True)
    ck.close()
    pls = {"a": (Shard(0), Shard(1)), "b": [(Replicate(), Shard(0))],
           "count": None}
    out = Checkpointer(str(tmp_path)).restore(3, tree, pls, mesh=mesh)
    assert isinstance(out["a"], DTensor) and isinstance(out["b"][0], DTensor)
    assert tuple(out["a"].placements) == pls["a"]
    assert torch.equal(out["a"].to_local(), tree["a"][:2, :3])
    assert torch.equal(out["b"][0].to_local(), tree["b"][0][:2])
    assert torch.equal(out["count"], tree["count"])


def _patched_kernels(monkeypatch, seen):
    """Swap the kernel wrappers for recorders that refuse DTensors and
    return plain outputs of the right shape."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk

    def rec(name, out_of):
        def f(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            assert not any(isinstance(a, DTensor) for a in ts), name
            seen.append((name, [tuple(a.shape) for a in ts]))
            return out_of(*ts)
        return f
    monkeypatch.setattr(fk, "flash_attention", rec(
        "flash_attention", lambda q, k, v: torch.empty(
            q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)))
    monkeypatch.setattr(rk, "rmsnorm", rec(
        "rmsnorm", lambda x, w: torch.empty_like(x)))
    monkeypatch.setattr(dk, "decode_attention", rec(
        "decode_attention", lambda q, k, v, n: torch.empty(
            q.shape[:3] + v.shape[3:], dtype=q.dtype, device=q.device)))


def test_kernel_routes_see_local_shards(mesh, monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rmsnorm import ops as rops
    seen = []
    _patched_kernels(monkeypatch, seen)

    def dt(shape, pl, dtype=torch.bfloat16):
        return shd.distribute(torch.empty(shape, dtype=dtype, device="meta"),
                              mesh, pl)
    # batch over data, heads over model
    q = dt((8, 16, 4, 16), (Shard(0), Shard(2)))
    kv = dt((8, 16, 2, 16), (Shard(0), Shard(2)))
    o = aops.mha(q, kv, kv, impl="cuda")
    assert isinstance(o, DTensor) and tuple(o.placements) == (
        Shard(0), Shard(2)) and o.shape == q.shape
    assert seen[-1] == ("flash_attention", [(2, 16, 2, 16), (2, 16, 1, 16),
                                            (2, 16, 1, 16)])
    # kv heads replicated while q's are split: q is gathered to match
    kv_r = dt((8, 16, 2, 16), (Shard(0), Replicate()))
    aops.mha(q, kv_r, kv_r, impl="cuda")
    assert seen[-1][1][0] == (2, 16, 4, 16)
    # rmsnorm over rows split on the sequence
    x = dt((8, 16, 64), (Shard(0), Shard(1)))
    w = dt((64,), (Replicate(), Replicate()), torch.float32)
    y = rops.rmsnorm(x, w, impl="cuda")
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert seen[-1] == ("rmsnorm", [(2, 8, 64), (64,)])
    # decode attention over a cache split on batch and heads
    qd = dt((8, 1, 4, 16), (Shard(0), Shard(2)))
    cache = dt((8, 32, 2, 16), (Shard(0), Shard(2)))
    lens = dt((8,), (Shard(0), Replicate()), torch.int32)
    dops.decode_attend(qd, cache, cache, lens, impl="cuda")
    assert seen[-1][1][-1] == (2,)


def test_kernel_routes_refuse_cross_rank_reductions(mesh, monkeypatch):
    """Where a dim a kernel reduces over is split across ranks, the route
    no longer refuses: each of the three runs its kernel on the rank's
    slice at its offset (this fake world's rank 0: offset 0), then one
    all-gather of the partials over the splitting mesh dim, and wraps the
    merge back.  The refusal left is a gradient through the ``ssd_scan``
    kernel, which has no backward yet (ROADMAP queue 1 item 22)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import _local
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd_scan import kernel as sk
    seen = []

    def rec(name, out_of):
        def f(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            assert not any(isinstance(a, DTensor) for a in ts), name
            seen.append((name, [tuple(a.shape) for a in ts],
                         {k: tuple(v.shape) if isinstance(v, torch.Tensor)
                          else v for k, v in kw.items()}))
            return out_of(*ts, **kw)
        return f
    f32 = torch.float32
    monkeypatch.setattr(rk, "rmsnorm_sums", rec(
        "rmsnorm_sums", lambda x, **kw: torch.empty(
            x.shape[:-1], dtype=f32, device=x.device)))
    monkeypatch.setattr(rk, "rmsnorm", rec(
        "rmsnorm", lambda x, w, **kw: torch.empty_like(x)))
    monkeypatch.setattr(dk, "decode_attention", rec(
        "decode_attention", lambda q, k, v, n, **kw: (
            torch.empty(q.shape[:3] + v.shape[3:], dtype=f32,
                        device=q.device),
            torch.empty(q.shape[:3], dtype=f32, device=q.device))))
    monkeypatch.setattr(sk, "ssd_scan", rec(
        "ssd_scan", lambda q, k, v, la, **kw: (
            torch.empty_like(v), torch.empty(
                q.shape[:1] + q.shape[2:] + v.shape[3:], dtype=f32,
                device=q.device))))

    def dt(shape, pl):
        return shd.distribute(torch.empty(shape, device="meta"), mesh, pl)

    def gathers(fn):
        g0 = _local.GATHERS["all_gather"]
        out = fn()
        return out, _local.GATHERS["all_gather"] - g0
    # rmsnorm over a row split on "model" (2 ranks): partial sums of the
    # rank's 32 columns, one gather, then the normalise pass over D = 64
    x = dt((8, 16, 64), (Shard(0), Shard(2)))
    y, n = gathers(lambda: rops.rmsnorm(
        x, dt((64,), (Replicate(), Replicate())), impl="cuda"))
    assert n == 1 and tuple(y.placements) == (Shard(0), Shard(2))
    assert seen[-2] == ("rmsnorm_sums", [(2, 16, 32)],
                        {"scale_offset": False})
    assert seen[-1][:2] == ("rmsnorm", [(2, 16, 32), (32,)])
    assert seen[-1][2]["ss"] == (2, 16) and seen[-1][2]["d_norm"] == 64
    # decode attention over a cache whose sequence is split on "model":
    # the partial route on the rank's 16 rows at offset 0 of 32
    cache = dt((8, 32, 2, 16), (Shard(0), Shard(1)))
    q = dt((8, 1, 2, 16), (Shard(0), Replicate()))
    o, n = gathers(lambda: dops.decode_attend(
        q, cache, cache, dt((8,), (Shard(0), Replicate())), impl="cuda"))
    assert n == 1 and tuple(o.placements) == (Shard(0), Replicate())
    name, shapes, kw = seen[-1]
    assert name == "decode_attention" and shapes == [
        (2, 1, 2, 16), (2, 16, 2, 16), (2, 16, 2, 16), (2,)]
    assert kw["partial"] and kw["seq_offset"] == 0 and kw["seq_total"] == 32
    # the SSD scan over a sequence split on "model": the rank's 32 rows
    # from zero, one gather of (final, decay); rank 0 scans once
    qs = dt((8, 64, 4, 16), (Shard(0), Shard(1)))
    la = dt((8, 64, 4), (Shard(0), Shard(1)))
    (y, fin), n = gathers(lambda: sops.ssd(qs, qs, qs, la, chunk=16,
                                           impl="cuda"))
    assert n == 1 and tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(fin.placements) == (Shard(0), Replicate())
    assert seen[-1][:2] == ("ssd_scan", [(2, 32, 4, 16)] * 3 + [(2, 32, 4)])
    assert seen[-1][2]["initial_state"] is None
    # a gradient through the kernel still raises, naming item 22
    qg = dt((8, 64, 4, 16), (Shard(0), Shard(1))).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="item 22"):
        sops.ssd(qg, qg, qg, la, chunk=16, impl="cuda")


@pytest.mark.parametrize("arch,shape", CASES)
def test_lower_cell_on_fake_mesh(mesh, arch, shape):
    """Each cell's step runs once under the cost counter on the fake
    (4, 2) world, as JAX's ``tests/test_dryrun_small.py`` lowers the same
    four: xlstm-350m's ``long_500k`` decode step takes its argmax over
    the vocab-split logits (``spmd.argmax_last`` gathers the vocab over
    "model" first; DTensor's own rule failed there)."""
    low = cells.lower_cell(cells.build_cell(arch, shape, mesh))
    assert low.cost.flops > 0 and low.cost.hbm_bytes > 0
    assert 0 < low.argument_bytes <= low.peak_bytes
    if cells.SHAPE_BY_NAME[shape].phase == "decode":
        # the step's last collective: the last position's logits [B, V],
        # their vocab split over "model", gathered whole for the argmax
        kind, _, how = low.collectives[-1]
        assert kind == "all-gather" and how.endswith(
            "Shard(dim=1)) -> " + how.split(" -> ")[1]), how
        assert how.split(" -> ")[1].endswith("Replicate())"), how


def test_argmax_over_split_vocab_on_two_ranks(tmp_path):
    """Two gloo ranks, a (1, 2) mesh with the last dim split over
    "model": ``spmd.argmax_last`` gives the first maximal index, as
    ``torch.argmax`` of the whole tensor does, where a maximum appears
    in both halves, twice in one half, or everywhere; and reduced
    xlstm-350m's decode step (``cells.make_decode_step``, the
    ``ServingEngine``'s) gives ``torch.argmax`` of its vocab-split
    logits made whole."""
    import pickle
    import socket

    import torch.multiprocessing as mp
    from tests import _argmax_ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank0.pkl")
    mp.spawn(_argmax_ranks.worker, args=(2, port, out), nprocs=2, join=True)
    with open(out, "rb") as f:
        res = pickle.load(f)
    got, whole = res["ties"]
    assert got.tolist() == whole.tolist() == [1, 5, 3, 0]
    token, want, placements = res["xlstm"]
    assert placements == ["R", "S(2)"]       # [B, 1, V], V over "model"
    assert token.tolist() == want.tolist()
