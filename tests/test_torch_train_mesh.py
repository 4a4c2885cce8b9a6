"""``Trainer(mesh=...)`` and ``ServingEngine(mesh=...)`` on a one-rank
gloo mesh on the CPU.

On a (1, 1) mesh the parameters, optimizer state, batches and decode
states are DTensors and every step runs through DTensor's dispatch, yet
each rank holds whole tensors: the runs must equal the one-card runs
bit for bit.  The mesh trainer is also held to the JAX package's
``Trainer`` (which always runs on a host mesh) at
``test_torch_train_loop.py``'s tolerance, and reduced deepseek trains
on the mesh through ``moe.apply_sharded``.  Each test's fixture destroys
the process group at teardown.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.data.synthetic import TokenStream as JTokenStream
from repro.distributed import optimizer as j_adamw
from repro.launch.train import Trainer as JTrainer
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import optimizer as adamw
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import Request, ServeConfig, ServingEngine
from repro_torch.launch.train import Trainer
from repro_torch.models.layers import moe


@pytest.fixture
def mesh():
    m = tmesh.make_host_mesh(device="cpu")
    yield m
    tmesh.close_world()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _state(params, opt):
    return [_whole(t.detach()).clone() for t in adamw.leaves(params.tree())
            + adamw.leaves(opt.m) + adamw.leaves(opt.v) + [opt.count]]


def test_mesh_trainer_is_the_one_card_trainer_bitwise(mesh):
    from torch.distributed.tensor import DTensor
    cfg = reduced_config("qwen2-0.5b")
    runs = []
    for m in (None, mesh):
        tr = Trainer(cfg, mesh=m, device="cpu")
        p, o = tr.init(0)
        if m is not None:
            assert all(isinstance(t, DTensor) for t in p.parameters())
            assert all(isinstance(t, DTensor) for t in adamw.leaves(o.m))
        p, o, losses = tr.run(p, o, iter(TokenStream(cfg.vocab_size, 4, 32,
                                                     seed=0)), 3)
        runs.append((losses, _state(p, o)))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_mesh_trainer_follows_the_jax_trainer(mesh):
    """Three steps of both trainers (bf16 compute) from the JAX package's
    initial parameters: each loss within twice JAX's own bf16-vs-f32
    distance at that step (``test_torch_train_loop.py``'s rule)."""
    jcfg, cfg = j_reduced_config("qwen2-0.5b"), reduced_config("qwen2-0.5b")
    jt = JTrainer(jcfg)
    jp, jo = jt.init(0)
    init = jax.tree.map(np.asarray, jp)
    batches = [b for _, b in zip(range(3), JTokenStream(
        jcfg.vocab_size, 4, 64, seed=0))]
    _, _, jl = jt.run(jp, jo, iter(batches), 3)

    jm = jlm.build(jcfg)
    opt_cfg = j_adamw.AdamWConfig()

    @jax.jit
    def f32_step(p, o, b):
        loss, g = jax.value_and_grad(lambda p: jlm.train_loss(
            jm, p, b, JCtx(cdtype=jnp.float32)))(p)
        p, o, _ = j_adamw.update(p, g, o, opt_cfg)
        return p, o, loss

    p, o, fl = jax.tree.map(jnp.asarray, init), j_adamw.init(init), []
    for b in batches:
        p, o, loss = f32_step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        fl.append(float(loss))

    tt = Trainer(cfg, mesh=mesh, device="cpu")
    tp, to = tt.init(0)
    src = convert.lm_params_from_numpy(init, cfg, device="cpu")
    with torch.no_grad():
        for dst, v in zip(adamw.leaves(tp.tree()), adamw.leaves(src.tree())):
            dst.to_local().copy_(v)
    _, to, tl = tt.run(tp, to, iter(batches), 3)
    assert int(to.count) == 3
    for step, (got, want, f32) in enumerate(zip(tl, jl, fl)):
        assert abs(got - want) <= 2 * abs(want - f32), (step, got, want, f32)


def test_deepseek_trains_on_the_mesh_through_apply_sharded(mesh):
    """Two steps of reduced deepseek on the mesh: the MoE layers take the
    expert-parallel path, the losses are finite, the first equals the
    one-card trainer's to 1e-5 (the same weights; the two paths' bf16
    sums run in different orders) and the second follows it to 1e-3
    (the first step's bf16 gradients, summed in another order, move the
    weights apart by a few bf16 roundings)."""
    cfg = reduced_config("deepseek-moe-16b")
    calls = []
    orig = moe.apply_sharded
    moe.apply_sharded = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        runs = []
        for m in (None, mesh):
            tr = Trainer(cfg, mesh=m, device="cpu")
            p, o = tr.init(0)
            _, _, losses = tr.run(p, o, iter(TokenStream(
                cfg.vocab_size, 2, 16, seed=0)), 2)
            runs.append(losses)
    finally:
        moe.apply_sharded = orig
    assert calls                      # only the mesh run takes it
    assert all(np.isfinite(runs[1]))
    assert abs(runs[0][0] - runs[1][0]) < 1e-5, runs
    assert abs(runs[0][1] - runs[1][1]) < 1e-3, runs


def test_mesh_serving_engine_tokens_equal_the_one_card_engine(mesh):
    cfg = reduced_config("qwen2-0.5b")

    def serve(m):
        eng = ServingEngine(cfg, ServeConfig(n_slots=4, cache_len=64,
                                             prompt_bucket=16),
                            mesh=m, device="cpu")
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, size=rng.integers(4, 20)).astype(
                np.int32), max_new=6))
        eng.run(12)
        return eng, {r.rid: r.tokens_out for r in eng.finished}

    _, want = serve(None)
    eng, got = serve(mesh)
    assert len(want) == 6 and got == want
    assert hasattr(eng.states[0][0]["k"], "device_mesh")
