"""The mesh slice's kernel routes on the card: on a one-rank NCCL mesh the
parameters, optimizer state and batches are DTensors and each kernel
runs on the rank's local shards (``kernels/_local.py``).  A training
step of reduced qwen2 on the mesh must equal the one-card step bit for
bit with the same kernel launches, and one MoE layer of reduced
deepseek-v2-lite (bf16, prefill phase) through ``moe.apply_sharded``
must follow the one-card ``moe.apply`` within the serving bound (2**-5
of the one-card output's largest magnitude; ``aux`` within 1e-6), with
finite, non-zero gradients in every leaf.  Every case needs a CUDA card
and skips without one; the file imports no JAX."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.launch import mesh as tmesh
    m = tmesh.make_host_mesh(device="cuda")
    yield m
    tmesh.close_world()


def _kernels():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    return (fk.flash_attention, fk.flash_attention_bwd, rk.rmsnorm,
            rk.rmsnorm_bwd)


def _counts():
    return {f.__name__: (f.launches, dict(f.launches_by_route))
            for f in _kernels()}


def _moved(a, b):
    return {k: (b[k][0] - a[k][0], {r: n - a[k][1].get(r, 0)
                                    for r, n in b[k][1].items()})
            for k in a}


def test_mesh_train_step_is_the_one_card_step_bitwise(mesh):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import optimizer as adamw
    from repro_torch.launch.train import Trainer
    cfg = reduced_config("qwen2-0.5b")
    runs = []
    for m in (None, mesh):
        tr = Trainer(cfg, mesh=m, device="cuda")
        p, o = tr.init(0)
        if m is not None:
            assert all(isinstance(t, DTensor) for t in p.parameters())
        c0 = _counts()
        p, o, losses = tr.run(p, o, iter(TokenStream(cfg.vocab_size, 4, 64,
                                                     seed=0)), 2)
        torch.cuda.synchronize()
        whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        state = [whole(t.detach()).clone() for t in adamw.leaves(p.tree())
                 + adamw.leaves(o.m) + adamw.leaves(o.v)]
        runs.append((losses, state, _moved(c0, _counts())))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert c0 == c1 and all(n > 0 for n, _ in c1.values()), (c0, c1)


def test_mesh_moe_layer_follows_the_one_card_layer(mesh):
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.cells import on_mesh
    from repro_torch.models.context import Ctx
    from repro_torch.models.layers import moe
    cfg = reduced_config("deepseek-v2-lite-16b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, specs = moe.init(gen, cfg)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device="cuda")
    x = x.to(torch.bfloat16)
    ref, ref_aux = moe.apply(p, x, Ctx(cdtype=torch.bfloat16,
                                       phase="prefill"), cfg=cfg)
    rules = shd.rules_for(mesh, phase="prefill")
    ctx = Ctx(cdtype=torch.bfloat16, phase="prefill", mesh=mesh,
              rules=rules, constrain=shd.make_constrainer(mesh, rules))
    assert moe._sharded_ok(cfg, ctx)
    pd = shd.distribute_tree(
        p, shd.tree_shardings(specs, p, mesh, rules), mesh)
    leaves = [pd[k] for k in ("router", "w_gate", "w_in", "w_out")] + \
        list(pd["shared"].values())
    for t in leaves:
        t.requires_grad_(True)
    xd = shd.distribute(x, mesh, shd.placements_for(
        ("act_batch", "act_seq", None), x.shape, mesh, rules))
    with on_mesh(mesh):
        y, aux = moe.apply(pd, xd, ctx, cfg=cfg)
        grads = torch.autograd.grad(y.float().sum() + aux, leaves)
        y, aux = y.full_tensor(), aux.full_tensor()
        grads = [g.full_tensor() for g in grads]
    err = float((y.float() - ref.float()).abs().max())
    assert err <= 2.0**-5 * float(ref.float().abs().max()), err
    assert abs(float(aux) - float(ref_aux)) < 1e-6
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
