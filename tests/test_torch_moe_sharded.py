"""The port's expert-parallel MoE (``moe.apply_sharded``) against the
JAX package's on the CPU.

The three cases of ``tests/test_moe_sharded.py`` run on a one-rank gloo
world (torn down by the fixture), held to JAX's own ``apply`` on its
``(1, 1)`` host mesh; then a two-rank gloo run (model = 2) is held to
JAX's ``(1, 2)`` host-mesh ``apply_sharded`` (the file's one JAX
subprocess).  On two ranks the tokens are split over "model", each
shard computes its own load-balance loss and the ranks average them, so
the port's ``aux`` is held to JAX's sharded ``aux``, not to the global
one.  Inputs are numpy draws from a seed.
"""
import os
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.distributed import sharding as jshd
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models.context import Ctx as JCtx
from repro.models.layers import moe as jmoe
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.models.context import Ctx
from repro_torch.models.layers import moe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-moe-16b"


def _params(seed=0):
    """The MoE sublayer's weights as numpy f32 (shared expert included)."""
    cfg = reduced_config(ARCH)
    m, D = cfg.moe, cfg.d_model
    E, F, Fs = m.n_routed_experts, m.d_expert, m.n_shared_experts * \
        m.d_expert
    rng = np.random.default_rng(seed)
    n = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)
    return {
        "router": n((D, E), 0.02),
        "w_gate": n((E, D, F), D ** -0.5),
        "w_in": n((E, D, F), D ** -0.5),
        "w_out": n((E, F, D), F ** -0.5),
        "shared": {"w_gate": n((D, Fs), D ** -0.5),
                   "w_in": n((D, Fs), D ** -0.5),
                   "w_out": n((Fs, D), Fs ** -0.5)},
    }


def _x(seed=1):
    cfg = reduced_config(ARCH)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.fixture
def mesh1():
    m = tmesh.make_host_mesh(n_data=1, n_model=1, device="cpu")
    yield m
    tmesh.close_world()


def test_sharded_matches_jax_1x1(mesh1):
    p, x = _params(), _x()
    jcfg = j_reduced(ARCH)
    jmesh = j_host_mesh(n_data=1, n_model=1)
    jctx = JCtx(cdtype=jnp.float32, phase="train", mesh=jmesh,
                rules=jshd.rules_for(jmesh, phase="train"))
    assert jmoe._sharded_ok(jcfg, jctx)
    with jmesh:
        jy, jaux = jmoe.apply(_tree(p, jnp.asarray), jnp.asarray(x), jctx,
                              cfg=jcfg)
    cfg = reduced_config(ARCH)
    ctx = Ctx(cdtype=torch.float32, phase="train", mesh=mesh1,
              rules=shd.rules_for(mesh1, phase="train"))
    assert moe._sharded_ok(cfg, ctx)
    y, aux = moe.apply(_tree(p, torch.from_numpy), torch.from_numpy(x), ctx,
                       cfg=cfg)
    assert np.allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    assert abs(float(aux) - float(jaux)) < 1e-7


def test_sharded_moe_grads(mesh1):
    """Reduced deepseek's ``train_loss`` on the mesh, through
    ``apply_sharded``: finite, non-zero gradients in every leaf, and the
    loss of the one-card path."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.cells import on_mesh
    from repro_torch.distributed import optimizer as adamw
    cfg = reduced_config(ARCH)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12),
                                           dtype=np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def model_of(mesh):
        model = lm.build(cfg)
        params, specs = lm.init(model, torch.Generator().manual_seed(0))
        if mesh is not None:
            shd.distribute_model(params, specs, mesh,
                                 shd.rules_for(mesh, phase="train"))
        for q in params.parameters():
            q.requires_grad_(True)
        return params

    ref = lm.train_loss(model_of(None), batch, Ctx(cdtype=torch.float32))
    params = model_of(mesh1)
    rules = shd.rules_for(mesh1, phase="train")
    ctx = Ctx(cdtype=torch.float32, mesh=mesh1, rules=rules,
              constrain=shd.make_constrainer(mesh1, rules))
    calls = []
    orig = moe.apply_sharded
    moe.apply_sharded = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with on_mesh(mesh1):
            loss = lm.train_loss(params, batch, ctx)
            leaves = adamw.leaves(params.tree())
            grads = torch.autograd.grad(loss, leaves)
    finally:
        moe.apply_sharded = orig
    # the two MoE layers, each run again by the backward's recompute
    assert len(calls) == 4
    assert isinstance(loss, DTensor)
    assert abs(float(loss.full_tensor()) - float(ref)) < 1e-5
    for g in grads:
        g = g.full_tensor().numpy()
        assert np.isfinite(g).all() and np.any(g != 0)


def test_decode_uses_global_path(mesh1):
    cfg = reduced_config(ARCH)
    ctx = Ctx(cdtype=torch.float32, phase="decode", mesh=mesh1,
              rules=shd.rules_for(mesh1, phase="decode"))
    assert not moe._sharded_ok(cfg, ctx)


_JAX_2 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import reduced_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models.context import Ctx
from repro.models.layers import moe
d = dict(np.load(sys.argv[1]))
p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_in", "w_out")}
p["shared"] = {k: jnp.asarray(d["shared_" + k])
               for k in ("w_gate", "w_in", "w_out")}
cfg = reduced_config("deepseek-moe-16b")
mesh = make_host_mesh(n_data=1, n_model=2)
ctx = Ctx(cdtype=jnp.float32, phase="train", mesh=mesh,
          rules=shd.rules_for(mesh, phase="train"))
assert moe._sharded_ok(cfg, ctx)
with mesh:
    y, aux = jax.jit(lambda p, x: moe.apply(p, x, ctx, cfg=cfg))(
        p, jnp.asarray(d["x"]))
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
"""

_TORCH_RANK = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.cells import on_mesh
from repro_torch.models.context import Ctx
from repro_torch.models.layers import moe
inp, out, store, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = tmesh.make_host_mesh(n_data=1, n_model=2, device="cpu")
rules = shd.rules_for(mesh, phase="train")
cfg = reduced_config("deepseek-moe-16b")
d = dict(np.load(inp))
_, specs = moe.init(torch.Generator().manual_seed(0), cfg)
p = {}
for k in ("router", "w_gate", "w_in", "w_out"):
    t = torch.from_numpy(d[k])
    p[k] = shd.distribute(t, mesh, shd.placements_for(specs[k], t.shape,
                                                      mesh, rules))
p["shared"] = {}
for k in ("w_gate", "w_in", "w_out"):
    t = torch.from_numpy(d["shared_" + k])
    p["shared"][k] = shd.distribute(t, mesh, shd.placements_for(
        specs["shared"][k], t.shape, mesh, rules))
leaves = [p[k] for k in ("router", "w_gate", "w_in", "w_out")] + \\
    list(p["shared"].values())
for t in leaves:
    t.requires_grad_(True)
x = torch.from_numpy(d["x"])
xd = shd.distribute(x, mesh, shd.placements_for(
    ("act_batch", "act_seq", None), x.shape, mesh, rules))
ctx = Ctx(cdtype=torch.float32, phase="train", mesh=mesh, rules=rules,
          constrain=shd.make_constrainer(mesh, rules))
assert xd.to_local().shape[1] == x.shape[1] // 2
with on_mesh(mesh):
    y, aux = moe.apply(p, xd, ctx, cfg=cfg)
    grads = torch.autograd.grad(y.sum() + aux, leaves)
    y = y.full_tensor()
    aux = aux.full_tensor()
    grads = [g.full_tensor() for g in grads]
ok = all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
         for g in grads)
if rank == 0:
    np.savez(out, y=y.detach().numpy(), aux=aux.detach().numpy(), ok=ok)
dist.destroy_process_group()
"""


def test_two_rank_gloo_matches_jax_1x2():
    p, x = _params(), _x()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.npz")
        flat = {k: v for k, v in p.items() if k != "shared"}
        flat.update({"shared_" + k: v for k, v in p["shared"].items()})
        np.savez(inp, x=x, **flat)
        jout, tout = os.path.join(d, "jax.npz"), os.path.join(d, "t.npz")
        procs = [subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_2), inp, jout],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)]
        store = os.path.join(d, "store")
        procs += [subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_TORCH_RANK), inp, tout,
             store, str(r)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
        for pr, o in zip(procs, outs):
            assert pr.returncode == 0, o[-4000:]
        j, t = np.load(jout), np.load(tout)
        assert np.allclose(t["y"], j["y"], atol=1e-5), \
            np.abs(t["y"] - j["y"]).max()
        assert abs(float(t["aux"]) - float(j["aux"])) < 1e-7
        assert bool(t["ok"])
        # the sharded aux is the mean of the shards' own losses, not the
        # global one
        jcfg = j_reduced(ARCH)
        _, gaux = jmoe._apply_global(_tree(p, jnp.asarray), jnp.asarray(x),
                                     JCtx(cdtype=jnp.float32, phase="train"),
                                     cfg=jcfg)
        assert abs(float(t["aux"]) - float(gaux)) > 1e-7
