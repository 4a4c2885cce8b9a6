"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the JAX package's on the CPU.

``rules_for`` / ``to_pspec`` must equal JAX's exactly for every parameter,
batch and decode-state leaf of all ten archs, under every applicable
shape, on both production meshes (a duck mesh: the rule functions read
only the axis names and sizes, so no devices are forced).  On a ``fake``
world of 512 ranks (the first 256 for one pod) every leaf's local shape
on rank 0 must equal ``NamedSharding(AbstractMesh(...), spec)
.shard_shape(shape)``.  The five cases of ``tests/test_sharding.py``
are ported at the end.  Every process group a test starts is destroyed
in its fixture's teardown.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro.models.config import SHAPES as J_SHAPES
from repro.models.config import cell_is_applicable as j_applicable
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


class DuckMesh:
    """The two attributes JAX's and the port's rule functions read."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _is_spec(s):
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


def _flat(tree, prefix=()):
    """(path, leaf) in JAX order: dict keys sorted, lists in order; a
    logical tuple, a tensor or a ShapeDtypeStruct is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)) and not _is_spec(tree) \
            and not shd.is_placements(tree):
        return [x for i, t in enumerate(tree) for x in _flat(t, prefix + (i,))]
    return [(prefix, tree)]


def _jax_pspec(spec: P):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


_PARAMS = {}


def _param_leaves(arch):
    """[(path, shape, logical)] of ``arch``'s parameters, from both
    packages (asserted equal)."""
    if arch not in _PARAMS:
        jshapes, jspecs = jlm.param_specs(jlm.build(j_get_config(arch)))
        tshapes, tspecs = lm.param_specs(lm.build(get_config(arch)))
        js = [(p, tuple(s.shape), sp) for (p, s), (_, sp) in
              zip(_flat(jshapes), _flat(jspecs))]
        ts = [(p, tuple(s.shape), sp) for (p, s), (_, sp) in
              zip(_flat(tshapes), _flat(tspecs))]
        assert js == ts, arch
        _PARAMS[arch] = ts
    return _PARAMS[arch]


def _state_leaves(arch, shape):
    """[(path, shape, logical)] of the decode states, from both."""
    rec = lambda shp, dtype, logical: (tuple(shp), tuple(logical))
    js = jlm.decode_states(jlm.build(j_get_config(arch)), shape.global_batch,
                           shape.seq_len, rec)
    ts = lm.decode_states(lm.build(get_config(arch)), shape.global_batch,
                          shape.seq_len, rec)
    is_leaf = lambda x: isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[0], tuple) and _is_spec(x[1])
    jl = [(p, leaf) for p, leaf in jax.tree_util.tree_flatten_with_path(
        js, is_leaf=is_leaf)[0]]
    flat_t = []

    def walk(t):
        if t is None:
            return
        if is_leaf(t):
            flat_t.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for x in t:
                walk(x)
    walk(ts)
    assert [leaf for _, leaf in jl] == flat_t, arch
    return [(i, s, lg) for i, (s, lg) in enumerate(flat_t)]


def _batch_leaves(arch, shape):
    from repro.models import lm as jl
    jb = jl.input_specs(j_get_config(arch), shape)
    tb = lm.input_specs(get_config(arch), shape)
    assert sorted(jb) == sorted(tb)
    for k in sorted(tb):
        assert tuple(jb[k].shape) == tuple(tb[k].shape)
    return [(k, tuple(tb[k].shape)) for k in sorted(tb)]


def _cells():
    out = []
    for arch in sorted(J_ARCHS):
        for shape in J_SHAPES:
            if j_applicable(j_get_config(arch), shape)[0]:
                out.append((arch, shape))
    return out


def _rules(mesh, shape):
    kw = dict(phase=shape.phase, long_context=(shape.name == "long_500k"))
    return jshd.rules_for(mesh, **kw), shd.rules_for(mesh, **kw)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_pspecs_equal_jax_on_every_leaf(arch, mesh_name):
    mesh = DuckMesh(*MESHES[mesh_name])
    n = 0
    for a, shape in _cells():
        if a != arch:
            continue
        jr, tr = _rules(mesh, shape)
        assert jr == tr, (shape.name, jr, tr)
        for path, shp, logical in _param_leaves(arch):
            want = _jax_pspec(jshd.to_pspec(logical, shp, mesh, jr))
            assert shd.to_pspec(logical, shp, mesh, tr) == want, (path,)
            n += 1
        for key, shp in _batch_leaves(arch, shape):
            logical = ("act_batch",) + (None,) * (len(shp) - 1)
            want = _jax_pspec(jshd.to_pspec(logical, shp, mesh, jr))
            assert shd.to_pspec(logical, shp, mesh, tr) == want, key
            n += 1
        if shape.phase == "decode":
            for i, shp, logical in _state_leaves(arch, shape):
                want = _jax_pspec(jshd.to_pspec(logical, shp, mesh, jr))
                assert shd.to_pspec(logical, shp, mesh, tr) == want, i
                n += 1
    assert n > 0


@pytest.fixture
def fake_world():
    tmesh.start_fake_world(512)
    yield
    tmesh.close_world()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shapes_equal_jax_shard_shape(fake_world, mesh_name):
    """Rank 0's local shape of every leaf (parameters, batches, decode
    states; every arch and applicable shape) is JAX's shard shape."""
    from torch.distributed.tensor import distribute_tensor
    shape_, names = MESHES[mesh_name]
    mesh = tmesh.make_production_mesh(multi_pod=(mesh_name == "multipod"))
    amesh = AbstractMesh(shape_, names)
    seen = set()

    def check(logical, shp, rules):
        key = (tuple(logical), tuple(shp), tuple(sorted(rules.items())))
        if key in seen:
            return
        seen.add(key)
        spec = shd.to_pspec(logical, shp, mesh, rules)
        want = NamedSharding(amesh, P(*spec)).shard_shape(tuple(shp))
        t = distribute_tensor(torch.empty(shp, device="meta"), mesh,
                              shd.to_placements(spec, mesh))
        assert tuple(t.to_local().shape) == tuple(want), (logical, shp)

    for arch, shape in _cells():
        rules = shd.rules_for(mesh, phase=shape.phase,
                              long_context=(shape.name == "long_500k"))
        for _, shp, logical in _param_leaves(arch):
            check(logical, shp, rules)
        for _, shp in _batch_leaves(arch, shape):
            check(("act_batch",) + (None,) * (len(shp) - 1), shp, rules)
        if shape.phase == "decode":
            for _, shp, logical in _state_leaves(arch, shape):
                check(logical, shp, rules)
    assert len(seen) > 100


def test_two_axes_on_one_dim_shard_in_mesh_order():
    from torch.distributed.tensor import Shard
    mesh = DuckMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.to_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError):
        shd.to_placements((("data", "pod"),), mesh)


# ---- the five cases of tests/test_sharding.py ----

@pytest.fixture
def mesh1():
    m = tmesh.make_host_mesh(n_data=1, n_model=1, device="cpu")
    yield m
    tmesh.close_world()


def test_divisibility_fallback(mesh1):
    rules = {"tp": ("model",), "fsdp": ("data",)}
    assert shd.to_pspec(("fsdp", "tp"), (8, 16), mesh1, rules) == (
        "data", "model")
    assert shd.to_pspec(("fsdp", None), (8, 16), mesh1, rules) == ("data",)
    # and on a mesh whose axes do not divide the dims
    big = DuckMesh((16, 16), ("data", "model"))
    assert shd.to_pspec(("fsdp", "tp"), (8, 14), big, rules) == ()


def test_duplicate_axis_priority(mesh1):
    rules = {"kv_heads": ("model",), "kv_seq": ("model",),
             "act_batch": ("data",)}
    spec = shd.to_pspec(("act_batch", "kv_seq", "kv_heads", None),
                        (4, 128, 16, 64), mesh1, rules)
    # kv_heads wins "model"; kv_seq falls back to replicated
    assert spec == ("data", None, "model")


def test_rules_phase_behaviour(mesh1):
    train = shd.rules_for(mesh1, phase="train")
    dec = shd.rules_for(mesh1, phase="decode")
    lng = shd.rules_for(mesh1, phase="decode", long_context=True)
    assert train["kv_seq"] == ()
    assert dec["kv_seq"] == ("model",)
    assert set(lng["kv_seq"]) >= {"model"}
    assert train["act_seq"] == ("model",)
    assert dec["act_seq"] == ()


def test_tree_shardings_on_model(mesh1):
    model = lm.build(reduced_config("qwen2-0.5b"))
    rules = shd.rules_for(mesh1, phase="train")
    shapes, specs = lm.param_specs(model)
    shardings = shd.tree_shardings(specs, shapes, mesh1, rules)
    n = len(_flat(shardings, ()))
    assert n == len([t for _, t in _flat(shapes)])
    assert all(len(p) == 2 for _, p in _flat(shardings))


def test_constrainer_identity_semantics(mesh1):
    from torch.distributed.tensor import DTensor
    rules = shd.rules_for(mesh1, phase="train")
    constrain = shd.make_constrainer(mesh1, rules)
    x = torch.ones((4, 8, 16))
    assert constrain(x, ("act_batch", "act_seq", None)) is x
    xd = shd.distribute(x, mesh1, shd.placements_for(
        ("act_batch", None, None), x.shape, mesh1, rules))
    out = constrain(xd, ("act_batch", "act_seq", None))
    assert isinstance(out, DTensor)
    assert np.allclose(out.full_tensor().numpy(), 1.0)
