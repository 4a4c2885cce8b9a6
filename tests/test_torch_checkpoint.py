"""Port parity of the async checkpointer (``distributed/checkpoint.py``)
with the JAX package's: the JAX package's own cases (round trip, an
uncommitted step ignored, ``keep`` GC) on the port, then the on-disk
layout, which is the JAX package's byte for byte (the same manifest, the
same ``.npy`` files for the same values, a training state's leaf paths
``params/...``, ``opt/m/...``, ``opt/count``), so that a checkpoint
written by either package restores in the other."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.distributed import optimizer as j_adamw
from repro.distributed.checkpoint import Checkpointer as JCheckpointer
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.distributed import optimizer as adamw
from repro_torch.distributed.checkpoint import Checkpointer


def make_tree(seed=0):
    """numpy leaves of four dtypes, a list and a ``None``."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                   "b": np.zeros((16,), np.float32),
                   "layers": [rng.standard_normal(3).astype(np.float32),
                              None],
                   "h": rng.standard_normal(5).astype(ml_dtypes.bfloat16)},
        "opt": {"m": np.ones((8, 16), np.float32),
                "count": np.asarray(7, np.int32)},
    }


def _torch(tree):
    return convert._map_leaves(lambda a: convert._t(a, "cpu"), tree)


def _np(tree):
    return convert.to_plain(tree)


def _same(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _torch(make_tree())
    ck.save(10, tree, blocking=True)
    assert ck.latest_step() == 10
    restored = ck.restore(10, tree)
    assert restored["params"]["layers"][1] is None
    assert restored["params"]["h"].dtype == torch.bfloat16
    _same(_np(tree), _np(restored))
    ck.close()
    assert not ck._thread.is_alive()


def test_save_copies_before_the_caller_updates_in_place(tmp_path):
    """A CPU tensor updated in place right after ``save`` (the next
    training step) leaves the checkpoint as it was at the call."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(1000, 100)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    assert float(ck.restore(1, {"w": w})["w"].abs().max()) == 0.0
    ck.close()


def test_uncommitted_checkpoints_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _torch(make_tree()), blocking=True)
    # simulate a crash mid-write: directory without COMMIT
    os.makedirs(str(tmp_path / "step_0000000009"))
    assert ck.latest_step() == 5
    ck.close()


def test_keep_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _torch(make_tree()), blocking=True)
    assert ck.all_steps() == [3, 4]
    ck.close()


def test_restore_onto_a_mesh_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _torch(make_tree())
    ck.save(1, tree, blocking=True)
    # placements without a mesh to put them on
    with pytest.raises(ValueError, match="needs a mesh"):
        ck.restore(1, tree, shardings={"anything": None})
    ck.close()


def _files(d):
    return sorted(os.listdir(d))


def test_layout_is_the_jax_packages_byte_for_byte(tmp_path):
    """The same values written by both packages: the same file names, the
    same manifest, the same bytes in every ``.npy``; each package reads
    the other's checkpoint back to the same bits."""
    tree = make_tree()
    jd, td = tmp_path / "jax", tmp_path / "port"
    jck, tck = JCheckpointer(str(jd)), Checkpointer(str(td))
    jck.save(3, jax.tree.map(jnp.asarray, tree), blocking=True)
    tck.save(3, _torch(tree), blocking=True)
    js, ts = jd / "step_0000000003", td / "step_0000000003"
    assert _files(js) == _files(ts)
    assert json.loads((js / "manifest.json").read_text()) == json.loads(
        (ts / "manifest.json").read_text())
    for f in _files(js):
        assert (js / f).read_bytes() == (ts / f).read_bytes(), f
    # across: the port restores the JAX checkpoint and the reverse
    _same(tree, _np(Checkpointer(str(jd)).restore(3, _torch(tree))))
    # (the JAX package reads a bf16 .npy back as 2-byte voids: its target
    # leaves the bf16 leaf out)
    del tree["params"]["h"]
    _same(tree, jax.tree.map(np.asarray, JCheckpointer(str(td)).restore(
        3, jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree))))
    jck.close()
    tck.close()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
def test_training_state_paths_and_bytes_match_jax(arch, tmp_path):
    """A training state ``{"params": the model's tree, "opt": OptState}``
    (zamba2's shared block leaves a ``None`` in the stacked tree): leaf
    paths such as ``params/body/segments/0/0/...``, ``opt/m/embed`` and
    ``opt/count``, file for file and byte for byte the JAX package's;
    restored by the port into its model and ``OptState``."""
    from repro.configs import reduced_config as j_reduced_config
    jm = jlm.build(j_reduced_config(arch))
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
    opt = j_adamw.init(params)
    opt = opt._replace(
        m=jax.tree.map(lambda a: a + 0.5, opt.m),
        count=jnp.asarray(4, jnp.int32))
    jd, td = tmp_path / "jax", tmp_path / "port"
    jck, tck = JCheckpointer(str(jd)), Checkpointer(str(td))
    jck.save(4, {"params": params, "opt": opt}, blocking=True)
    cfg = reduced_config(arch)
    model, topt = convert.train_state_from_numpy(
        {"params": jax.tree.map(np.asarray, params),
         "opt": jax.tree.map(np.asarray, opt)}, cfg, device="cpu")
    _same(jax.tree.map(np.asarray, {"params": params, "opt": {
        "m": opt.m, "v": opt.v, "count": opt.count}}),
        convert.train_state_to_numpy(model, topt))
    tck.save(4, {"params": model.tree(), "opt": topt}, blocking=True)
    js, ts = jd / "step_0000000004", td / "step_0000000004"
    names = _files(js)
    assert names == _files(ts)
    assert "opt__count.npy" in names and "opt__m__embed.npy" in names
    assert any(n.startswith("params__body__segments__0__0__") for n in names)
    assert json.loads((js / "manifest.json").read_text()) == json.loads(
        (ts / "manifest.json").read_text())
    for f in names:
        assert (js / f).read_bytes() == (ts / f).read_bytes(), f
    fresh, fopt = convert.train_state_from_numpy(
        {"params": jax.tree.map(np.zeros_like, params),
         "opt": jax.tree.map(np.zeros_like, opt)}, cfg, device="cpu")
    state = Checkpointer(str(jd)).restore(4, {"params": fresh.tree(),
                                              "opt": fopt})
    assert int(state["opt"].count) == 4
    _same(jax.tree.map(np.asarray, params), _np(state["params"]))
    _same(convert.opt_state_to_numpy(topt),
          convert.opt_state_to_numpy(state["opt"]))
    jck.close()
    tck.close()
