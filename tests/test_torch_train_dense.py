"""Port parity of the training loss and its gradients, part 1: the
attention families (qwen2-0.5b, gemma3-1b, whisper-tiny,
llama-3.2-vision-11b) at their reduced configs, and the pieces the loss
is built from (the chunked cross-entropy, remat, ``param_specs`` /
``input_specs``, ``stack.specs_of``, ``init_utils.merge``).  Part 2,
``test_torch_train_hybrid.py``, holds the other three families.

The JAX parameters are drawn by the JAX package, perturbed in numpy
(``tests/_train_ref.py``) and carried into the port through
``convert``; inputs come from a numpy seed.  Tolerances, f32 on both
sides (the sums run in other orders): the loss within 1e-5 relative,
each gradient leaf within 1e-4 of its largest magnitude."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import lm as jlm
from repro.models import init_utils as j_iu
from repro.models.config import SHAPES as J_SHAPES
from repro.models.context import Ctx as JCtx
from repro.models.stack import specs_of as j_specs_of
from repro_torch.models import init_utils as t_iu
from repro_torch.models import lm as tlm
from repro_torch.models import stack as t_stack
from repro_torch.models.config import SHAPES as T_SHAPES
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import attention as t_attn
from tests import _train_ref as R

ARCHS = ("qwen2-0.5b", "gemma3-1b", "whisper-tiny", "llama-3.2-vision-11b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    """``lm.train_loss`` and the gradient of every parameter leaf, f32,
    on a batch of 40 tokens (not a multiple of the 512-token chunk) with
    labels masked at -100; whisper with random encoder frames, the vision
    model with random image embeddings."""
    jcfg, tcfg, jm, params, tm = R.setup(arch)
    b = R.batch(jcfg, 2, 40)
    jl, jg = R.jax_loss_grads(jm, params, b)
    tl, tg = R.port_loss_grads(tm, b)
    assert np.isfinite(jl) and abs(tl - jl) <= R.LOSS_RTOL * abs(jl)
    R.check_grads(jg, tg)


def test_lm_loss_chunks_match_jax():
    """``lm_loss`` alone at chunk 16 over 40 positions (three chunks, the
    last padded with label -100), some labels masked: the loss and its
    gradients with respect to the hidden states and the tied embedding
    equal the JAX package's; a batch with every label masked gives 0, as
    in JAX (the token count is clamped to 1)."""
    jcfg, tcfg, jm, params, tm = R.setup("qwen2-0.5b")
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    y = R.batch(jcfg, 2, 40)["labels"]
    for labels in (y, np.full_like(y, -100)):
        jl, (jgh, jge) = jax.jit(jax.value_and_grad(
            lambda h, e: jlm.lm_loss(jm, {**params, "embed": e}, h,
                                     jnp.asarray(labels),
                                     JCtx(cdtype=jnp.float32), chunk=16),
            argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(params["embed"]))
        th = torch.from_numpy(h).requires_grad_(True)
        tl = tlm.lm_loss(tm, th, torch.from_numpy(labels),
                         TCtx(cdtype=torch.float32), chunk=16)
        tgh, tge = torch.autograd.grad(tl, (th, tm.embed))
        tl = float(tl.detach())
        assert abs(tl - float(jl)) <= R.LOSS_RTOL * max(abs(float(jl)),
                                                          1e-30)
        R.check_grads({"h": np.asarray(jgh), "e": np.asarray(jge)},
                      {"h": tgh.numpy(), "e": tge.numpy()})
    assert tl == 0.0


def test_remat_gives_the_same_values_and_grads():
    """``apply_stack`` under remat (each group checkpointed) gives the
    same output and the same gradients, bitwise, as without it, and runs
    each group's forward twice in a backward pass (counted on the
    attention layer)."""
    _, tcfg, _, _, tm = R.setup("qwen2-0.5b")
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    ctx = TCtx(phase="train", positions=pos, cdtype=torch.float32)
    calls = []
    apply = t_attn.apply

    def counting(*a, **k):
        calls.append(1)
        return apply(*a, **k)

    out = {}
    t_attn.apply = counting
    try:
        for remat in (False, True):
            calls.clear()
            x = x0.clone().requires_grad_(True)
            y, _, _ = t_stack.apply_stack(tm.body.tree(), tm.plan, x, None,
                                          ctx, remat=remat)
            grads = torch.autograd.grad(y.square().sum(),
                                        [x, *tm.body.parameters()])
            out[remat] = (y.detach(), grads, len(calls))
    finally:
        t_attn.apply = apply
    (y0, g0, n0), (y1, g1, n1) = out[False], out[True]
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n1 == 2 * n0 == 2 * tcfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_without_allocating(arch):
    """``param_specs`` gives the JAX package's shapes, dtypes and
    logical specs leaf for leaf, as ``meta`` tensors, and leaves the
    model's own parameters as they were (none)."""
    jcfg, tcfg = R.j_reduced_config(arch), R.reduced_config(arch)
    jshapes, jspecs = jlm.param_specs(jlm.build(jcfg))
    model = tlm.build(tcfg)
    tshapes, tspecs = tlm.param_specs(model)
    assert list(model.parameters()) == []
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = R.flat(tshapes)
    assert len(jl) == len(tl)
    for path, s in jl:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        t = tl[key]
        assert t.device.type == "meta" and tuple(t.shape) == s.shape
        assert str(t.dtype).replace("torch.", "") == str(s.dtype)
    assert _specs(jspecs) == _specs(tspecs)


def _specs(tree):
    """A specs tree as plain nested dicts / lists of tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    return tuple(tree)


def test_input_specs_specs_of_and_merge_match_jax():
    """``input_specs`` for every (family, shape) cell: the JAX package's
    names, shapes and dtypes, as ``meta`` tensors; ``stack.specs_of`` of
    a block's init and ``init_utils.merge`` as in JAX."""
    for arch in ("qwen2-0.5b", "whisper-tiny", "llama-3.2-vision-11b"):
        jcfg, tcfg = R.j_reduced_config(arch), R.reduced_config(arch)
        for js, ts in zip(J_SHAPES, T_SHAPES):
            assert js.name == ts.name
            jspec, tspec = jlm.input_specs(jcfg, js), tlm.input_specs(tcfg,
                                                                      ts)
            assert sorted(jspec) == sorted(tspec)
            for k in jspec:
                assert tspec[k].device.type == "meta"
                assert tuple(tspec[k].shape) == jspec[k].shape
                assert str(tspec[k].dtype)[6:] == str(jspec[k].dtype)
    jcfg, tcfg = R.j_reduced_config("qwen2-0.5b"), R.reduced_config(
        "qwen2-0.5b")
    jblk = jlm.build(jcfg).plan.segments[0].pattern[0]
    tblk = tlm.build(tcfg).plan.segments[0].pattern[0]
    jshapes, jspecs = j_specs_of(jblk.init, jax.random.PRNGKey(0))
    tshapes, tspecs = t_stack.specs_of(tblk.init)
    assert _specs(jspecs) == _specs(tspecs)
    assert jax.tree.map(lambda s: s.shape, jshapes) == R.adamw.map_tree(
        lambda t: tuple(t.shape), tshapes)
    a = ({"w": 1}, {"w": ("fsdp",)})
    b = ({"b": 2, "w": 3}, {"b": (None,), "w": ("tp",)})
    assert t_iu.merge(a, b) == j_iu.merge(a, b)
