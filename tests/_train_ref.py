"""Shared helpers of the training parity tests (``tests/test_torch_train_
*.py``): a family's reduced config in both packages, JAX parameters drawn
and perturbed in numpy and carried into the port, a batch made with
numpy, and the loss and per-leaf gradients of both packages at f32."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.distributed import optimizer as adamw
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx

# the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
# largest magnitude: f32 on both sides, the sums in other orders
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def setup(arch, seed=0):
    """(JAX model, numpy params, port model with gradients) for the
    family's reduced config.  Leaves JAX draws as constants (zeros or
    ones: biases, norm scales, Mamba-2's ``a_log`` / ``dt_bias`` /
    ``d_skip``, gate biases) get noise, so that a wrong use of one shows
    in the loss and its gradient."""
    jcfg, tcfg = j_reduced_config(arch), reduced_config(arch)
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def perturb(a):
        a = np.array(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            a = (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return a

    params = jax.tree.map(perturb, params)
    tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    for p in tm.parameters():
        p.requires_grad_(True)
    return jcfg, tcfg, jm, params, tm


def batch(cfg, B, S, seed=2, masked=True):
    """tokens / labels [B, S] (a few labels -100, the first row's tail
    too), and whisper's ``enc_frames`` / the vision model's
    ``image_embeds``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if masked:
        labels[rng.random((B, S)) < 0.15] = -100
        labels[0, S - 3:] = -100
    out = {"tokens": toks, "labels": labels}
    if cfg.encdec:
        out["enc_frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_every:
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_loss_grads(jm, params, b, cdtype=jnp.float32):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(jm, p, b, JCtx(cdtype=cdtype))))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in b.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_grads(tm, b, cdtype=torch.float32):
    """The port's loss and its gradient tree (numpy, the JAX layout)."""
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = tlm.train_loss(tm, tb, TCtx(cdtype=cdtype))
    tree = tm.tree()
    leaves = adamw.leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return float(loss.detach()), convert.to_plain(
        adamw.map_tree(lambda p: by_id[id(p)], tree))


def flat(tree, prefix=""):
    """{path: leaf} of a tree (dicts, lists; ``None`` skipped)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in
                flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, t in enumerate(tree) for k2, v2 in
                flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def check_grads(jg, tg, tol=GRAD_TOL, same_nans=False):
    """Every leaf of the port's gradient tree within ``tol`` of the JAX
    leaf's largest magnitude; returns the worst ratio err / (tol * max).
    With ``same_nans`` a NaN is allowed where, and only where, the JAX
    leaf has one, and the rest is compared."""
    jf, tf = flat(jg), flat(tg)
    assert sorted(jf) == sorted(tf)
    worst = 0.0
    for k, want in jf.items():
        got, want = np.asarray(tf[k]), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if same_nans:
            nan = np.isnan(want)
            assert np.array_equal(np.isnan(got), nan), k
            got, want = got[~nan], want[~nan]
            if not want.size:
                continue
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (k, err, scale)
        worst = max(worst, err / (tol * scale))
    return worst
