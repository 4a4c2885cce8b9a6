"""Port parity: the model stack (``repro_torch.models``) against the JAX
package's, with the JAX weights carried over by
``repro_torch.convert.lm_params_from_numpy`` and the same numpy inputs.

Two small configs: the tiny serving config of the JAX package's ML tests
(2 layers, d_model 64, 2 query heads over 1 kv head, head_dim 32) and
qwen2-0.5b's own reduced config (4 query heads over 2, head_dim 16); both
have qwen2's QKV bias, which is set to random values here (JAX initialises
it to zeros).

Tolerances: at f32 compute every value agrees within 1e-4 (different
summation orders of f32 products; the caches are bf16 in both, as in the
JAX package).  At bf16 compute the two packages round intermediate
results at different places (XLA may keep f32 between fused ops; torch
rounds each op), so values agree within four bf16 ulps of the largest
magnitude in the tensor (2**-5 of it); token-level agreement of the
served model is held in ``tests/test_torch_serve_app.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.models.layers import attention as j_attn
from repro.models.layers import ffn as j_ffn
from repro.models.layers import norms as j_norms
from repro.models.layers import rope as j_rope
from repro.models.stack import apply_stack as j_apply_stack
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm as tlm
from repro_torch.models import transformer
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import attention as t_attn
from repro_torch.models.layers import ffn as t_ffn
from repro_torch.models.layers import norms as t_norms
from repro_torch.models.layers import rope as t_rope
from repro_torch.models.stack import apply_stack as t_apply_stack

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=512, head_dim=32)
# name -> (JAX config, port config)
CONFIGS = {
    "tiny": lambda: (j_get_config("qwen2-0.5b").replace(**TINY),
                     get_config("qwen2-0.5b").replace(**TINY)),
    "reduced": lambda: (j_reduced_config("qwen2-0.5b"),
                        reduced_config("qwen2-0.5b")),
}
BF16 = ("max", 2**-5)    # four bf16 ulps (2**-7) of the largest value
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16, BF16)}


def _setup(name):
    jcfg, tcfg = CONFIGS[name]()
    assert tcfg.name == jcfg.name and tcfg.qkv_bias
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(1)
    attn = params["body"]["segments"][0][0]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = rng.normal(0, 0.5, attn[b].shape).astype(np.float32)
    for ln in ("ln1", "ln2"):
        blk = params["body"]["segments"][0][0][ln]
        blk["scale"] = (1 + rng.normal(0, 0.2, blk["scale"].shape)
                        ).astype(np.float32)
    tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    return jcfg, tcfg, jm, params, tm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return _setup(request.param)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    """``tol`` bounds |a - b| absolutely (a float), or (``"max"``, r):
    relative to the largest magnitude in ``b``."""
    a, b = _np(a), _np(b)
    bound = tol[1] * float(np.abs(b).max()) if isinstance(tol, tuple) \
        else tol
    err = float(np.abs(a - b).max())
    assert err <= bound, (err, bound)


def _layer0(params):
    """Layer 0's parameters of the stacked JAX tree."""
    return jax.tree.map(lambda a: a[0], params["body"]["segments"][0][0])


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_norms_rope_ffn_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    for off in (False, True):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = j_norms.apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x, jdt), eps=1e-6,
                                 scale_offset=off)
            got = t_norms.apply({"scale": torch.from_numpy(scale)},
                                torch.from_numpy(x).to(tdt), eps=1e-6,
                                scale_offset=off)
            assert got.dtype == tdt
            _close(got, want, 1e-5 if tdt == torch.float32 else 0.0)
    xh = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(40, 48, dtype=np.int32), (2, 1))
    for theta in (10_000.0, 1_000_000.0):
        want = j_rope.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                                 theta=theta)
        got = t_rope.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos),
                                theta=theta)
        _close(got, want, 1e-5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in
         (("w_gate", (64, 128)), ("w_in", (64, 128)), ("w_out", (128, 64)))}
    for act in ("silu", "gelu"):
        for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                              (jnp.bfloat16, torch.bfloat16, BF16)):
            want = j_ffn.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               JCtx(cdtype=jdt), act=act)
            got = t_ffn.apply(_t(p), torch.from_numpy(x), TCtx(cdtype=tdt),
                              act=act)
            assert got.dtype == tdt
            _close(got, want, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_attention_prefill_and_decode_match_jax(model, dt):
    jcfg, tcfg, _, params, _ = model
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(3)
    B, S, cache = 2, 8, 16
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jp, tp = _layer0(params)["attn"], _t(_layer0(params)["attn"])

    def j_apply(phase):     # one compiled JAX call a phase, not op by op
        def f(p, x, state, positions, cur):
            ctx = JCtx(phase=phase, positions=positions, cur_index=cur,
                       cache_len=cache, cdtype=jdt)
            return j_attn.apply(p, x, state, ctx, cfg=jcfg)
        return jax.jit(f)

    tctx = TCtx(phase="prefill", positions=torch.from_numpy(pos),
                cache_len=cache, cdtype=tdt)
    jy, jst = j_apply("prefill")(jp, jnp.asarray(x), None, jnp.asarray(pos),
                                 None)
    ty, tst = t_attn.apply(tp, torch.from_numpy(x), None, tctx, cfg=tcfg)
    _close(ty, jy, tol)
    for k in ("k", "v"):
        assert tst[k].dtype == torch.bfloat16 and tst[k].shape[1] == cache
        _close(tst[k], jst[k], tol)
    # decode one token per request at its own index, in place
    cur = np.array([S, 3], np.int32)
    xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    tctx = TCtx(phase="decode", positions=torch.from_numpy(cur[:, None]),
                cur_index=torch.from_numpy(cur), cache_len=cache, cdtype=tdt)
    jyd, jst2 = j_apply("decode")(jp, jnp.asarray(xd), jst,
                                  jnp.asarray(cur[:, None]), jnp.asarray(cur))
    tst_in = convert.lm_states_from_numpy(
        jax.tree.map(np.asarray, jst), "cpu")
    tyd, tst2 = t_attn.apply(tp, torch.from_numpy(xd), tst_in, tctx,
                             cfg=tcfg)
    assert tst2["k"] is tst_in["k"]          # written in place
    _close(tyd, jyd, tol)
    for k in ("k", "v"):
        _close(tst2[k], jst2[k], tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_apply_stack_and_lm_logits_match_jax(model, dt):
    jcfg, tcfg, jm, params, tm = model
    jdt, tdt, tol, htol = DTYPES[dt]
    rng = np.random.default_rng(4)
    B, S, cache = 3, 10, 24
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    # the stack alone, prefill phase
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jx, jst, _ = jax.jit(lambda body, x, pos: j_apply_stack(
        body, jm.plan, x, None, JCtx(phase="prefill", positions=pos,
                                     cache_len=cache, cdtype=jdt),
        remat=False))(params["body"], jnp.asarray(x, jdt), jnp.asarray(pos))
    tx, tst, aux = t_apply_stack(
        tm.body.tree(), tm.plan, torch.from_numpy(x).to(tdt), None,
        TCtx(phase="prefill", positions=torch.from_numpy(pos),
             cache_len=cache, cdtype=tdt))
    assert aux == 0.0
    _close(tx, jx, htol)
    _close(tst[0][0]["k"], jst[0][0]["k"], htol)
    # lm.prefill (every position's logits), then three decode steps
    jlog, jstates = jax.jit(lambda p, t: jlm.prefill(
        jm, p, {"tokens": t}, JCtx(cdtype=jdt), cache, full_logits=True))(
            params, jnp.asarray(toks))
    j_decode = jax.jit(lambda p, t, st, cur: jlm.decode_step(
        jm, p, t, st, cur, JCtx(cdtype=jdt)))
    tlog, tstates = tlm.prefill(tm, {"tokens": torch.from_numpy(toks)},
                                TCtx(cdtype=tdt), cache, full_logits=True)
    assert tlog.dtype == tdt and tlog.shape == (B, S, jcfg.vocab_size)
    _close(tlog, jlog, tol)
    last, _ = tlm.prefill(tm, {"tokens": torch.from_numpy(toks)},
                          TCtx(cdtype=tdt), cache)
    _close(last, tlog[:, -1:], tol)     # another matmul shape
    cur = np.array([S, S, 4], np.int32)
    for step in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jstates = j_decode(params, jnp.asarray(tok), jstates,
                                 jnp.asarray(cur))
        tlog, tstates = tlm.decode_step(tm, torch.from_numpy(tok), tstates,
                                        torch.from_numpy(cur),
                                        TCtx(cdtype=tdt))
        assert tlog.shape == (B, 1, jcfg.vocab_size)
        _close(tlog, jlog, tol)
        cur = cur + 1
    _close(tstates[0][0]["v"], jstates[0][0]["v"], htol)


def test_params_and_states_round_trip_bitwise(model):
    jcfg, tcfg, jm, params, tm = model
    back = convert.lm_params_to_numpy(tm)
    flat_j, tree_j = jax.tree.flatten(params)
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = {n for n, _ in tm.named_parameters()}
    assert "body.segments.0.0.attn.bq" in names and "embed" in names
    assert all(not p.requires_grad for p in tm.parameters())
    # decode states: bf16 caches through the uint16 view, bit for bit
    _, states = jlm.prefill(jm, params, {"tokens": jnp.ones((2, 4),
                                                            jnp.int32)},
                            JCtx(cdtype=jnp.bfloat16), 8)
    states = jax.tree.map(np.asarray, states)
    ts = convert.lm_states_from_numpy(states, "cpu")
    assert ts[0][0]["k"].dtype == torch.bfloat16
    again = convert.lm_states_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(states), jax.tree.leaves(again)):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
    # zero states of the right structure, on request
    zs = tlm.decode_states(tm, 2, 8, lambda sh, dt, _spec: torch.zeros(
        sh, dtype=dt))
    assert zs[0][0]["k"].shape == (jcfg.n_layers, 2, 8, jcfg.n_kv_heads,
                                   jcfg.resolved_head_dim)


def test_init_and_configs():
    """Random init draws from a torch.Generator with the JAX package's
    shapes and scales; every config copies across; the families not
    ported yet raise NotImplementedError naming the ROADMAP item that
    ports them."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro_torch.configs.registry import ARCHS
    assert set(ARCHS) == set(J_ARCHS)
    for name, cfg in ARCHS.items():
        assert cfg.param_count() == J_ARCHS[name].param_count()
    cfg = get_config("qwen2-0.5b").replace(**TINY)
    a, _ = tlm.init(tlm.build(cfg), torch.Generator().manual_seed(7))
    b, specs = tlm.init(tlm.build(cfg), torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    jp, jspecs = jlm.init(jlm.build(j_get_config("qwen2-0.5b").replace(
        **TINY)), jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), convert.lm_params_to_numpy(
        a)) == shapes
    assert specs == jax.tree.map(tuple, jspecs,
                                 is_leaf=lambda s: isinstance(s, tuple))
    wq = a.body.segments[0][0].attn.wq
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    for name in ("xlstm-350m", "deepseek-moe-16b",
                 "deepseek-v2-lite-16b", "whisper-tiny",
                 "llama-3.2-vision-11b", "gemma3-1b"):
        with pytest.raises(NotImplementedError, match="queue 1 item 12"):
            tlm.build(reduced_config(name))
    assert transformer.build_encoder_plan(cfg) is None
    # dense decoders and the hybrid family build
    for name in ("gemma-7b", "qwen1.5-110b", "zamba2-1.2b"):
        tlm.build(reduced_config(name))
