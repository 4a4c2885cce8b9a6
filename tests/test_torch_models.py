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
from tests.test_torch_xlstm import _j_lm, _stack_tol

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
    shapes and scales; every config copies across; whisper's
    encoder-decoder and llama-3.2-vision's cross-attention layers build
    with the JAX package's parameter shapes and specs (the cross layers'
    full-head ``wk`` / ``wv``, whisper's ``enc_body`` and ``enc_norm``)."""
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
    for name in ("whisper-tiny", "llama-3.2-vision-11b"):
        t, tspecs = tlm.init(tlm.build(reduced_config(name)),
                             torch.Generator().manual_seed(1))
        j, jspecs = jlm.init(jlm.build(j_reduced_config(name)),
                             jax.random.PRNGKey(1))
        assert jax.tree.map(lambda x: tuple(x.shape),
                            convert.lm_params_to_numpy(t)) == \
            jax.tree.map(lambda x: tuple(x.shape), j), name
        assert tspecs == jax.tree.map(
            tuple, jspecs, is_leaf=lambda s: isinstance(s, tuple)), name
    assert transformer.build_encoder_plan(cfg) is None
    assert transformer.build_encoder_plan(
        reduced_config("whisper-tiny")).n_layers == 2
    # the dense decoders, the hybrid, xLSTM, gemma3 and DeepSeek families
    # build
    for name in ("gemma-7b", "qwen1.5-110b", "zamba2-1.2b", "xlstm-350m",
                 "gemma3-1b", "deepseek-moe-16b", "deepseek-v2-lite-16b"):
        tlm.build(reduced_config(name))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "zamba2-1.2b", "xlstm-350m",
                                  "gemma3-1b", "deepseek-v2-lite-16b",
                                  "whisper-tiny", "llama-3.2-vision-11b"])
def test_init_in_a_compute_dtype_equals_for_compute(name):
    """``lm.init(..., dtype=bf16)`` casts each block as it is drawn and
    gives bit for bit ``for_compute(init(...), bf16)``: the same draws,
    ``F32_PARAMS`` kept f32."""
    cfg = reduced_config(name)
    a, _ = tlm.init(tlm.build(cfg), torch.Generator().manual_seed(5))
    b, _ = tlm.init(tlm.build(cfg), torch.Generator().manual_seed(5),
                    dtype=torch.bfloat16)
    want = dict(tlm.for_compute(a, torch.bfloat16).named_parameters())
    got = dict(b.named_parameters())
    assert want.keys() == got.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert v.dtype == (torch.float32 if k.split(".")[-1] in
                           tlm.F32_PARAMS else torch.bfloat16), k
        assert torch.equal(v, want[k]), k


# ---- gemma3: windowed local layers with their own rope theta, globals ----

GEMMA3 = "gemma3-1b"
G_S, G_CACHE = 24, 40      # prompts three windows long (window 8)


@pytest.fixture(scope="module")
def gemma3():
    """The reduced gemma3 (7 layers: 2 groups of two windowed local layers
    and a global one, then a local tail; window 8, local theta 1e4,
    global 1e6) with its norm scales (zeros at init, applied as 1 + w)
    set to random values."""
    jcfg, tcfg = j_reduced_config(GEMMA3), reduced_config(GEMMA3)
    assert tcfg.name == jcfg.name and tcfg.sliding_window == 8
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(1)

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "scale":
                    t[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
                else:
                    walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(params)
    tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    return jcfg, tcfg, jm, params, tm


def test_gemma3_plan_matches_jax(gemma3):
    jcfg, tcfg, jm, params, tm = gemma3
    names = lambda plan: [([b.name for b in s.pattern], s.n_groups)
                          for s in plan.segments]
    assert names(tm.plan) == names(jm.plan) == [
        (["local0", "local1", "global"], 2), (["tail_local0"], 1)]
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    p, _ = tlm.init(tlm.build(tcfg), torch.Generator().manual_seed(3))
    assert jax.tree.map(lambda x: tuple(x.shape),
                        convert.lm_params_to_numpy(p)) == shapes


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["local", "global"])
def test_gemma3_attention_matches_jax(gemma3, kind, dt):
    """A local layer (window 8, theta 1e4) and a global one (theta 1e6),
    Dh 16, 4 query heads over one kv head, at prefill (the window binds)
    and one decode step per request past the window, against JAX."""
    jcfg, tcfg, _, params, _ = gemma3
    jdt, tdt, tol, _ = DTYPES[dt]
    kw = (dict(window=jcfg.sliding_window, rope_theta=jcfg.rope_theta_local)
          if kind == "local" else dict(rope_theta=jcfg.rope_theta))
    j = 0 if kind == "local" else 2
    jp = jax.tree.map(lambda a: a[0], params["body"]["segments"][0][j]["attn"])
    tp = _t(jp)
    rng = np.random.default_rng(3)
    B = 2
    x = rng.standard_normal((B, G_S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(G_S, dtype=np.int32), (B, 1))

    def j_apply(phase):
        def f(p, x, state, positions, cur):
            ctx = JCtx(phase=phase, positions=positions, cur_index=cur,
                       cache_len=G_CACHE, cdtype=jdt)
            return j_attn.apply(p, x, state, ctx, cfg=jcfg, **kw)
        return jax.jit(f)

    jy, jst = j_apply("prefill")(jp, jnp.asarray(x), None, jnp.asarray(pos),
                                 None)
    ty, tst = t_attn.apply(tp, torch.from_numpy(x), None, TCtx(
        phase="prefill", positions=torch.from_numpy(pos), cache_len=G_CACHE,
        cdtype=tdt), cfg=tcfg, **kw)
    _close(ty, jy, tol)
    cur = np.array([G_S, 13], np.int32)
    xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jyd, _ = j_apply("decode")(jp, jnp.asarray(xd), jst,
                               jnp.asarray(cur[:, None]), jnp.asarray(cur))
    tyd, _ = t_attn.apply(
        tp, torch.from_numpy(xd),
        convert.lm_states_from_numpy(jax.tree.map(np.asarray, jst), "cpu"),
        TCtx(phase="decode", positions=torch.from_numpy(cur[:, None]),
             cur_index=torch.from_numpy(cur), cache_len=G_CACHE, cdtype=tdt),
        cfg=tcfg, **kw)
    _close(tyd, jyd, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gemma3_apply_stack_and_lm_logits_match_jax(gemma3, dt):
    """The gemma3 stack at prefill, ``lm.prefill`` logits at every
    position (embedding scale, 1 + w norms, GeGLU, tied head) and three
    decode steps past the window, against JAX.  At f32 the prefill agrees
    within 1e-4; a decode step reads the bf16 caches and the decode
    oracle's bf16 probabilities, where an f32 value within 1e-7 of a bf16
    rounding boundary may round either way in the two packages, so decode
    logits agree within four bf16 ulps of the largest.  At bf16 the stack
    and the logits agree within twice JAX's own distance between its bf16
    and f32 outputs on the same inputs (``_stack_tol``)."""
    jcfg, tcfg, jm, params, tm = gemma3
    jdt, tdt, tol, _ = DTYPES[dt]
    rng = np.random.default_rng(4)
    B = 3
    toks = rng.integers(1, jcfg.vocab_size, (B, G_S)).astype(np.int32)
    x = rng.standard_normal((B, G_S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(G_S, dtype=np.int32), (B, 1))
    m = tlm.for_compute(tm, tdt)
    j_stack = lambda dt_: jax.jit(lambda body, x, pos: j_apply_stack(
        body, jm.plan, x, None, JCtx(phase="prefill", positions=pos,
                                     cache_len=G_CACHE, cdtype=dt_),
        remat=False))(params["body"], jnp.asarray(x, dt_), jnp.asarray(pos))
    jx, jst, _ = j_stack(jdt)
    tx, tst, _ = t_apply_stack(
        m.body.tree(), m.plan, torch.from_numpy(x).to(tdt), None,
        TCtx(phase="prefill", positions=torch.from_numpy(pos),
             cache_len=G_CACHE, cdtype=tdt))
    _close(tx, jx, tol if dt == "f32" else _stack_tol(jx,
                                                      j_stack(jnp.float32)[0]))
    _close(tst[1][0]["k"], jst[1][0]["k"], BF16)
    j_prefill, j_decode = _j_lm(jm, jdt, G_CACHE)
    # JAX at f32 beside JAX at bf16: the bf16 bound
    f_prefill, f_decode = ((j_prefill, j_decode) if dt == "f32"
                           else _j_lm(jm, jnp.float32, G_CACHE))
    jlog, jstates = j_prefill(params, jnp.asarray(toks))
    flog, fstates = f_prefill(params, jnp.asarray(toks))
    tlog, tstates = tlm.prefill(m, {"tokens": torch.from_numpy(toks)},
                                TCtx(cdtype=tdt), G_CACHE, full_logits=True)
    _close(tlog, jlog, tol if dt == "f32" else _stack_tol(jlog, flog))
    cur = np.array([G_S, G_S, 11], np.int32)
    for _ in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jstates = j_decode(params, jnp.asarray(tok), jstates,
                               jnp.asarray(cur))
        fl, fstates = f_decode(params, jnp.asarray(tok), fstates,
                               jnp.asarray(cur))
        tl, tstates = tlm.decode_step(m, torch.from_numpy(tok), tstates,
                                      torch.from_numpy(cur),
                                      TCtx(cdtype=tdt))
        _close(tl, jl, BF16 if dt == "f32" else _stack_tol(jl, fl))
        cur = cur + 1
    _close(tstates[0][2]["v"], jstates[0][2]["v"], BF16)
