"""Port parity at the ``lm`` level for the last two model families:
whisper-tiny's encoder-decoder and llama-3.2-vision-11b's cross-attention
layers (reduced configs), against the JAX package with its weights
carried over by ``repro_torch.convert`` and the same numpy inputs.

The serving engine of both packages feeds zero memories, which null
cross-attention (zero frames give a zero encoder output, and cross layers
have no bias, so their k, v and output are zero), so no token stream
can show a cross-attention fault: here the memories are random.  Norm
scales are perturbed (init sets them to 1).

Tolerances, as in ``tests/test_torch_models.py``: f32 prefill values
within 1e-4; f32 decode logits read bf16 caches (and the plain decode
attention rounds p to bf16), so they are held to 2**-5 of the largest
logit; bf16 whole stacks within twice JAX's own bf16-vs-f32 distance on
the same inputs (``tests/test_torch_xlstm.py::_stack_tol``); one bf16
layer within four bf16 ulps of its largest value (2**-5 of it)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import reduced_config as j_reduced_config
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.models.layers import attention as j_attn
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import attention as t_attn
from tests.test_torch_xlstm import _stack_tol

FAMILIES = ("whisper-tiny", "llama-3.2-vision-11b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
S, CACHE, B = 12, 24, 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)
    return err


def _rel(want):
    """2**-5 of the largest magnitude: four bf16 ulps of it."""
    return 2**-5 * float(np.abs(_np(want)).max())


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jcfg, tcfg = j_reduced_config(name), reduced_config(name)
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(2))
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(3)

    def perturb(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "scale":
                    t[k] = (v * (1 + rng.normal(0, 0.2, v.shape))).astype(
                        np.float32)
                else:
                    perturb(v)
        elif isinstance(t, list):
            for v in t:
                perturb(v)

    perturb(params)
    tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    return name, jcfg, tcfg, jm, params, tm


def _batch(cfg, rng, b=B, s=S, memory=True):
    """Tokens and a random (or zero) memory: whisper's frame embeddings
    (as long as the prompt, as the serving engine makes them) or the
    vision model's image embeddings."""
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.encdec:
        shape = (b, s, cfg.d_model)
        out["enc_frames"] = rng.standard_normal(shape).astype(np.float32)
    else:
        shape = (b, cfg.n_image_tokens, cfg.d_model)
        out["image_embeds"] = rng.standard_normal(shape).astype(np.float32)
    if not memory:
        out = {k: (v if k == "tokens" else np.zeros_like(v))
               for k, v in out.items()}
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch, jdt):
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jdt)
            for k, v in batch.items()}


def _cross_block(name, params):
    """The first cross-attention layer's parameters (group 0) and the
    ``cross_source`` it reads."""
    blocks = params["body"]["segments"][0]
    if name == "whisper-tiny":
        return jax.tree.map(lambda a: a[0], blocks[0]["cross"]), "memory"
    return jax.tree.map(lambda a: a[0], blocks[-1]["attn"]), "image"


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cross_attention_layer_matches_jax(family, dt):
    """One cross-attention sublayer over a random memory: prefill (output
    and the projected k/v it keeps, bf16) and a decode step over them
    (output; the state comes back unchanged)."""
    name, jcfg, tcfg, _, params, _ = family
    jdt, tdt = DTYPES[dt]
    p, source = _cross_block(name, params)
    rng = np.random.default_rng(7)
    n_src = S if name == "whisper-tiny" else jcfg.n_image_tokens
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, n_src, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    key = "image_embeds" if source == "image" else "enc_memory"
    jctx = JCtx(phase="prefill", cdtype=jdt, cache_len=CACHE,
                **{key: jnp.asarray(mem, jdt)})
    tctx = TCtx(phase="prefill", cdtype=tdt, cache_len=CACHE,
                **{key: torch.from_numpy(mem).to(tdt)})
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    j_out, j_st = j_attn.apply(p, jnp.asarray(x, jdt), None, jctx, cfg=jcfg,
                               is_cross=True, cross_source=source)
    t_out, t_st = t_attn.apply(tp, torch.from_numpy(x).to(tdt), None, tctx,
                               cfg=tcfg, is_cross=True, cross_source=source)
    tol = 1e-4 if dt == "f32" else _rel(j_out)
    _close(t_out, j_out, tol, "cross prefill output")
    assert t_st["k"].dtype == torch.bfloat16
    assert tuple(t_st["k"].shape) == (B, n_src, jcfg.n_heads,
                                      jcfg.resolved_head_dim)
    for k in ("k", "v"):
        # bf16 caches: one bf16 rounding of values agreeing in f32
        _close(t_st[k], j_st[k], _rel(j_st[k]), f"cross state {k}")
    # decode over JAX's state (the same bits in both)
    st = convert.lm_states_from_numpy(
        jax.tree.map(np.asarray, j_st), device="cpu")
    dj = JCtx(phase="decode", cdtype=jdt)
    dt_ = TCtx(phase="decode", cdtype=tdt)
    j_y, j_st2 = j_attn.apply(p, jnp.asarray(x1, jdt), j_st, dj, cfg=jcfg,
                              is_cross=True, cross_source=source)
    t_y, t_st2 = t_attn.apply(tp, torch.from_numpy(x1).to(tdt), st, dt_,
                              cfg=tcfg, is_cross=True, cross_source=source)
    _close(t_y, j_y, _rel(j_y), "cross decode output")
    assert t_st2 is st


def test_whisper_encode_matches_jax(family):
    """``lm.encode``: the bidirectional encoder over random frames, at f32
    (1e-4) and bf16 (twice JAX's own bf16-vs-f32 distance)."""
    name, jcfg, tcfg, jm, params, tm = family
    if name != "whisper-tiny":
        # llama-3.2-vision has no encoder: both packages build none
        assert jm.enc_plan is None and tm.enc_plan is None
        assert not hasattr(tm, "enc_body")
        return
    frames = np.random.default_rng(9).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    j = {}
    for dt, (jdt, tdt) in DTYPES.items():
        j[dt] = jax.jit(lambda p, f, jdt=jdt: jlm.encode(
            jm, p, f, JCtx(cdtype=jdt, phase="prefill")))(
                params, jnp.asarray(frames))
    for dt, (jdt, tdt) in DTYPES.items():
        got = tlm.encode(tm, torch.from_numpy(frames),
                         TCtx(cdtype=tdt, phase="prefill"))
        assert got.dtype == tdt
        tol = 1e-4 if dt == "f32" else _stack_tol(j["bf16"], j["f32"])
        _close(got, j[dt], tol, f"encode {dt}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_and_decode_match_jax(family, dt):
    """``lm.prefill`` logits at every position and three ``decode_step``s
    with random memories, against JAX; the states after the last step
    (self caches written, cross caches as prefill left them)."""
    name, jcfg, tcfg, jm, params, tm = family
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(11)
    batch = _batch(jcfg, rng)
    steps = rng.integers(1, jcfg.vocab_size, (3, B, 1)).astype(np.int32)

    def j_run(jdt):
        pre = jax.jit(lambda p, b: jlm.prefill(jm, p, b, JCtx(cdtype=jdt),
                                               CACHE, full_logits=True))
        dec = jax.jit(lambda p, t, st, cur: jlm.decode_step(
            jm, p, t, st, cur, JCtx(cdtype=jdt)))
        logits, st = pre(params, _jbatch(batch, jdt))
        outs = [logits]
        cur = jnp.full((B,), S, jnp.int32)
        for t in steps:
            lg, st = dec(params, jnp.asarray(t), st, cur)
            outs.append(lg)
            cur = cur + 1
        return outs, st

    j_outs, j_st = j_run(jdt)
    tmc = tlm.for_compute(tm, tdt) if dt == "bf16" else tm
    ctx = TCtx(cdtype=tdt)
    logits, st = tlm.prefill(tmc, _tbatch(batch), ctx, CACHE,
                             full_logits=True)
    t_outs = [logits]
    cur = torch.full((B,), S, dtype=torch.int32)
    for t in steps:
        lg, st = tlm.decode_step(tmc, torch.from_numpy(t), st, cur, ctx)
        t_outs.append(lg)
        cur = cur + 1
    if dt == "f32":
        tols = [1e-4] + [_rel(j) for j in j_outs[1:]]
    else:
        j32, _ = j_run(jnp.float32)
        tols = [_stack_tol(a, b) for a, b in zip(j_outs, j32)]
    for i, (got, want, tol) in enumerate(zip(t_outs, j_outs, tols)):
        _close(got, want, tol, f"{name} {dt} logits, call {i}")
    t_leaves = jax.tree.leaves(convert.lm_states_to_numpy(st))
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, j_st))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, _rel(b) if dt == "f32" else
               2 * _rel(b), f"{name} {dt} states")


def test_prefill_then_decode_is_consistent(family):
    """In f32, a decode step after a prefill of S tokens gives the logits
    a prefill of S + 1 tokens gives at its last position (the decode
    reads bf16 caches: 2**-5 of the largest logit)."""
    name, jcfg, tcfg, jm, params, tm = family
    rng = np.random.default_rng(13)
    batch = _batch(jcfg, rng, s=S + 1)
    ctx = TCtx(cdtype=torch.float32)
    full = _tbatch(batch)
    short = dict(full, tokens=full["tokens"][:, :S])
    if jcfg.encdec:   # the same memory: frames of the longer prompt
        short["enc_frames"] = full["enc_frames"]
    want, _ = tlm.prefill(tm, full, ctx, CACHE, full_logits=True)
    _, st = tlm.prefill(tm, short, ctx, CACHE, full_logits=True)
    got, _ = tlm.decode_step(tm, full["tokens"][:, S:], st,
                             torch.full((B,), S, dtype=torch.int32), ctx)
    _close(got[:, 0], want[:, S], _rel(want[:, S]), f"{name} consistency")


def test_memories_reach_the_logits(family):
    """Cross-attention is live: a random memory moves the logits well past
    the f32 tolerance, and a zero memory (the serving engine's) makes
    every cross layer's output exactly zero — the logits then equal a run
    whose cross layers are skipped."""
    name, jcfg, tcfg, jm, params, tm = family
    rng = np.random.default_rng(17)
    ctx = TCtx(cdtype=torch.float32)
    with_mem = _batch(jcfg, rng)
    zero_mem = dict(with_mem, **{k: np.zeros_like(v) for k, v in
                                 with_mem.items() if k != "tokens"})
    a, _ = tlm.prefill(tm, _tbatch(with_mem), ctx, CACHE)
    b, _ = tlm.prefill(tm, _tbatch(zero_mem), ctx, CACHE)
    assert float((a - b).abs().max()) > 100 * 1e-4
    seen = []
    real = t_attn.apply

    def spy(p, x, state, ctx, **kw):
        out, st = real(p, x, state, ctx, **kw)
        if kw.get("is_cross"):
            seen.append(float(out.abs().max()))
        return out, st

    t_attn.apply = spy
    try:
        tlm.prefill(tm, _tbatch(zero_mem), ctx, CACHE)
    finally:
        t_attn.apply = real
    n_cross = jcfg.n_layers if jcfg.encdec else \
        jcfg.n_layers // jcfg.cross_attn_every
    assert seen == [0.0] * n_cross


def test_params_and_states_round_trip_bitwise(family):
    """``convert`` carries ``enc_body`` / ``enc_norm``, the cross layers'
    full-head ``wk`` / ``wv`` and the ``{"self", "cross"}`` states both
    ways, bit for bit."""
    name, jcfg, tcfg, jm, params, tm = family
    back = convert.lm_params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if jcfg.encdec:
        assert "enc_body" in back and "enc_norm" in back
        cross = back["body"]["segments"][0][0]["cross"]
    else:
        cross = back["body"]["segments"][0][-1]["attn"]
        self_wk = back["body"]["segments"][0][0]["attn"]["wk"]
        assert self_wk.shape[2] == jcfg.n_kv_heads
    assert cross["wk"].shape[2] == jcfg.n_heads
    batch = _batch(jcfg, np.random.default_rng(19))
    _, j_st = jax.jit(lambda p, b: jlm.prefill(
        jm, p, b, JCtx(cdtype=jnp.bfloat16), CACHE))(
            params, _jbatch(batch, jnp.bfloat16))
    j_st = jax.tree.map(np.asarray, j_st)
    t_st = convert.lm_states_from_numpy(j_st, device="cpu")
    back = convert.lm_states_to_numpy(t_st)
    assert jax.tree.structure(back) == jax.tree.structure(j_st)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_st)):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
            b.view(np.uint16) if b.dtype.name == "bfloat16" else b)
