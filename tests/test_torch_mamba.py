"""Port parity: the hybrid family (zamba2) of the model stack —
``models/layers/mamba2.py``, the hybrid plan of ``transformer.py`` with
its weight-shared attention block (``use_extra``) and tail segment,
``stack.py`` and ``lm.py`` — against the JAX package's, with the JAX
weights carried over by ``repro_torch.convert.lm_params_from_numpy`` and
the same numpy inputs, at ``reduced_config("zamba2-1.2b")``: 8 layers
(2 groups of 3 Mamba-2 blocks and the shared block, then a tail of 2),
d_model 64, N = P = 16, chunk 32.

The parameters that are exactly 0 or 1 at init (``a_log``, ``dt_bias``,
``d_skip``, ``conv_b``, the norm scales) are set to random values that
are not exact in bf16 before converting, so a parameter read at the
wrong precision shows.  Prompts of 48 tokens span two chunks.

Tolerances are those of ``tests/test_torch_models.py``: at f32 compute
every value within 1e-4; at bf16 compute the two packages round
intermediates at different places, so values agree within four bf16 ulps
of the largest magnitude in the tensor (2**-5 of it).  The f32 SSM
states are held to the same bounds as the values they come from."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import reduced_config as j_reduced_config
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.models.layers import mamba2 as j_mamba2
from repro.models.stack import apply_stack as j_apply_stack
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import mamba2 as t_mamba2
from repro_torch.models.stack import apply_stack as t_apply_stack

ARCH = "zamba2-1.2b"
BF16 = ("max", 2**-5)    # four bf16 ulps (2**-7) of the largest value
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
S, CACHE = 48, 64


def _perturb(params, rng):
    """Random values, not exact in bf16, for every parameter that init
    leaves at 0 or 1."""
    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, np.ndarray) and k in (
                        "a_log", "dt_bias", "d_skip", "conv_b", "scale"):
                    lo, hi = {"a_log": (-1.5, 1.0), "dt_bias": (-2.0, 1.0)
                              }.get(k, (0.5, 1.5))
                    t[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
                else:
                    walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(params)
    return params


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = j_reduced_config(ARCH), reduced_config(ARCH)
    assert tcfg.name == jcfg.name and tcfg.family == "hybrid"
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
    params = _perturb(jax.tree.map(np.array, params),
                      np.random.default_rng(1))
    a_log = params["body"]["segments"][0][0]["mix"]["a_log"]
    assert not np.array_equal(a_log.astype(jnp.bfloat16).astype(np.float32),
                              a_log)
    tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
    return jcfg, tcfg, jm, params, tm


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    bound = tol[1] * float(np.abs(b).max()) if isinstance(tol, tuple) \
        else tol
    err = float(np.abs(a - b).max())
    assert err <= bound, (err, bound)


def _mamba0(params):
    """Layer 0's Mamba-2 mixer parameters of the stacked JAX tree."""
    return jax.tree.map(lambda a: a[0],
                        params["body"]["segments"][0][0]["mix"])


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_plan_and_init_match_jax(model):
    """The hybrid plan (groups of Mamba-2 blocks closed by the shared
    block, a tail segment), ``init_stack``'s ``None`` placeholder and
    ``extra`` dict, and the logical specs equal the JAX package's."""
    jcfg, tcfg, jm, params, tm = model
    plan = tm.plan
    assert [(len(s.pattern), s.n_groups) for s in plan.segments] == \
        [(len(s.pattern), s.n_groups) for s in jm.plan.segments] == \
        [(4, 2), (2, 1)]
    assert [b.name for b in plan.extra_blocks] == ["shared_attn"]
    assert plan.segments[0].pattern[3].use_extra
    p, specs = tlm.init(tlm.build(tcfg), torch.Generator().manual_seed(3))
    tree = p.body.tree()
    assert tree["segments"][0][3] is None
    assert set(tree["extra"]) == {"shared_attn"}
    _, jspecs = jlm.init(jm, jax.random.PRNGKey(0))
    assert specs == jax.tree.map(tuple, jspecs,
                                 is_leaf=lambda s: isinstance(s, tuple))
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape),
                        convert.lm_params_to_numpy(p)) == shapes
    assert sum(x.numel() for x in p.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))


def test_for_compute_keeps_f32_parameters(model):
    """``for_compute`` casts weights to the compute dtype once but keeps
    every parameter the JAX layers read in f32 (norm scales, ``a_log``,
    ``dt_bias``) at its f32 value; the shared block's ``None`` survives."""
    _, _, _, params, tm = model
    bf = tlm.for_compute(tm, torch.bfloat16)
    mix = bf.body.tree()["segments"][0][0]["mix"]
    for k in ("a_log", "dt_bias"):
        assert mix[k].dtype == torch.float32
        assert np.array_equal(
            mix[k].numpy(), params["body"]["segments"][0][0]["mix"][k])
    assert mix["norm"]["scale"].dtype == torch.float32
    assert mix["in_proj"].dtype == mix["d_skip"].dtype == torch.bfloat16
    assert bf.body.tree()["segments"][0][3] is None
    assert bf.body.tree()["extra"]["shared_attn"]["attn"]["wq"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_mamba2_prefill_and_decode_match_jax(model, dt):
    jcfg, tcfg, _, params, _ = model
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    B = 2
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jp = _mamba0(params)
    tp = _t(jp)
    if tdt == torch.bfloat16:   # as the served model holds them
        tp = {k: (v if k in tlm.F32_PARAMS or not isinstance(v, torch.Tensor)
                  else v.to(tdt)) for k, v in tp.items()}

    def j_apply(phase):
        def f(p, x, state):
            ctx = JCtx(phase=phase, positions=jnp.asarray(pos),
                       cache_len=CACHE, cdtype=jdt)
            return j_mamba2.apply(p, x, state, ctx, cfg=jcfg)
        return jax.jit(f)

    jy, jst = j_apply("prefill")(jp, jnp.asarray(x), None)
    ty, tst = t_mamba2.apply(tp, torch.from_numpy(x), None,
                             TCtx(phase="prefill", cache_len=CACHE,
                                  cdtype=tdt), cfg=tcfg)
    assert ty.dtype == tdt
    _close(ty, jy, tol)
    assert tst["conv"].dtype == tst["ssd"].dtype == torch.float32
    for k in ("conv", "ssd"):
        _close(tst[k], jst[k], tol)
    # two decode steps from JAX's prefill state, written in place
    state = convert.lm_states_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    views = dict(state)
    for step in range(2):
        xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jyd, jst = j_apply("decode")(jp, jnp.asarray(xd), jst)
        tyd, new = t_mamba2.apply(tp, torch.from_numpy(xd), state,
                                  TCtx(phase="decode", cdtype=tdt), cfg=tcfg)
        assert new["conv"] is views["conv"] and new["ssd"] is views["ssd"]
        _close(tyd, jyd, tol)
        for k in ("conv", "ssd"):
            _close(state[k], jst[k], tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_apply_stack_and_lm_logits_match_jax(model, dt):
    """The stack alone at prefill, then ``lm.prefill`` logits at every
    position and four ``decode_step``s, against JAX, with the SSM and KV
    states after the last step."""
    jcfg, tcfg, jm, params, tm = model
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    B = 3
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jx, jst, _ = jax.jit(lambda body, x, pos: j_apply_stack(
        body, jm.plan, x, None, JCtx(phase="prefill", positions=pos,
                                     cache_len=CACHE, cdtype=jdt),
        remat=False))(params["body"], jnp.asarray(x, jdt), jnp.asarray(pos))
    m = tlm.for_compute(tm, tdt)
    tx, tst, aux = t_apply_stack(
        m.body.tree(), m.plan, torch.from_numpy(x).to(tdt), None,
        TCtx(phase="prefill", positions=torch.from_numpy(pos),
             cache_len=CACHE, cdtype=tdt))
    assert aux == 0.0
    _close(tx, jx, BF16 if dt == "bf16" else tol)
    for si, blk in ((0, 0), (0, 2), (1, 1)):
        _close(tst[si][blk]["ssd"], jst[si][blk]["ssd"], BF16)
    _close(tst[0][3]["k"], jst[0][3]["k"], BF16)
    jlog, jstates = jax.jit(lambda p, t: jlm.prefill(
        jm, p, {"tokens": t}, JCtx(cdtype=jdt), CACHE, full_logits=True))(
            params, jnp.asarray(toks))
    j_decode = jax.jit(lambda p, t, st, cur: jlm.decode_step(
        jm, p, t, st, cur, JCtx(cdtype=jdt)))
    tlog, tstates = tlm.prefill(m, {"tokens": torch.from_numpy(toks)},
                                TCtx(cdtype=tdt), CACHE, full_logits=True)
    assert tlog.dtype == tdt and tlog.shape == (B, S, jcfg.vocab_size)
    _close(tlog, jlog, tol)
    cur = np.array([S, S, 20], np.int32)
    for _ in range(4):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jstates = j_decode(params, jnp.asarray(tok), jstates,
                                 jnp.asarray(cur))
        tlog, tstates = tlm.decode_step(m, torch.from_numpy(tok), tstates,
                                        torch.from_numpy(cur),
                                        TCtx(cdtype=tdt))
        assert tlog.shape == (B, 1, jcfg.vocab_size)
        _close(tlog, jlog, tol)
        cur = cur + 1
    for si, blk in ((0, 1), (1, 0)):
        for k in ("conv", "ssd"):
            _close(tstates[si][blk][k], jstates[si][blk][k], BF16)
    _close(tstates[0][3]["v"], jstates[0][3]["v"], BF16)


def test_decode_advances_stacked_ssm_state_in_place(model):
    """``apply_stack`` returns the caller's stacked states in decode, so a
    block must write into its group's views: after one step every Mamba-2
    state differs from before, lives in the same tensor, and equals
    JAX's."""
    jcfg, _, jm, params, tm = model
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    ctx = JCtx(cdtype=jnp.float32)
    _, jst = jax.jit(lambda p, t: jlm.prefill(
        jm, p, {"tokens": t}, ctx, CACHE))(params, jnp.asarray(toks))
    jst = jax.tree.map(np.asarray, jst)
    tst = convert.lm_states_from_numpy(jst, "cpu")    # owned copies
    before = jst
    tensors = [(si, j, k, tst[si][j][k]) for si in range(2)
               for j in range(len(tst[si])) for k in ("conv", "ssd")
               if "ssd" in tst[si][j]]
    assert len(tensors) == 2 * 5       # 3 + 2 Mamba-2 pattern positions
    tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([S, S], np.int32)
    _, jafter = jax.jit(lambda p, t, st, c: jlm.decode_step(
        jm, p, t, st, c, ctx))(params, jnp.asarray(tok), jst,
                               jnp.asarray(cur))
    _, out = tlm.decode_step(tlm.for_compute(tm, torch.float32),
                             torch.from_numpy(tok), tst,
                             torch.from_numpy(cur), TCtx(cdtype=torch.float32))
    for si, j, k, t in tensors:
        assert out[si][j][k] is t
        assert not np.array_equal(t.numpy(), before[si][j][k]), (si, j, k)
        _close(t, jafter[si][j][k], 1e-4)


def test_params_and_states_round_trip_bitwise(model):
    """The JAX zamba2 tree, ``None`` and ``extra`` included, goes into the
    port and back bit for bit; so do mixed SSM (f32) / KV (bf16) decode
    states."""
    jcfg, _, jm, params, tm = model
    back = convert.lm_params_to_numpy(tm)
    assert back["body"]["segments"][0][3] is None
    assert set(back["body"]["extra"]) == {"shared_attn"}
    flat_j, tree_j = jax.tree.flatten(params)
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _, states = jax.jit(lambda p, t: jlm.prefill(
        jm, p, {"tokens": t}, JCtx(cdtype=jnp.bfloat16), 16))(
            params, jnp.ones((2, 8), jnp.int32))
    states = jax.tree.map(np.asarray, states)
    ts = convert.lm_states_from_numpy(states, "cpu")
    assert ts[0][0]["ssd"].dtype == torch.float32
    assert ts[0][3]["k"].dtype == torch.bfloat16
    again = convert.lm_states_to_numpy(ts)
    la, lb = jax.tree.leaves(states), jax.tree.leaves(again)
    assert len(la) == len(lb) == 2 * 5 + 2
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    zs = tlm.decode_states(tm, 2, 16, lambda sh, dt, _s: torch.zeros(
        sh, dtype=dt))
    assert zs[0][0]["ssd"].shape == ts[0][0]["ssd"].shape
    assert zs[0][3]["k"].shape == ts[0][3]["k"].shape
