"""Port parity: the xLSTM family (xlstm-350m) of the model stack —
``models/layers/xlstm.py`` (mLSTM, sLSTM), the ``ssm`` plan of
``transformer.py``, ``stack.py``, ``lm.py`` and the serving mapper —
against the JAX package's, with the JAX weights carried over by
``repro_torch.convert.lm_params_from_numpy`` and the same numpy inputs,
at ``reduced_config("xlstm-350m")``: 4 layers (2 groups of an mLSTM and
an sLSTM block), d_model 64, 4 heads, mLSTM N = 32 (P = 33), chunk 16.

The parameters that are exactly 0 or 1 at init (``gate_bias``,
``conv_b``, the sLSTM ``bias``, the norm scales) are set to random values
that are not exact in bf16 before converting, so a parameter read at the
wrong precision shows.  Prompts of 40 tokens span three mLSTM chunks.

Tolerances.  At f32 compute a layer's output and state agree within 1e-4
(different summation orders of f32 products).  At bf16 compute the two
packages round intermediates at different places (XLA may keep f32
between fused ops; torch rounds each op), so a layer's values agree
within four bf16 ulps of the largest magnitude in the tensor (2**-5 of
it).  A whole stack's bf16 logits are held to twice JAX's own distance
between its bf16 and f32 logits on the same inputs (``_stack_tol``).
The f32 states are held to the bounds of the values they come from."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import RuntimeConfig
from repro.configs import reduced_config as j_reduced_config
from repro.launch.serve import Request
from repro.ml.serve_app import build_serve_app
from repro.ml.serve_app import request_source as j_request_source
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.models.layers import xlstm as j_xlstm
from repro.models.stack import apply_stack as j_apply_stack
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.workflow import Workflow
from repro_torch.kernels.ssd_scan import kernel as sk
from repro_torch.ml import LMServeMapper, RequestSlate, request_source
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import xlstm as t_xlstm
from repro_torch.models.stack import apply_stack as t_apply_stack

ARCH = "xlstm-350m"
BF16 = ("max", 2**-5)    # four bf16 ulps (2**-7) of the largest value
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
S, CACHE = 40, 48
PERTURBED = ("gate_bias", "conv_b", "bias", "scale")


def _perturb(params, rng):
    """Random values, not exact in bf16, for every parameter that init
    leaves at 0 or 1."""
    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, np.ndarray) and k in PERTURBED:
                    lo, hi = (-1.0, 1.0) if k in ("conv_b", "bias") \
                        else (0.5, 1.5)
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
    assert tcfg.name == jcfg.name and tcfg.family == "ssm"
    jm = jlm.build(jcfg)
    params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
    params = _perturb(jax.tree.map(np.array, params),
                      np.random.default_rng(1))
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


def _t(tree, tdt=torch.float32):
    """A JAX parameter subtree as tensors, cast as ``lm.for_compute``
    casts them for ``tdt``."""
    def leaf(k, a):
        t = torch.from_numpy(np.array(a))
        return t if k in tlm.F32_PARAMS else t.to(tdt)
    return {k: _t(v, tdt) if isinstance(v, dict) else leaf(k, v)
            for k, v in tree.items()}


def _block(params, j):
    """Group 0's parameters of pattern position ``j`` (0 mLSTM, 1 sLSTM)."""
    return jax.tree.map(lambda a: a[0], params["body"]["segments"][0][j])


def test_plan_and_init_match_jax(model):
    """The ssm plan (mLSTM / sLSTM pairs), the parameter shapes and the
    logical specs equal the JAX package's."""
    jcfg, tcfg, jm, params, tm = model
    assert [(tuple(b.name for b in s.pattern), s.n_groups)
            for s in tm.plan.segments] == \
        [(tuple(b.name for b in s.pattern), s.n_groups)
         for s in jm.plan.segments] == [(("mlstm", "slstm"), 2)]
    p, specs = tlm.init(tlm.build(tcfg), torch.Generator().manual_seed(3))
    _, jspecs = jlm.init(jm, jax.random.PRNGKey(0))
    assert specs == jax.tree.map(tuple, jspecs,
                                 is_leaf=lambda s: isinstance(s, tuple))
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape),
                        convert.lm_params_to_numpy(p)) == shapes
    mix = p.body.tree()["segments"][0][0]["mix"]
    assert float(mix["gate_bias"].min()) == 1.0     # ones, as in JAX
    assert abs(float(mix["w_gates"].std()) - 0.02) < 0.005


def test_for_compute_keeps_f32_parameters(model):
    """``gate_bias`` (read in f32 by the JAX mLSTM) and the norm scales
    stay f32 at their f32 values; the rest is cast."""
    _, _, _, params, tm = model
    bf = tlm.for_compute(tm, torch.bfloat16)
    mix = bf.body.tree()["segments"][0][0]["mix"]
    assert mix["gate_bias"].dtype == mix["norm"]["scale"].dtype == \
        torch.float32
    assert np.array_equal(mix["gate_bias"].numpy(),
                          params["body"]["segments"][0][0]["mix"]
                          ["gate_bias"])
    assert mix["w_q"].dtype == mix["conv_b"].dtype == torch.bfloat16
    sl = bf.body.tree()["segments"][0][1]
    assert sl["w_h"].dtype == sl["bias"].dtype == torch.bfloat16
    assert sl["norm"]["scale"].dtype == torch.float32


def _layer_case(model, dt, j, j_apply, t_apply, state_keys):
    """A layer at prefill, then two decode steps from JAX's prefill state
    (written in place), against JAX."""
    jcfg, tcfg, _, params, _ = model
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4 + j)
    B = 2
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jp = _block(params, j)
    jp = jp["mix"] if j == 0 else jp
    tp = _t(jp, tdt)

    def run(phase):
        def f(p, x, state):
            ctx = JCtx(phase=phase, positions=None, cache_len=CACHE,
                       cdtype=jdt)
            return j_apply(p, x, state, ctx, cfg=jcfg)
        return jax.jit(f)

    jy, jst = run("prefill")(jp, jnp.asarray(x, jdt), None)
    ty, tst = t_apply(tp, torch.from_numpy(x).to(tdt), None,
                      TCtx(phase="prefill", cache_len=CACHE, cdtype=tdt),
                      cfg=tcfg)
    assert ty.dtype == tdt
    _close(ty, jy, tol)
    for k in state_keys:
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k], tol)
    state = convert.lm_states_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    views = dict(state)
    for _ in range(2):
        xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jyd, jst = run("decode")(jp, jnp.asarray(xd, jdt), jst)
        tyd, new = t_apply(tp, torch.from_numpy(xd).to(tdt), state,
                           TCtx(phase="decode", cdtype=tdt), cfg=tcfg)
        assert all(new[k] is views[k] for k in state_keys)
        _close(tyd, jyd, tol)
        for k in state_keys:
            _close(state[k], jst[k], tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_mlstm_prefill_and_decode_match_jax(model, dt):
    """The mLSTM at prefill (three chunks of the plain SSD, P = N + 1)
    and two decode steps (``ssd_step``), output and conv / memory state."""
    _layer_case(model, dt, 0, j_xlstm.mlstm_apply, t_xlstm.mlstm_apply,
                ("conv", "mem"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_slstm_prefill_and_decode_match_jax(model, dt):
    """The sLSTM's recurrence over 40 steps and two decode steps, output
    and (h, c, n, m)."""
    _layer_case(model, dt, 1, j_xlstm.slstm_apply, t_xlstm.slstm_apply,
                t_xlstm.SLSTM_STATE)


def test_mlstm_takes_the_plain_ssd_by_the_jax_rule(model):
    """P = N + 1 is odd: the ``ssd_scan`` kernel's ``supported()`` refuses
    it as the JAX package's does, so the dispatcher takes the plain
    version (on a card too)."""
    jcfg, *_ = model
    N = 2 * jcfg.d_model // jcfg.n_heads
    q = torch.zeros((1, 16, jcfg.n_heads, N))
    v = torch.zeros((1, 16, jcfg.n_heads, N + 1))
    assert not sk.supported(q, q, v)
    full = 2 * 1024 // 4                         # xlstm-350m: N = 512
    assert not sk.supported(torch.zeros((1, 1, 4, full)),
                            torch.zeros((1, 1, 4, full)),
                            torch.zeros((1, 1, 4, full + 1)))


def _stack_tol(j_bf16, j_f32, where=Ellipsis):
    """The bf16 bound of a whole stack's output: twice the distance
    between JAX's own bf16 and f32 outputs on the same inputs (over
    ``where``).  The port's f32 stack agrees with JAX's within 1e-4, so
    both bf16 outputs are roundings of one f32 function; one that rounds
    no worse than JAX's lies within that distance of it, and so within
    twice it of JAX's bf16 output."""
    return 2 * float(np.abs(_np(j_bf16) - _np(j_f32))[where].max())


def _j_lm(jm, jdt, cache):
    """JAX's jitted ``prefill`` (full logits) and ``decode_step`` at
    compute dtype ``jdt``."""
    return (jax.jit(lambda p, t: jlm.prefill(
                jm, p, {"tokens": t}, JCtx(cdtype=jdt), cache,
                full_logits=True)),
            jax.jit(lambda p, t, st, cur: jlm.decode_step(
                jm, p, t, st, cur, JCtx(cdtype=jdt))))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_apply_stack_and_lm_logits_match_jax(model, dt):
    """The stack alone at prefill, then ``lm.prefill`` logits at every
    position and four ``decode_step``s, against JAX, with the states after
    the last step."""
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
    _close(tx, jx, tol)
    for j, k in ((0, "mem"), (1, "c"), (1, "m")):
        _close(tst[0][j][k], jst[0][j][k], tol)

    j_prefill, j_decode = _j_lm(jm, jdt, CACHE)
    # JAX at f32 beside JAX at bf16: the bf16 bound (f32 is held to tol)
    f_prefill, f_decode = ((j_prefill, j_decode) if dt == "f32"
                           else _j_lm(jm, jnp.float32, CACHE))
    jlog, jstates = j_prefill(params, jnp.asarray(toks))
    flog, fstates = f_prefill(params, jnp.asarray(toks))
    tlog, tstates = tlm.prefill(m, {"tokens": torch.from_numpy(toks)},
                                TCtx(cdtype=tdt), CACHE, full_logits=True)
    assert tlog.dtype == tdt and tlog.shape == (B, S, jcfg.vocab_size)
    _close(tlog, jlog, tol if dt == "f32" else _stack_tol(jlog, flog))
    cur = np.array([S, S, 20], np.int32)
    for _ in range(4):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jstates = j_decode(params, jnp.asarray(tok), jstates,
                               jnp.asarray(cur))
        fl, fstates = f_decode(params, jnp.asarray(tok), fstates,
                               jnp.asarray(cur))
        tl, tstates = tlm.decode_step(m, torch.from_numpy(tok), tstates,
                                      torch.from_numpy(cur),
                                      TCtx(cdtype=tdt))
        assert tl.shape == (B, 1, jcfg.vocab_size)
        _close(tl, jl, tol if dt == "f32" else _stack_tol(jl, fl))
        cur = cur + 1
    for j, k in ((0, "conv"), (0, "mem"), (1, "h"), (1, "n")):
        _close(tstates[0][j][k], jstates[0][j][k],
               tol if dt == "f32" else BF16)


def test_decode_advances_stacked_states_in_place(model):
    """In decode every mLSTM and sLSTM state is written into the caller's
    stacked tensors: after one step each differs from before, lives in
    the same tensor, and equals JAX's."""
    jcfg, _, jm, params, tm = model
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    ctx = JCtx(cdtype=jnp.float32)
    _, jst = jax.jit(lambda p, t: jlm.prefill(
        jm, p, {"tokens": t}, ctx, CACHE))(params, jnp.asarray(toks))
    jst = jax.tree.map(np.asarray, jst)
    tst = convert.lm_states_from_numpy(jst, "cpu")
    tensors = [(j, k, tst[0][j][k]) for j in range(2) for k in tst[0][j]]
    assert len(tensors) == 2 + 4
    tok = rng.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([S, S], np.int32)
    _, jafter = jax.jit(lambda p, t, st, c: jlm.decode_step(
        jm, p, t, st, c, ctx))(params, jnp.asarray(tok), jst,
                               jnp.asarray(cur))
    _, out = tlm.decode_step(tlm.for_compute(tm, torch.float32),
                             torch.from_numpy(tok), tst,
                             torch.from_numpy(cur), TCtx(cdtype=torch.float32))
    for j, k, t in tensors:
        assert out[0][j][k] is t
        assert not np.array_equal(t.numpy(), jst[0][j][k]), (j, k)
        _close(t, jafter[0][j][k], 1e-4)


def test_params_and_states_round_trip_bitwise(model):
    """The JAX xlstm tree goes into the port and back bit for bit; so do
    its f32 decode states, and zero states have their shapes."""
    jcfg, _, jm, params, tm = model
    back = convert.lm_params_to_numpy(tm)
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
    assert ts[0][0]["mem"].dtype == ts[0][1]["h"].dtype == torch.float32
    again = convert.lm_states_to_numpy(ts)
    la, lb = jax.tree.leaves(states), jax.tree.leaves(again)
    assert len(la) == len(lb) == 6
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    zs = tlm.decode_states(tm, 2, 16, lambda sh, dt, _s: torch.zeros(
        sh, dtype=dt))
    for j in range(2):
        for k in ts[0][j]:
            assert zs[0][j][k].shape == ts[0][j][k].shape


# ---- serving: LMServeMapper -> RequestSlate on the engine ----

PROMPT_LEN, MAX_NEW, CACHE_LEN = 8, 4, 16
NEAR_TIE = 2**-5     # a JAX top-2 logit margin below it is a near-tie


def serve_port(tcfg, model, reqs, *, per_tick, batch, bucket):
    """Serve ``reqs`` on the port's engine; returns the token slates and
    the mapper."""
    mapper = LMServeMapper(tcfg, model, max_new=MAX_NEW,
                           cache_len=CACHE_LEN, bucket=bucket)
    mapper.subscribes = ("requests",)
    mapper.bind({"prompt": ((PROMPT_LEN,), torch.int32),
                 "len": ((), torch.int32)})
    slate = RequestSlate(max_new=MAX_NEW, table_capacity=64)
    slate.subscribes = ("generated",)
    eng = Engine(Workflow([mapper, slate], external_streams=("requests",)),
                 EngineConfig(batch_size=batch), device="cpu")
    state, _ = eng.run(eng.init_state(), request_source(
        reqs, prompt_len=PROMPT_LEN, capacity=batch, per_tick=per_tick,
        device="cpu"), -(-len(reqs) // per_tick))
    state, _ = eng.drain(state)
    rows = eng.read_slates(state, "requests", [r.rid for r in reqs])
    assert all(r is not None and int(r["n"]) == MAX_NEW for r in rows)
    return {r.rid: row["tokens"].numpy() for r, row in zip(reqs, rows)}, \
        mapper


def direct_greedy(mapper, reqs, bucket):
    """Each request's tokens from a greedy loop over ``lm.prefill`` /
    ``lm.decode_step`` on the microbatches the engine forms (``bucket``
    requests in admission order, 0-padded), in the mapper's model."""
    out = {}
    for i in range(0, len(reqs), bucket):
        part = reqs[i:i + bucket]
        toks = np.zeros((bucket, PROMPT_LEN), np.int32)
        lens = np.zeros(bucket, np.int32)
        for j, r in enumerate(part):
            toks[j, :len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        lens_t = torch.from_numpy(lens)
        lg, st = tlm.prefill(mapper.model, {"tokens": torch.from_numpy(toks)},
                             mapper.ctx, CACHE_LEN, full_logits=True)
        rows = torch.arange(bucket)
        tok = torch.argmax(lg[rows, (lens_t - 1).clamp(min=0).long()],
                           -1).to(torch.int32)
        cur, gen = lens_t.clamp(min=1), [tok]
        for _ in range(MAX_NEW - 1):
            lg, st = tlm.decode_step(mapper.model, tok[:, None], st, cur,
                                     mapper.ctx)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
            gen.append(tok)
            cur = cur + 1
        gen = torch.stack(gen, 1).numpy()
        out.update((r.rid, gen[j]) for j, r in enumerate(part))
    return out


def requests(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [Request(rid=i + 1, prompt=rng.integers(
        1, vocab, int(rng.integers(3, PROMPT_LEN + 1))).astype(np.int32),
        max_new=MAX_NEW) for i in range(n)]


def test_serve_app_equals_direct_greedy_and_jax(model):
    """The reduced xlstm served on the engine (8 requests, 4 a tick,
    microbatches of 2): every slate equals the direct greedy loop on the
    same microbatches bitwise, and JAX's ``build_serve_app`` token for
    token but for JAX near-ties (``tests/test_torch_serve_app.py``'s
    rule).  As in the JAX package, pad tokens run through the mLSTM and
    sLSTM prefill and enter a short prompt's state."""
    jcfg, tcfg, jm, params, tm = model
    reqs = requests(8, 8, jcfg.vocab_size)
    got, mapper = serve_port(tcfg, tm, reqs, per_tick=4, batch=4, bucket=2)
    direct = direct_greedy(mapper, reqs, 2)
    for r in reqs:
        assert np.array_equal(got[r.rid], direct[r.rid]), r.rid
    app = build_serve_app(jcfg, params, prompt_len=PROMPT_LEN,
                          max_new=MAX_NEW, cache_len=CACHE_LEN, bucket=2,
                          table_capacity=64)
    app.run(j_request_source(reqs, prompt_len=PROMPT_LEN, capacity=4,
                             per_tick=4), n_ticks=2,
            runtime=RuntimeConfig(batch_size=4, chunk_size=2), drain=True)
    want = {r.rid: np.asarray(app.read_slate("requests", r.rid)["tokens"])
            for r in reqs}
    app.close()
    flipped = 0
    for r in reqs:
        if np.array_equal(got[r.rid], want[r.rid]):
            continue
        first = int(np.argmax(got[r.rid] != want[r.rid]))
        margin = _j_margin(jcfg, jm, params, r, want[r.rid][:first])
        assert margin < NEAR_TIE, (r.rid, got[r.rid], want[r.rid], margin)
        flipped += 1
    assert flipped <= len(reqs) // 4


def _j_margin(jcfg, jm, params, req, prefix):
    """JAX's top-2 logit margin at the step after ``prefix`` of ``req``'s
    greedy run, alone (an xLSTM row depends on its own tokens only)."""
    ctx = JCtx(cdtype=jnp.bfloat16)
    toks = np.zeros((1, PROMPT_LEN), np.int32)
    toks[0, :len(req.prompt)] = req.prompt
    logits, st = jlm.prefill(jm, params, {"tokens": jnp.asarray(toks)}, ctx,
                             CACHE_LEN, full_logits=True)
    lg = np.asarray(logits[0, len(req.prompt) - 1], np.float32)
    cur = len(req.prompt)
    for t in prefix:
        out, st = jlm.decode_step(jm, params, jnp.asarray([[t]], jnp.int32),
                                  st, jnp.asarray([cur], jnp.int32), ctx)
        lg = np.asarray(out[0, 0], np.float32)
        cur += 1
    top = np.sort(lg)[-2:]
    return float(top[1] - top[0])
