"""Port parity: the DeepSeek family of the model stack —
``models/layers/moe.py`` (routing, sort-based dispatch with a fixed
capacity, batched expert FFN, shared experts), ``models/layers/mla.py``
(latent caches), the ``moe`` plan of ``transformer.py`` and the serving
mapper — against the JAX package's, with the JAX weights carried over by
``repro_torch.convert.lm_params_from_numpy`` and the same numpy inputs,
at ``reduced_config`` of deepseek-moe-16b (MoE with plain attention) and
deepseek-v2-lite-16b (MoE with MLA): 3 layers (one dense, two MoE),
d_model 64, 8 routed experts top-2 and one shared, capacity factor 4.0;
cases at capacity factor 1.0 drop entries.

The norm scales (ones at init) are set to random values that are not
exact in bf16 before converting.

Tolerances.  Routing is held bitwise on f32 inputs: expert ids, the
kept / dropped mask and the load-balance loss.  At f32 compute a layer's
output and state agree within 1e-4 (different summation orders of f32
products).  At bf16 compute the two packages round intermediates at
different places (XLA may keep f32 between fused ops; torch rounds each
op), so a layer's values agree within four bf16 ulps of the largest
magnitude in the tensor (2**-5 of it).  Whole stacks: prefill logits at
f32 within 1e-4; a decode step reads the bf16 caches, where an f32 value
within 1e-7 of a bf16 rounding boundary may round either way in the two
packages, so decode logits at f32 agree within the bf16 bound.  At bf16
a token's routing in a later layer may flip where the router's top-k
gap is a near-tie (the bf16 roundings reach the router's input): every
routing decision that differs from JAX's must be at a JAX near-tie
(``ROUTE_TIE``), the positions it can reach (its own and later ones of
its row) are left out, and the rest agree within twice JAX's own
distance between its bf16 and f32 logits on the same inputs, taken over
the positions no flip between JAX's bf16 and f32 routing reaches (the
same near-tie rule holds there)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import reduced_config as j_reduced_config
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.models.layers import mla as j_mla
from repro.models.layers import moe as j_moe
from repro.models.stack import apply_stack as j_apply_stack
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.models.layers import mla as t_mla
from repro_torch.models.layers import moe as t_moe
from repro_torch.models.stack import apply_stack as t_apply_stack
from tests.test_torch_xlstm import (_close, _j_lm, _np, _stack_tol, _t,
                                    direct_greedy, requests, serve_port)

ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
BF16 = ("max", 2**-5)    # four bf16 ulps (2**-7) of the largest value
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
ROUTE_TIE = 2**-5        # a router-logit gap below it is a near-tie
S, CACHE = 24, 40


def _cfgs(arch, cf=None):
    jcfg, tcfg = j_reduced_config(arch), reduced_config(arch)
    if cf is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cf))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=cf))
    return jcfg, tcfg


def _perturb(params, rng):
    """Norm scales (ones at init) set to random values."""
    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, np.ndarray) and k == "scale":
                    t[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                else:
                    walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(params)
    return params


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        assert tcfg.name == jcfg.name and tcfg.moe is not None
        jm = jlm.build(jcfg)
        params = jax.jit(lambda k: jlm.init(jm, k)[0])(jax.random.PRNGKey(0))
        params = _perturb(jax.tree.map(np.array, params),
                          np.random.default_rng(1))
        tm = convert.lm_params_from_numpy(params, tcfg, device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jm, params, tm)
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _moe_layer(params):
    """The first MoE layer's block parameters (segment 1, group 0)."""
    return jax.tree.map(lambda a: a[0], params["body"]["segments"][1][0])


# ---------------------------------------------------------------- routing

def _j_routing(monkeypatch, jcfg, p, x):
    """JAX's own routing of ``x``: an eager call of ``moe._apply_global``
    with ``top_k``, ``argsort`` and ``searchsorted`` recorded.  Returns
    (y, aux, expert ids [T,K], kept mask over the flat [T*K] entries)."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[name] = out
            return out
        return wrapped

    monkeypatch.setattr(jax.lax, "top_k", spy("top_k", jax.lax.top_k))
    monkeypatch.setattr(jnp, "argsort", spy("argsort", jnp.argsort))
    monkeypatch.setattr(jnp, "searchsorted",
                        spy("searchsorted", jnp.searchsorted))
    y, aux = j_moe._apply_global(p, jnp.asarray(x), JCtx(cdtype=jnp.float32),
                                 cfg=jcfg)
    monkeypatch.undo()
    T = x.shape[0] * x.shape[1]
    cap = t_moe.capacity(T, jcfg.moe)
    order = np.asarray(seen["argsort"])
    rank = np.arange(order.size) - np.asarray(seen["searchsorted"])
    kept = np.zeros(order.size, bool)
    kept[order] = rank < cap
    return y, aux, np.asarray(seen["top_k"][1]), kept


@pytest.mark.parametrize("cf", [None, 1.0], ids=["cf4", "cf1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_matches_jax_bitwise(monkeypatch, arch, cf):
    """On f32 inputs the port picks JAX's experts, keeps and drops JAX's
    entries (the stable sort keeps each expert's first ``cap`` in token
    order), and gives JAX's load-balance loss, bit for bit; at capacity
    factor 1.0 entries drop."""
    jcfg, tcfg = _cfgs(arch, cf)
    params = _model(arch)[3]
    p = _moe_layer(params)["mlp"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32, jcfg.d_model)).astype(np.float32)
    jy, jaux, jids, jkept = _j_routing(monkeypatch, jcfg, p, x)
    T = x.shape[0] * x.shape[1]
    tp = _t(p)
    gate, ids, aux = t_moe.route(tp["router"], torch.from_numpy(x).reshape(
        T, -1), tcfg.moe)
    cap = t_moe.capacity(T, tcfg.moe)
    order, slot, valid = t_moe.dispatch(ids, cap)
    kept = np.zeros(T * tcfg.moe.top_k, bool)
    kept[order.numpy()] = valid.numpy()
    assert np.array_equal(ids.numpy(), jids)
    assert np.array_equal(kept, jkept)
    assert aux.dtype == torch.float32
    assert np.float32(aux.item()).tobytes() == \
        np.asarray(jaux, np.float32).tobytes(), (aux.item(), float(jaux))
    if cf is None:
        assert kept.all()
    else:
        assert cap == 32 and not kept.all()
    ty, taux = t_moe.apply(tp, torch.from_numpy(x), TCtx(cdtype=torch.float32),
                           cfg=tcfg)
    assert taux.item() == aux.item()
    _close(ty, jy, 1e-4)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cf", [None, 1.0], ids=["cf4", "cf1"])
def test_moe_layer_matches_jax(model, cf, dt):
    """The MoE sublayer (routing, dispatch, experts, combine, shared
    experts) at a prefill shape (48 tokens) and a decode shape (one
    token a row), output and loss."""
    jcfg, tcfg = _cfgs(model[0].name, cf)
    jdt, tdt, tol = DTYPES[dt]
    p = _moe_layer(model[3])["mlp"]
    tp = _t(p, tdt)
    rng = np.random.default_rng(8)
    f = jax.jit(lambda p, x: j_moe.apply(p, x, JCtx(cdtype=jdt), cfg=jcfg))
    for shape in ((2, S), (3, 1)):
        x = rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
        jy, jaux = f(p, jnp.asarray(x, jdt))
        ty, taux = t_moe.apply(tp, torch.from_numpy(x).to(tdt),
                               TCtx(cdtype=tdt), cfg=tcfg)
        assert ty.dtype == tdt and taux.dtype == torch.float32
        _close(ty, jy, tol)
        _close(taux, jaux, 1e-7)


def test_moe_combine_repeats_bitwise(model):
    """The combine sums each token's entries in a fixed order (no
    scatter-add): the same inputs give the same bits."""
    jcfg, tcfg, _, params, _ = model
    tp = _t(_moe_layer(params)["mlp"], torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 32, jcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    a = t_moe.apply(tp, x, TCtx(), cfg=tcfg)[0]
    b = t_moe.apply(tp, x.clone(), TCtx(), cfg=tcfg)[0]
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# -------------------------------------------------------------------- MLA

@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_mla_prefill_and_decode_match_jax(dt):
    """MLA at prefill (latents, queries, decompression, causal attention;
    the latent caches padded to the cache length) and two decode steps
    from JAX's prefill state, the caches written in place."""
    jcfg, tcfg, _, params, _ = _model("deepseek-v2-lite-16b")
    jdt, tdt, tol = DTYPES[dt]
    jp = _moe_layer(params)["attn"]
    tp = _t(jp, tdt)
    rng = np.random.default_rng(10)
    B = 2
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))

    def run(phase):
        def f(p, x, state, positions, cur):
            ctx = JCtx(phase=phase, positions=positions, cur_index=cur,
                       cache_len=CACHE, cdtype=jdt)
            return j_mla.apply(p, x, state, ctx, cfg=jcfg)
        return jax.jit(f)

    jy, jst = run("prefill")(jp, jnp.asarray(x, jdt), None, jnp.asarray(pos),
                             None)
    ty, tst = t_mla.apply(tp, torch.from_numpy(x).to(tdt), None,
                          TCtx(phase="prefill",
                               positions=torch.from_numpy(pos),
                               cache_len=CACHE, cdtype=tdt), cfg=tcfg)
    assert ty.dtype == tdt
    _close(ty, jy, tol)
    for k in ("c_kv", "k_rope"):
        assert tst[k].dtype == torch.bfloat16 and tst[k].shape[1] == CACHE
        _close(tst[k], jst[k], BF16)
    state = convert.lm_states_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    views = dict(state)
    cur = np.array([S, 7], np.int32)
    for _ in range(2):
        xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jyd, jst = run("decode")(jp, jnp.asarray(xd, jdt), jst,
                                 jnp.asarray(cur[:, None]), jnp.asarray(cur))
        tyd, new = t_mla.apply(
            tp, torch.from_numpy(xd).to(tdt), state,
            TCtx(phase="decode", positions=torch.from_numpy(cur[:, None]),
                 cur_index=torch.from_numpy(cur), cache_len=CACHE,
                 cdtype=tdt), cfg=tcfg)
        assert all(new[k] is views[k] for k in views)
        _close(tyd, jyd, tol)
        for k in ("c_kv", "k_rope"):
            _close(state[k], jst[k], BF16)
        cur = cur + 1


# ------------------------------------------------------------ whole stacks

def test_plan_and_init_match_jax(model):
    """The moe plan (a dense segment, then the MoE segment; MLA where the
    config has it), the parameter shapes and the logical specs equal the
    JAX package's."""
    jcfg, tcfg, jm, params, tm = model
    assert [(b.name, s.n_groups) for s in tm.plan.segments
            for b in s.pattern] == [(b.name, s.n_groups)
                                    for s in jm.plan.segments
                                    for b in s.pattern] == \
        [("dense", 1), ("moe", 2)]
    p, specs = tlm.init(tlm.build(tcfg), torch.Generator().manual_seed(3))
    _, jspecs = jlm.init(jm, jax.random.PRNGKey(0))
    assert specs == jax.tree.map(tuple, jspecs,
                                 is_leaf=lambda s: isinstance(s, tuple))
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape),
                        convert.lm_params_to_numpy(p)) == shapes
    attn = p.body.tree()["segments"][1][0]["attn"]
    assert ("c_kv" in tm.plan.segments[1].pattern[0].state_spec(1, 4)) == \
        (tcfg.mla is not None) == ("w_dkv" in attn)


def test_for_compute_keeps_router_f32(model):
    """The router (read in f32 by the JAX MoE) and the norm scales stay
    f32 at their f32 values; the experts are cast."""
    _, _, _, params, tm = model
    bf = tlm.for_compute(tm, torch.bfloat16)
    blk = bf.body.tree()["segments"][1][0]
    assert blk["mlp"]["router"].dtype == torch.float32
    assert np.array_equal(blk["mlp"]["router"].numpy(),
                          params["body"]["segments"][1][0]["mlp"]["router"])
    assert blk["mlp"]["w_gate"].dtype == torch.bfloat16
    assert blk["mlp"]["shared"]["w_in"].dtype == torch.bfloat16
    assert blk["ln1"]["scale"].dtype == torch.float32
    if "kv_norm" in blk["attn"]:
        assert blk["attn"]["kv_norm"]["scale"].dtype == torch.float32


class _Routes:
    """Records every routing decision of a run: JAX's through a callback
    on ``jax.lax.top_k`` (inside jit and scan), the port's by wrapping
    ``moe.route``.  ``take()`` returns and clears the calls so far."""

    def __init__(self, monkeypatch):
        self.j, self.t = [], []
        top_k, route = jax.lax.top_k, t_moe.route

        def j_spy(probs, k):
            out = top_k(probs, k)
            jax.debug.callback(lambda p, i: self.j.append(
                (np.asarray(p), np.asarray(i))), probs, out[1], ordered=True)
            return out

        def t_spy(router, xt, m):
            out = route(router, xt, m)
            self.t.append(out[1].numpy())
            return out

        monkeypatch.setattr(jax.lax, "top_k", j_spy)
        monkeypatch.setattr(t_moe, "route", t_spy)

    def take(self):
        jax.effects_barrier()
        out = (self.j, self.t)
        self.j, self.t = [], []
        return out


def _first_flips(j_calls, t_calls, K, S, first):
    """Lower ``first[row]`` to each position whose top-k set differs
    between JAX's and the port's routing calls (tokens ``row * S +
    pos``).  A difference at a position no earlier difference reaches
    must be at a near-tie of JAX's router logits (their K-th and
    (K+1)-th differ by less than ``ROUTE_TIE``)."""
    assert len(j_calls) == len(t_calls) > 0
    for (probs, jid), tid in zip(j_calls, t_calls):
        lp = np.log(-np.sort(-probs.astype(np.float64), -1))
        gap = lp[:, K - 1] - lp[:, K]
        for i in np.flatnonzero([set(a.tolist()) != set(b.tolist())
                                 for a, b in zip(jid, tid)]):
            r, s = divmod(int(i), S)
            if s < first[r]:
                assert gap[i] < ROUTE_TIE, (r, s, float(gap[i]))
            first[r] = min(first[r], s)
    return first


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_apply_stack_and_lm_logits_match_jax(model, dt, monkeypatch):
    """The stack alone at prefill, then ``lm.prefill`` logits at every
    position and three ``decode_step``s, against JAX (routing-aware in
    bf16, see the module docstring), with the caches after the last
    step."""
    jcfg, tcfg, jm, params, tm = model
    jdt, tdt, tol = DTYPES[dt]
    K = jcfg.moe.top_k
    rng = np.random.default_rng(5)
    B = 4
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    m = tlm.for_compute(tm, tdt)
    if dt == "f32":
        jx, jst, jaux = jax.jit(lambda body, x, pos: j_apply_stack(
            body, jm.plan, x, None, JCtx(phase="prefill", positions=pos,
                                         cache_len=CACHE, cdtype=jdt),
            remat=False))(params["body"], jnp.asarray(x), jnp.asarray(pos))
        tx, tst, taux = t_apply_stack(
            m.body.tree(), m.plan, torch.from_numpy(x), None,
            TCtx(phase="prefill", positions=torch.from_numpy(pos),
                 cache_len=CACHE, cdtype=tdt))
        _close(tx, jx, tol)
        _close(taux, jaux, 1e-7)
        key = "c_kv" if tcfg.mla is not None else "k"
        _close(tst[1][0][key], jst[1][0][key], BF16)

    routes = _Routes(monkeypatch)
    j_prefill, j_decode = _j_lm(jm, jdt, CACHE)
    # JAX at f32 beside JAX at bf16: the bf16 bound (f32 is held to tol)
    f_prefill, f_decode = ((j_prefill, j_decode) if dt == "f32"
                           else _j_lm(jm, jnp.float32, CACHE))
    jlog, jstates = j_prefill(params, jnp.asarray(toks))
    j_calls = routes.take()[0]
    flog, fstates = f_prefill(params, jnp.asarray(toks))
    f_ids = [ids for _, ids in routes.take()[0]]
    tlog, tstates = tlm.prefill(m, {"tokens": torch.from_numpy(toks)},
                                TCtx(cdtype=tdt), CACHE, full_logits=True)
    t_calls = routes.take()[1]
    assert tlog.dtype == tdt and tlog.shape == (B, S, jcfg.vocab_size)
    # first[row]: the first position a port-vs-JAX routing flip reaches;
    # same[row]: the same for JAX's bf16 routing against its f32 routing
    first, same = np.full(B, S), np.full(B, S)
    if dt == "bf16":
        first = _first_flips(j_calls, t_calls, K, S, first)
        assert (first >= S // 2).sum() >= B // 2, first   # not vacuous
        same = _first_flips(j_calls, f_ids, K, S, same)
    upto = lambda f: np.arange(S)[None, :] < f[:, None]
    jl, tl = np.asarray(jlog, np.float32), _np(tlog)
    bound = tol if dt == "f32" else _stack_tol(jl, flog, upto(same))
    assert float(np.abs(tl - jl)[upto(first)].max()) <= bound
    rows, f_rows = first == S, same == S     # rows no prefill flip reached
    cur = np.array([S] * (B - 1) + [9], np.int32)
    for _ in range(3):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jstates = j_decode(params, jnp.asarray(tok), jstates,
                               jnp.asarray(cur))
        j_calls = routes.take()[0]
        fl, fstates = f_decode(params, jnp.asarray(tok), fstates,
                               jnp.asarray(cur))
        f_ids = [ids for _, ids in routes.take()[0]]
        tl, tstates = tlm.decode_step(m, torch.from_numpy(tok), tstates,
                                      torch.from_numpy(cur),
                                      TCtx(cdtype=tdt))
        t_calls = routes.take()[1]
        assert tl.shape == (B, 1, jcfg.vocab_size)
        jl, tl = np.asarray(jl, np.float32), _np(tl)
        if dt == "bf16":
            rows &= _first_flips(j_calls, t_calls, K, 1,
                                 np.where(rows, 1, 0)) == 1
            f_rows &= _first_flips(j_calls, f_ids, K, 1,
                                   np.where(f_rows, 1, 0)) == 1
            bound = _stack_tol(jl, fl, f_rows)
        else:
            bound = 2**-5 * float(np.abs(jl).max())
        assert rows.any()
        assert float(np.abs(tl - jl)[rows].max()) <= bound
        cur = cur + 1
    key = "c_kv" if tcfg.mla is not None else "v"
    _close(tstates[1][0][key][:, rows], np.asarray(
        jstates[1][0][key])[:, rows], BF16)


def test_params_and_states_round_trip_bitwise(model):
    """The JAX deepseek tree goes into the port and back bit for bit; so
    do its bf16 caches (MLA latents or k/v), and zero states have their
    shapes."""
    jcfg, tcfg, jm, params, tm = model
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
    again = convert.lm_states_to_numpy(ts)
    la, lb = jax.tree.leaves(states), jax.tree.leaves(again)
    assert len(la) == len(lb) == 4
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
    zs = tlm.decode_states(tm, 2, 16, lambda sh, dt, _s: torch.zeros(
        sh, dtype=dt))
    for si in range(2):
        for k in ts[si][0]:
            assert ts[si][0][k].dtype == torch.bfloat16
            assert zs[si][0][k].shape == ts[si][0][k].shape


# ---- serving: LMServeMapper -> RequestSlate on the engine ----

def test_serve_app_equals_direct_greedy():
    """The reduced deepseek-v2-lite (MLA, MoE) served on the engine (8
    requests, 4 a tick, microbatches of 2): every slate equals bitwise a
    direct greedy loop over ``lm.prefill`` / ``lm.decode_step`` on the
    same microbatches.  As in the JAX package, a microbatch's pad tokens
    take expert capacity (here drop-free: capacity factor 4.0)."""
    jcfg, tcfg, _, _, tm = _model("deepseek-v2-lite-16b")
    reqs = requests(8, 9, jcfg.vocab_size)
    got, mapper = serve_port(tcfg, tm, reqs, per_tick=4, batch=4, bucket=2)
    direct = direct_greedy(mapper, reqs, 2)
    for r in reqs:
        assert np.array_equal(got[r.rid], direct[r.rid]), r.rid
    assert len({tuple(v) for v in got.values()}) > 1
