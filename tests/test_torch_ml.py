"""Port parity of the streaming-ML stages (DESIGN.md section 16) on the
CPU: the passing cases of ``tests/test_ml.py`` against the JAX package,
the JAX model's parameters (and classify head) carried over through
``repro_torch.convert``.

- **ModelMapper**: bucket padding exact (bitwise against one unbucketed
  forward), empty ticks flow through, ``keep`` and the classify head;
  embeddings and scores within 1e-4 of the JAX mapper's (the f32 rule of
  ``tests/test_torch_models.py``); the output spec ``bind`` writes down
  equals the one the JAX planner traces.
- **SemanticTopK**: fused vs generic bitwise within the port; the packed
  word bitwise against the JAX package's from equal scores, and slates
  bitwise across packages with a given score field; with the default
  score ``sigmoid(mean(emb))`` the f32 mean's reduction order differs
  between XLA and torch, so across packages a cell may sit one
  quantisation level (2**-14) apart.
- **Personalization**: the engine's batched step equals a one-event
  replay bitwise, and the reference's one-row step written with
  ``app.seq_updater``; against the JAX engine within 1e-5 (the dot
  products' reduction order).
- **build_serve_app**: a crashed durable serving app recovers to the
  uninterrupted run's slates bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import App as JApp
from repro import EventBatch as JBatch
from repro import RuntimeConfig as JRuntime
from repro.api import ops as jops
from repro.configs import get_config as j_get_config
from repro_torch import App, EventBatch, RuntimeConfig, convert, ops
from repro_torch.configs import get_config
from repro_torch.core.event import spec_matches
from repro_torch.ml import rankers

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab_size=512, head_dim=32)
JCFG = j_get_config("qwen2-0.5b").replace(**TINY)
TCFG = get_config("qwen2-0.5b").replace(**TINY)
F32_TOL = 1e-4        # tests/test_torch_models.py's f32 bound
DOT_TOL = 1e-5        # f32 dot products of width 3-64, reordered


@pytest.fixture(scope="module")
def jmm():
    return jops.model_mapper(JCFG, field="tokens", out="o", bucket=8)


def port_mapper(jmm, **kw):
    model = convert.lm_params_from_numpy(jax.device_get(jmm._params), TCFG,
                                         device="cpu")
    return ops.model_mapper(TCFG, model, field="tokens", out="o",
                            device="cpu", **kw)


def _close(a, b, tol):
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) if \
        np.asarray(a).size else 0.0
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# ModelMapper
# ---------------------------------------------------------------------------

def test_model_mapper_bucket_padding_exact(jmm):
    """Padding to the microbatch bucket and slicing back does not move a
    real row's bits: every output equals one unbucketed forward over the
    true batch, bitwise; and the JAX mapper's within F32_TOL."""
    mm = port_mapper(jmm, bucket=8)
    rng = np.random.default_rng(0)
    whole = jax.jit(jmm._infer)
    for B in (1, 5, 8, 13):
        toks = rng.integers(1, TCFG.vocab_size, (B, 8)).astype(np.int32)
        toks[0, 5:] = 0                     # a padded token window
        batch = EventBatch.of(key=np.arange(1, B + 1, dtype=np.int32),
                              value={"tokens": toks}, device="cpu")
        out = mm.map_batch(batch)["o"]
        want = mm.infer(torch.from_numpy(toks))
        assert torch.equal(out.value["emb"], want)
        assert torch.equal(out.key, batch.key)
        assert torch.equal(out.ts, batch.ts + 1)
        _close(out.value["emb"].numpy(), whole(jnp.asarray(toks)), F32_TOL)
    assert mm.microbatches == 1 + 1 + 1 + 2 + 4    # map_batch + oracle


def test_model_mapper_empty_tick_passthrough(jmm):
    mm = port_mapper(jmm, bucket=4)
    B = 6
    batch = EventBatch.of(key=np.zeros(B, np.int32),
                          value={"tokens": np.zeros((B, 8), np.int32)},
                          valid=np.zeros(B, bool), device="cpu")
    out = mm.map_batch(batch)["o"]
    assert not bool(out.valid.any())
    assert torch.isfinite(out.value["emb"]).all()
    empty = EventBatch.of(key=np.zeros(0, np.int32),
                          value={"tokens": np.zeros((0, 8), np.int32)},
                          device="cpu")
    assert mm.map_batch(empty)["o"].value["emb"].shape == (0, TCFG.d_model)


def test_model_mapper_keep_and_classify():
    jm = jops.model_mapper(JCFG, field="tokens", out="o", mode="classify",
                           n_classes=3, bucket=4, keep=("item",))
    mm = port_mapper(jm, mode="classify", n_classes=3, bucket=4,
                     keep=("item",),
                     head=convert.mapper_head_from_numpy(
                         np.asarray(jm._head), device="cpu"))
    rng = np.random.default_rng(1)
    B = 5
    d = dict(key=np.arange(B, dtype=np.int32),
             value={"tokens": rng.integers(1, TCFG.vocab_size,
                                           (B, 8)).astype(np.int32),
                    "item": np.arange(10, 10 + B, dtype=np.int32)})
    out = mm.map_batch(EventBatch.of(**d, device="cpu"))["o"]
    jout = jm.map_batch(JBatch.of(**d))["o"]
    assert set(out.value) == {"cls", "score", "item"}
    cls = out.value["cls"].numpy()
    assert cls.dtype == np.int32 and cls.shape == (B,)
    assert ((0 <= cls) & (cls < 3)).all()
    np.testing.assert_array_equal(cls, np.asarray(jout.value["cls"]))
    _close(out.value["score"].numpy(), jout.value["score"], F32_TOL)
    np.testing.assert_array_equal(out.value["item"].numpy(),
                                  d["value"]["item"])
    with pytest.raises(ValueError, match="head must be"):
        port_mapper(jm, mode="classify", n_classes=3,
                    head=torch.zeros(3, 3))


@pytest.mark.parametrize("mode", ["embed", "classify"])
def test_bind_spec_equals_jax_trace(jmm, mode):
    """The written-down output spec equals the JAX planner's traced
    spec: on ``bind`` and through an App (the planner calls ``bind``)."""
    kw = dict(mode=mode, n_classes=3 if mode == "classify" else 0,
              keep=("item",))
    jspec = {"tokens": ((8,), jnp.int32), "item": ((), jnp.int32)}
    tspec = {"tokens": ((8,), torch.int32), "item": ((), torch.int32)}
    jm = jops.model_mapper(JCFG, jmm._params, field="tokens", out="o", **kw)
    want = jm.bind(jspec).out_streams["o"]
    got = port_mapper(jmm, **kw).bind(tspec).out_streams["o"]
    norm = lambda s: {k: (tuple(v[0]), np.dtype(v[1]).name)
                      for k, v in s.items()}
    assert set(got) == set(want) and spec_matches(got, norm(want))

    japp, app = JApp("b"), App("b")
    japp.source("ev", jspec)
    app.source("ev", tspec)
    japp.add(jm, subscribes=("ev",))
    app.add(port_mapper(jmm, **kw), subscribes=("ev",))
    japp.stream("o").update(jops.counter("U"))
    app.stream("o").update(ops.counter("U"))
    assert spec_matches(app.plan.stream_specs["o"],
                        norm(japp.plan.stream_specs["o"]))
    assert app.plan.fused_chains == japp.plan.fused_chains == []


# ---------------------------------------------------------------------------
# SemanticTopK
# ---------------------------------------------------------------------------

def _topk_feed(with_score):
    rng = np.random.default_rng(7)
    feeds = []
    for t in range(6):
        B = 16
        v = {"emb": rng.normal(size=(B, 4)).astype(np.float32),
             "item": rng.integers(1, 1000, B).astype(np.int32)}
        if with_score:
            v["s"] = rng.random(B).astype(np.float32)
        feeds.append(dict(key=rng.integers(0, 5, B).astype(np.int32),
                          value=v, ts=np.full(B, t, np.int32)))
    return feeds


def _run_topk(A, o, fused, feeds, spec, mk):
    app = A(f"topk_{fused}")
    app.source("ev", spec)
    score = {"score_field": "s"} if "s" in spec else {}
    app.stream("ev").update(o.semantic_topk(k=4, n_slots=16,
                                            table_capacity=64, **score))
    kw = {} if A is JApp else {"device": "cpu"}
    rt = (JRuntime if A is JApp else RuntimeConfig)(batch_size=16,
                                                    fused=fused)
    app.run(lambda t, mx: {"ev": mk(**feeds[t])}, n_ticks=len(feeds),
            runtime=rt, drain=True, **kw)
    cells = {}
    for key in range(5):
        slate = app.read_slate("semantic_topk", key)
        cells[key] = None if slate is None else np.array(slate["cells"])
    app.close()
    return cells


def _tspec(with_score):
    s = {"emb": ((4,), torch.float32), "item": ((), torch.int32)}
    return {**s, "s": ((), torch.float32)} if with_score else s


def _jspec(with_score):
    s = {"emb": ((4,), jnp.float32), "item": ((), jnp.int32)}
    return {**s, "s": ((), jnp.float32)} if with_score else s


def _tmk(**d):
    return EventBatch.of(**d, device="cpu")


@pytest.mark.parametrize("with_score", [False, True])
def test_semantic_topk_fused_unfused_bitwise_parity(with_score):
    from repro_torch.core.apply import fused_eligible, merge_monoid
    up = ops.semantic_topk()
    assert merge_monoid(up) == "max" and fused_eligible(up)
    feeds = _topk_feed(with_score)
    base = _run_topk(App, ops, "off", feeds, _tspec(with_score), _tmk)
    assert any(v is not None and (v > 0).any() for v in base.values())
    for impl in ("auto", "jnp", "ref"):
        got = _run_topk(App, ops, impl, feeds, _tspec(with_score), _tmk)
        for key, want in base.items():
            if want is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want,
                                              err_msg=f"key {key} {impl}")
    jgot = _run_topk(JApp, jops, "jnp", feeds, _jspec(with_score),
                     JBatch.of)
    level = 1 << rankers.ITEM_BITS         # one quantisation level
    for key, want in base.items():
        if want is None:
            assert jgot[key] is None
            continue
        if with_score:       # equal scores: the words equal bitwise
            np.testing.assert_array_equal(want, jgot[key])
            continue
        q, item = np.divmod(want.astype(np.int64), level)
        jq, jitem = np.divmod(jgot[key].astype(np.int64), level)
        assert (np.abs(q - jq) <= 1).all(), (key, want, jgot[key])
        assert (item[q == jq] == jitem[q == jq]).all(), key


def test_pack_word_bitwise_against_jax():
    from repro.ml import rankers as jr
    rng = np.random.default_rng(3)
    edges = np.array([0.0, 2.0**-14, 2.0**-14 - 2**-30, 0.5, 1 - 2**-24,
                      1.0, 1.5, -0.25, np.nextafter(np.float32(0.75), 1)],
                     np.float32)
    score = np.concatenate([edges, rng.random(500).astype(np.float32)])
    item = rng.integers(-5000, 5000, score.size).astype(np.int32)
    got = rankers.pack_word(torch.from_numpy(score), torch.from_numpy(item))
    want = np.asarray(jr.pack_word(jnp.asarray(score), jnp.asarray(item)))
    np.testing.assert_array_equal(got.numpy(), want)
    for w in want[:50]:
        assert rankers.unpack_word(w) == jr.unpack_word(w)
    up, jup = ops.semantic_topk(k=3), jops.semantic_topk(k=3)
    cells = np.sort(want[:40])
    assert up.top({"cells": cells}) == jup.top({"cells": cells})


# ---------------------------------------------------------------------------
# Personalization
# ---------------------------------------------------------------------------

D, K = 3, 2
P_EMBS = np.random.default_rng(5).normal(size=(5, D)).astype(np.float32)
P_ITEMS = np.array([3, 7, 3, 9, 11], np.int32)


def _pers_source(mk):
    def src(tick, max_events):
        return {"ev": mk(key=np.ones(5, np.int32),
                         value={"emb": P_EMBS, "item": P_ITEMS},
                         ts=np.arange(5, dtype=np.int32))}
    return src


def _per_row_personalization(app, alpha):
    """The JAX package's one-row step, written in torch for vmap."""
    @app.stream("ev").seq_updater(
        name="per_row", table_capacity=32,
        slate={"user": ((D,), torch.float32), "items": ((K,), torch.int32),
               "cand": ((K, D), torch.float32),
               "scores": ((K,), torch.float32), "n": ((), torch.int32)})
    def step(slate, ev):
        emb = ev["value"]["emb"].to(torch.float32)
        item = ev["value"]["item"].to(torch.int32)
        first = slate["n"] == 0
        user = torch.where(first, emb, (1.0 - alpha) * slate["user"]
                           + alpha * emb)
        cand = torch.cat([slate["cand"], emb[None]], 0)
        items = torch.cat([slate["items"], item[None]])
        live = (items > 0) & ~((items == item)
                               & (torch.arange(K + 1) < K))
        scores = torch.where(live, cand @ user, -torch.inf)
        order = torch.argsort(-scores, stable=True)[:K]
        sel = torch.isfinite(scores[order])
        return {"user": user,
                "items": torch.where(sel, items[order], 0),
                "cand": torch.where(sel[:, None], cand[order], 0.0),
                "scores": torch.where(sel, scores[order], 0.0),
                "n": slate["n"] + 1}, {}


def test_personalization_matches_step_replay():
    up = ops.personalization(d=D, k=K, alpha=0.5, table_capacity=32)
    app = App("pers")
    app.source("ev", {"emb": ((D,), torch.float32),
                      "item": ((), torch.int32)})
    app.stream("ev").update(up)
    _per_row_personalization(app, 0.5)
    app.run(_pers_source(_tmk), n_ticks=1,
            runtime=RuntimeConfig(batch_size=8), drain=True, device="cpu")
    got = app.read_slate("personalization", 1)
    assert got is not None

    # oracle: the step one event at a time, in ts order (one row)
    slate = up.init_slate(1)
    for i in range(5):
        slate, _ = up.step(slate, {
            "value": {"emb": torch.from_numpy(P_EMBS[i:i + 1]),
                      "item": torch.from_numpy(P_ITEMS[i:i + 1])},
            "ts": torch.tensor([i], dtype=torch.int32)})
    for leaf in slate:
        assert torch.equal(got[leaf], slate[leaf][0]), leaf
    ranked = up.ranked(got)
    assert 0 < len(ranked) <= K and all(i > 0 for i, _ in ranked)
    row = app.read_slate("per_row", 1)
    for leaf in slate:
        assert torch.equal(row[leaf], got[leaf]), leaf

    japp = JApp("pers")
    japp.source("ev", {"emb": ((D,), jnp.float32),
                       "item": ((), jnp.int32)})
    japp.stream("ev").update(jops.personalization(d=D, k=K, alpha=0.5,
                                                  table_capacity=32))
    japp.run(_pers_source(JBatch.of), n_ticks=1,
             runtime=JRuntime(batch_size=8), drain=True)
    want = japp.read_slate("personalization", 1)
    for leaf in ("items", "n"):
        np.testing.assert_array_equal(got[leaf].numpy(),
                                      np.asarray(want[leaf]))
    for leaf in ("user", "cand", "scores"):
        _close(got[leaf].numpy(), want[leaf], DOT_TOL)
    app.close()
    japp.close()


# ---------------------------------------------------------------------------
# durable recovery of a model-backed app — bitwise slates
# ---------------------------------------------------------------------------

def _mk_reqs(n, rng):
    from types import SimpleNamespace
    return [SimpleNamespace(rid=i + 1, prompt=rng.integers(
        1, TCFG.vocab_size, int(rng.integers(3, 8))).astype(np.int32))
        for i in range(n)]


def test_serve_app_crash_recovery_bitwise(tmp_path):
    from repro_torch.ml import build_serve_app, request_source
    from repro_torch.models import lm
    model, _ = lm.init(lm.build(TCFG), torch.Generator().manual_seed(0))
    n_req = 6

    def runtime(d):
        # a flush boundary lands mid-run: recovery restores the earlier
        # requests' token slates from the store (wide-leaf round-trip)
        # and replays the rest of the WAL through the model mapper
        return RuntimeConfig(batch_size=4, chunk_size=2,
                             durable_dir=str(d), flush_every=2)

    def make():
        return build_serve_app(TCFG, model, prompt_len=8, max_new=4,
                               cache_len=32, bucket=2)

    def source():
        return request_source(_mk_reqs(n_req, np.random.default_rng(9)),
                              prompt_len=8, capacity=4, per_tick=2,
                              device="cpu")

    app_a = make()
    app_a.run(source(), n_ticks=3, runtime=runtime(tmp_path / "a"),
              drain=True, device="cpu")
    base = {}
    for rid in range(1, n_req + 1):
        slate = app_a.read_slate("requests", rid)
        assert slate is not None, f"request {rid} missing"
        assert int(slate["n"]) == 4
        base[rid] = slate["tokens"].clone()
    app_a.close()

    app_b = make()
    app_b.run(source(), n_ticks=3, runtime=runtime(tmp_path / "b"),
              device="cpu")
    assert app_b.engine.dur.frontier.tick > 0   # a flush boundary hit
    app_b.close()                            # the crash

    app_c = make()
    app_c.run(lambda t, m: {}, n_ticks=0, runtime=runtime(tmp_path / "b"),
              recover=True, drain=True, device="cpu")
    for rid, want in base.items():
        slate = app_c.read_slate("requests", rid)
        assert slate is not None, f"request {rid} lost in recovery"
        assert torch.equal(slate["tokens"], want)
    app_c.close()
