"""Port parity of the declarative App layer (DESIGN.md section 11): the
port's builder, planner, ``ops``, ``RuntimeConfig`` and the stream
launcher held against the JAX package's on the CPU — the passing cases
of ``tests/test_api.py``, each against the JAX app fed the same numpy
batches, engine state compared whole and bitwise through
``repro_torch.convert``.  The JAX side runs its slate updates on
``fused="ref"`` (the packed-table oracle; its Pallas interpret mode is
broken on the installed jax), the port on ``"auto"``, which is the same
oracle on the CPU.  Also the public surface, the queue-3 repairs
(``EventBatch.with_value``, ``Workflow.mappers`` / ``op_index``) and the
multi-shard selection, which starts ``DistributedEngine``, with live
elasticity through ``App.run`` and the launcher's ``--scale-at`` /
``--rebalance-every`` / ``--autoscale``."""
import importlib.util
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro
from repro import App as JApp
from repro import EventBatch as JBatch
from repro import RuntimeConfig as JRuntime
from repro import ops as jops
from repro_torch import (App, AssociativeUpdater, Engine, EngineConfig,
                         EventBatch, Mapper, PlanError, RuntimeConfig,
                         StateHandle, Workflow, convert, ops)
from repro_torch.api import planner

ROOT = pathlib.Path(__file__).resolve().parent.parent
VSPEC = {"retailer": ((), torch.int32)}


def load_example(name):
    path = ROOT / "examples" / name
    spec = importlib.util.spec_from_file_location(
        f"{path.stem}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eq_tree(a, b, path="state"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            eq_tree(a[k], b[k], f"{path}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


def eq_states(jstate, tstate):
    """A JAX engine state and a port one, bitwise (sink rows stripped)."""
    eq_tree(convert.to_plain(jax.device_get(jstate)),
            convert.state_to_numpy(tstate))


def eq_slate(jrow, trow):
    assert (jrow is None) == (trow is None)
    if jrow is not None:
        eq_tree({k: np.asarray(v) for k, v in jrow.items()},
                {k: v.numpy() for k, v in trow.items()})


def both(feed):
    """A numpy source dict -> (JAX source_fn, port source_fn)."""
    def jfn(t, mx):
        return {s: JBatch.of(**d) for s, d in feed(t).items()}

    def tfn(t, mx):
        return {s: EventBatch.of(**d, device="cpu")
                for s, d in feed(t).items()}
    return jfn, tfn


JRT = dict(fused="ref")         # the JAX side's packed-table oracle


# ---- the subclass-API quickstart, in torch ----

class RetailerMapper(Mapper):
    name = "M1"
    subscribes = ("checkins",)
    in_value_spec = VSPEC
    out_streams = {"S2": VSPEC}

    def map_batch(self, batch):
        rid = batch.value["retailer"]
        return {"S2": EventBatch(sid=batch.sid, ts=batch.ts + 1, key=rid,
                                 value={"retailer": rid},
                                 valid=batch.valid & (rid >= 0))}


class SubclassCounter(AssociativeUpdater):
    name = "U1"
    subscribes = ("S2",)
    in_value_spec = VSPEC
    out_streams = {}
    table_capacity = 256

    def slate_spec(self):
        return {"count": ((), torch.int32)}

    def lift(self, batch):
        return {"count": torch.ones_like(batch.key)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"]}

    def merge(self, slate, delta):
        return {"count": slate["count"] + delta["count"]}


def checkin_feeds(n_ticks=10, B=64, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_ticks):
        rid = np.where(rng.random(B) < 0.3, rng.integers(0, 4, B),
                       -1).astype(np.int32)
        out.append(dict(key=rng.integers(0, 1 << 30, B).astype(np.int32),
                        value={"retailer": rid}, ts=np.full(B, t, np.int32)))
    return out


def drive_port(wf, feeds, B=64):
    eng = Engine(wf, EngineConfig(batch_size=B, queue_capacity=4 * B),
                 device="cpu")
    state = eng.init_state()
    for d in feeds:
        state, _ = eng.step(state, {"checkins": EventBatch.of(
            **d, device="cpu")})
    state, _ = eng.drain(state)
    return eng, state


def test_quickstart_builder_matches_subclass_bitwise():
    """The example's builder app compiles to the workflow the subclass
    API hand-writes (names, subscriptions, bitwise engine state after an
    identical feed), and to the JAX quickstart's state."""
    mod = load_example("torch_quickstart.py")
    wf_b = mod.app.build()
    wf_s = Workflow([RetailerMapper(), SubclassCounter()],
                    external_streams=("checkins",))
    assert [op.name for op in wf_b.operators] == \
        [op.name for op in wf_s.operators]
    assert wf_b.subscribers == wf_s.subscribers

    feeds = checkin_feeds()
    _, st_b = drive_port(wf_b, feeds)
    _, st_s = drive_port(wf_s, feeds)
    eq_tree(convert.state_to_numpy(st_b), convert.state_to_numpy(st_s))

    from repro.core.engine import Engine as JEngine
    from repro.core.engine import EngineConfig as JConfig
    jmod = load_example("quickstart.py")
    jeng = JEngine(jmod.app.build(), JConfig(batch_size=64,
                                             queue_capacity=256, **JRT))
    jst = jeng.init_state()
    for d in feeds:
        jst, _ = jeng.step(jst, {"checkins": JBatch.of(**d)})
    jst, _ = jeng.drain(jst)
    eq_states(jst, st_b)


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_semantic_trends.py"])
def test_example_app_section_is_short(name):
    """Acceptance, as for the JAX quickstart: the app in <= 20 lines."""
    text = (ROOT / "examples" / name).read_text().splitlines()
    lo = next(i for i, l in enumerate(text) if "--- app" in l)
    hi = next(i for i, l in enumerate(text) if "--- end app" in l)
    body = [l for l in text[lo + 1:hi]
            if l.strip() and not l.strip().startswith("#")]
    assert len(body) <= 20, f"{len(body)} lines of app code:\n" + \
        "\n".join(body)


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart.py", ["--device", "cpu", "--ticks", "10"]),
    ("torch_semantic_trends.py", ["--device", "cpu"]),
    ("torch_hot_topics.py", ["--device", "cpu"]),
    ("torch_reputation.py", ["--device", "cpu"])])
def test_example_runs_on_cpu(name, argv, capsys):
    """Each example checks itself (HTTP counts against the truth; slates
    against a host replay, bitwise; the burst topic dominates; the
    celebrities rank on top) and exits non-zero on a mismatch."""
    load_example(name).main(argv)
    out = capsys.readouterr().out
    assert ("OK" in out) and ("MISMATCH" not in out)


def _front_door(A, o, dt):
    app = A("front_door")
    checkins = app.source("checkins", {"retailer": ((), dt)})

    @checkins.map(out="S2", name="M1")
    def at_retailer(batch):
        rid = batch.value["retailer"]
        return type(batch)(sid=batch.sid, ts=batch.ts + 1, key=rid,
                           value={"retailer": rid},
                           valid=batch.valid & (rid >= 0))

    at_retailer.update(o.counter("U1", table_capacity=256))
    return app


def test_run_front_door_and_read_slate():
    feeds = checkin_feeds()
    jfn, tfn = both(lambda t: {"checkins": feeds[t]})
    japp = _front_door(JApp, jops, jnp.int32)
    japp.run(jfn, len(feeds), runtime=JRuntime(batch_size=64, **JRT),
             drain=True)
    app = _front_door(App, ops, torch.int32)
    app.run(tfn, len(feeds), runtime=RuntimeConfig(batch_size=64),
            drain=True, device="cpu")
    truth = {}
    for d in feeds:
        rid = d["value"]["retailer"]
        for r in rid[rid >= 0]:
            truth[int(r)] = truth.get(int(r), 0) + 1
    for r, c in truth.items():
        assert int(app.read_slate("U1", r)["count"]) == c
        eq_slate(japp.read_slate("U1", r), app.read_slate("U1", r))
    assert app.stats() == japp.stats()
    assert app.stats()["processed"]["U1"] == sum(truth.values())
    eq_states(japp.handle.state, app.handle.state)
    japp.close()
    app.close()


def _cyclic(A, dt, zeros_like, ones_like):
    app = A("cyclic")
    src = app.source("src", {"x": ((), dt)})

    @app.mapper(src, out="loop", name="M1")
    def inject(b):
        return type(b)(b.sid, b.ts + 1, b.key, {"x": b.value["x"]}, b.valid)

    # M2 subscribes to 'bounce' before U1 (its producer) is declared
    @app.mapper("bounce", out="loop", name="M2")
    def reinject(b):
        return type(b)(b.sid, b.ts + 1, b.key, {"x": b.value["x"]},
                       b.valid & (b.key < 4))

    def cascade(keys, old, new, ts):
        crossed = (old["count"] < 3) & (new["count"] >= 3)
        return {"bounce": type_of(keys)(
            sid=zeros_like(keys), ts=ts + 1, key=keys + 1,
            value={"x": zeros_like(keys)}, valid=crossed)}

    type_of = lambda k: JBatch if isinstance(k, jax.Array) or \
        not isinstance(k, torch.Tensor) else EventBatch

    @app.updater("loop", name="U1", merge="sum", emit=cascade,
                 slate={"count": ((), dt)})
    def lift(b):
        return {"count": ones_like(b.key)}
    return app


def test_cyclic_graph_via_forward_refs():
    """U1 emits into 'bounce'; M2 maps bounce back into U1's input
    stream — a cycle through forward references; the port's state
    equals the JAX app's after the same feed."""
    japp = _cyclic(JApp, jnp.int32, jnp.zeros_like, jnp.ones_like)
    app = _cyclic(App, torch.int32, torch.zeros_like, torch.ones_like)
    wf = app.build()
    assert set(wf.subscribers["loop"]) == {"U1"}
    assert set(wf.subscribers["bounce"]) == {"M2"}
    assert {s: tuple(v) for s, v in wf.subscribers.items()} == \
        {s: tuple(v) for s, v in japp.build().subscribers.items()}

    jfn, tfn = both(lambda t: {"src": dict(
        key=np.zeros(3, np.int32), value={"x": np.zeros(3, np.int32)},
        ts=np.full(3, t, np.int32))})
    japp.run(jfn, 3, runtime=JRuntime(batch_size=16, **JRT), drain=True)
    app.run(tfn, 3, runtime=RuntimeConfig(batch_size=16), drain=True,
            device="cpu")
    assert int(app.read_slate("U1", 0)["count"]) == 9
    assert int(app.read_slate("U1", 1)["count"]) == 1
    eq_states(japp.handle.state, app.handle.state)
    japp.close()
    app.close()


def _chain(A, fuse, dt_f, dt_i, ones_like):
    app = A("chain")
    s1 = app.source("S1", {"x": ((), dt_f)})

    @app.mapper(s1, out="Sa")
    def m1(b):
        return type(b)(b.sid, b.ts + 1, b.key, {"x": b.value["x"] + 1.0},
                       b.valid)

    @app.mapper("Sa", out="Sb")
    def m2(b):
        return type(b)(b.sid, b.ts + 1, b.key, {"x": b.value["x"] * 2.0},
                       b.valid)

    @app.mapper("Sb", out="Sc")
    def m3(b):
        return type(b)(b.sid, b.ts + 1, b.key * 2, {"x": b.value["x"]},
                       b.valid)

    @app.updater("Sc", name="U1", merge="sum",
                 slate={"count": ((), dt_i), "sum": ((), dt_f)})
    def lift(b):
        return {"count": ones_like(b.key), "sum": b.value["x"]}

    return app, app.build(fuse=fuse)


def _tchain(fuse):
    return _chain(App, fuse, torch.float32, torch.int32, torch.ones_like)


def _jchain(fuse):
    return _chain(JApp, fuse, jnp.float32, jnp.int32, jnp.ones_like)


def test_planner_fuses_linear_mapper_chain():
    for fuse in (True, False):
        app, wf = _tchain(fuse)
        japp, jwf = _jchain(fuse)
        assert app.plan.fused_chains == japp.plan.fused_chains
        assert [op.name for op in wf.operators] == \
            [op.name for op in jwf.operators]
        for op, jop in zip(wf.operators, jwf.operators):
            assert op.subscribes == jop.subscribes
            assert set(op.out_streams) == set(jop.out_streams)
    app_f, wf_f = _tchain(True)
    assert len(_tchain(False)[1].operators) == 4
    assert len(wf_f.operators) == 2            # m1+m2+m3 fused, U1
    assert app_f.plan.fused_chains == [("m1", "m2", "m3")]
    fused = wf_f.operators[0]
    assert isinstance(fused, planner.FusedMapper)
    assert fused.subscribes == ("S1",)
    assert set(fused.out_streams) == {"Sc"}
    assert wf_f.operators[1].sum_mergeable   # merge="sum", no emit


@pytest.mark.parametrize("impl", ["jnp", "auto", "off"])
def test_fused_chain_matches_unfused(impl):
    """Fusion changes queue hops and tick alignment, not event->event
    semantics: final slates agree with the unfused build (counts
    exactly, f32 sums to rtol 1e-6, the JAX test's bound) on each slate
    backend, and with the JAX app's."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 128).astype(np.int32)
    xs = rng.normal(size=128).astype(np.float32)
    feeds = [dict(key=keys, value={"x": xs}, ts=np.full(128, t, np.int32))
             for t in range(5)]

    slates = {}
    for fuse in (True, False):
        _, wf = _tchain(fuse)
        eng = Engine(wf, EngineConfig(batch_size=128, queue_capacity=512,
                                      fused=impl), device="cpu")
        state = eng.init_state()
        for d in feeds:
            state, _ = eng.step(state, {"S1": EventBatch.of(**d,
                                                            device="cpu")})
        state, _ = eng.drain(state)
        slates[fuse] = {int(k): eng.read_slate(state, "U1", int(k) * 2)
                        for k in np.unique(keys)}
    from repro.core.engine import Engine as JEngine
    from repro.core.engine import EngineConfig as JConfig
    _, jwf = _jchain(True)
    jeng = JEngine(jwf, JConfig(batch_size=128, queue_capacity=512,
                                fused="jnp" if impl == "jnp" else "off"))
    jst = jeng.init_state()
    for d in feeds:
        jst, _ = jeng.step(jst, {"S1": JBatch.of(**d)})
    jst, _ = jeng.drain(jst)
    for k in slates[True]:
        sf, su = slates[True][k], slates[False][k]
        jw = jeng.read_slate(jst, "U1", k * 2)
        assert sf is not None and su is not None and jw is not None
        assert int(sf["count"]) == int(su["count"]) == int(jw["count"])
        np.testing.assert_allclose(sf["sum"].numpy(), su["sum"].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(sf["sum"].numpy(), np.asarray(jw["sum"]),
                                   rtol=1e-6)


def test_no_fusion_when_stream_has_two_subscribers():
    app = App("fanout")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @app.mapper(s1, out="Sa")
    def m1(b):
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    @app.mapper("Sa", out="Sb")
    def m2(b):
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    app.stream("Sa").update(ops.counter("Ua"))   # second subscriber
    app.stream("Sb").update(ops.counter("Ub"))
    wf = app.build(fuse=True)
    assert len(wf.operators) == 4                # nothing fused
    assert app.plan.fused_chains == []


def test_flop_heavy_stage_is_never_fused():
    """A mapper tagged ``flop_heavy`` keeps its queue hop (the
    reference's rule, ``planner.py:478-521``)."""
    class Heavy(Mapper):
        flop_heavy = True
        name = "H"
        out_streams = {"Sb": {"x": ((), torch.float32)}}

        def map_batch(self, b):
            return {"Sb": EventBatch(b.sid, b.ts + 1, b.key, b.value,
                                     b.valid)}

    app = App("heavy")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @app.mapper(s1, out="Sa")
    def m1(b):
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)

    app.add(Heavy(), subscribes=("Sa",))
    app.stream("Sb").update(ops.counter("U"))
    assert app.plan.fused_chains == []
    assert [op.name for op in app.build().operators] == ["m1", "H", "U"]


def _combinators(A, o, dt):
    app = A("combinators")
    src = app.source("S1", {"x": ((), dt)})

    @app.mapper(src, out="S2")
    def fwd(b):
        return type(b)(b.sid, b.ts + 1, b.key, b.value, b.valid)

    app.stream("S2").update(o.topk(3, "x", "T1"))
    app.stream("S2").update(o.ema(0.5, "x", "E1", max_run=64))
    return app


def test_ops_combinators():
    rng = np.random.default_rng(7)
    xs = rng.normal(size=32).astype(np.float32)
    jfn, tfn = both(lambda t: {"S1": dict(
        key=np.zeros(32, np.int32), value={"x": xs},
        ts=np.arange(32, dtype=np.int32))})
    app = _combinators(App, ops, torch.float32)
    app.run(tfn, 1, runtime=RuntimeConfig(batch_size=64), drain=True,
            device="cpu")
    top = app.read_slate("T1", 0)["top"].numpy()
    np.testing.assert_allclose(top, np.sort(xs)[::-1][:3], rtol=1e-6)
    ema = float(app.read_slate("E1", 0)["ema"])
    ref = xs[0]
    for x in xs[1:]:
        ref = 0.5 * ref + 0.5 * x
    assert abs(ema - ref) < 1e-4

    japp = _combinators(JApp, jops, jnp.float32)
    japp.run(jfn, 1, runtime=JRuntime(batch_size=64, **JRT), drain=True)
    eq_slate(japp.read_slate("T1", 0), app.read_slate("T1", 0))
    got, want = app.read_slate("E1", 0), japp.read_slate("E1", 0)
    assert int(got["n"]) == int(want["n"]) == 32
    assert abs(float(got["ema"]) - float(want["ema"])) <= 1e-6
    app.close()
    japp.close()


def _ema_per_row(app, stream, name, alpha):
    @app.seq_updater(stream, name=name, max_run=4,
                     slate={"ema": ((), torch.float32),
                            "n": ((), torch.int32)})
    def step(slate, ev):
        x = ev["value"]["x"].to(torch.float32)
        first = slate["n"] == 0
        new = torch.where(first, x, (1.0 - alpha) * slate["ema"]
                          + alpha * x)
        return {"ema": new, "n": slate["n"] + 1}, {}


def test_seq_updater_per_row_equals_batched_ema():
    """``app.seq_updater`` keeps the reference's one-row step (vmapped
    over key runs); ``ops.Ema`` is written batched.  Both give the same
    slates bitwise, runs past ``max_run`` deferred included."""
    rng = np.random.default_rng(11)
    feeds = [dict(key=rng.integers(0, 5, 24).astype(np.int32),
                  value={"x": rng.normal(size=24).astype(np.float32)},
                  ts=np.full(24, t, np.int32)) for t in range(6)]
    app = App("two_emas")
    s1 = app.source("S1", {"x": ((), torch.float32)})
    _ema_per_row(app, s1, "per_row", 0.3)
    s1.update(ops.ema(0.3, "x", "batched", max_run=4))
    app.run(lambda t, mx: {"S1": EventBatch.of(**feeds[t], device="cpu")},
            len(feeds), runtime=RuntimeConfig(batch_size=32), drain=True,
            device="cpu")
    st = app.handle.state
    assert app.stats()["deferred"] > 0
    a, b = (convert.to_plain(st["tables"][n]) for n in ("per_row",
                                                        "batched"))
    eq_tree(a, b)


# ---- planner validation errors (actionable, named) ----

def test_planner_unresolvable_cycle_names_streams():
    app = App("stuck")

    @app.mapper("c2", out="c1", name="Ma")
    def ma(b):
        return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

    @app.mapper("c1", out="c2", name="Mb")
    def mb(b):
        return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

    with pytest.raises(PlanError, match="app.stream"):
        app.build()
    app2 = App("unstuck")
    app2.stream("c2", {"x": ((), torch.int32)})

    @app2.mapper("c2", out="c1", name="Ma")
    def ma2(b):
        return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

    @app2.mapper("c1", out="c2", name="Mb")
    def mb2(b):
        return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

    wf = app2.build()
    assert {op.name for op in wf.operators} == {"Ma", "Mb"}


def test_planner_rejects_unconsumed_source_and_ghost_stream():
    app = App("bad")
    app.source("S1", {"x": ((), torch.int32)})
    with pytest.raises(PlanError, match="no subscribers"):
        app.build()

    app2 = App("ghost")
    s1 = app2.source("S1", {"x": ((), torch.int32)})
    app2.stream("nowhere", {"x": ((), torch.int32)})
    s1.update(ops.counter("U1"))
    with pytest.raises(PlanError, match="nowhere"):
        app2.build()


def test_planner_rejects_duplicate_names():
    app = App("dups")
    s1 = app.source("S1", {"x": ((), torch.int32)})
    s1.update(ops.counter("U1"))
    with pytest.raises(PlanError, match="U1"):
        s1.update(ops.counter("U1"))


def test_value_branch_fails_on_meta_with_plan_error():
    """A function that reads a value back (``.item()``, ``bool(t)``)
    cannot run on meta tensors: the planner says so and asks for a
    declared spec, as the reference does for a jax trace failure."""
    for branch in (lambda b: b.value["x"].sum().item() > 0,
                   lambda b: bool(b.valid.any())):
        app = App("branchy")
        s1 = app.source("S1", {"x": ((), torch.float32)})

        @app.mapper(s1, out="S2", name="M")
        def m(b, branch=branch):
            if branch(b):
                return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid)
            return EventBatch(b.sid, b.ts, b.key, b.value, b.valid)

        app.stream("S2").update(ops.counter("U"))
        with pytest.raises(PlanError,
                           match="torch-traceable on meta tensors"):
            app.build()
    # a fully declared output spec needs no tracing
    app = App("declared")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @app.mapper(s1, out={"S2": {"x": ((), torch.float32)}}, name="M")
    def m2(b):
        keep = b.value["x"].sum().item() > 0
        return EventBatch(b.sid, b.ts + 1, b.key, b.value, b.valid & keep)

    app.stream("S2").update(ops.counter("U"))
    assert [op.name for op in app.build().operators] == ["M", "U"]


def test_structure_mismatches_raise():
    app = App("lift")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @s1.updater(name="U", slate={"count": ((), torch.int32)})
    def lift(b):
        return {"n": torch.ones_like(b.key)}

    with pytest.raises(PlanError, match="structurally"):
        app.build()

    app = App("step")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @s1.seq_updater(name="U", slate={"a": ((), torch.float32)})
    def step(slate, ev):
        return {"b": slate["a"]}, {}

    with pytest.raises(PlanError, match="does not match"):
        app.build()

    app = App("noslate")
    s1 = app.source("S1", {"x": ((), torch.float32)})
    s1.updater(name="U", slate=None)(lambda b: {})
    with pytest.raises(PlanError, match="needs slate="):
        app.build()


def test_traced_specs_equal_the_jax_planner():
    """Spec inference on meta tensors gives the JAX planner's specs."""
    def j():
        app = JApp("specs")
        s1 = app.source("S1", {"x": ((3,), jnp.float32),
                               "i": ((), jnp.int32)})

        @app.mapper(s1, name="M")
        def m(b):
            v = {"y": b.value["x"].sum(-1), "z": b.value["x"][:, :2],
                 "k": b.value["i"] > 0}
            return {"S2": JBatch(b.sid, b.ts + 1, b.key, v, b.valid)}

        app.stream("S2").update(jops.counter("U"))
        return app.plan.stream_specs

    def t():
        app = App("specs")
        s1 = app.source("S1", {"x": ((3,), torch.float32),
                               "i": ((), torch.int32)})

        @app.mapper(s1, name="M")
        def m(b):
            v = {"y": b.value["x"].sum(-1), "z": b.value["x"][:, :2],
                 "k": b.value["i"] > 0}
            return {"S2": EventBatch(b.sid, b.ts + 1, b.key, v, b.valid)}

        app.stream("S2").update(ops.counter("U"))
        return app.plan.stream_specs

    from repro_torch.core.event import spec_matches
    js, ts = j(), t()
    assert set(js) == set(ts)
    for s in js:
        assert spec_matches(ts[s], {k: (v[0], np.dtype(v[1]).name)
                                    for k, v in js[s].items()}), s


def test_graph_frozen_after_start():
    app = App("frozen")
    s1 = app.source("S1", {"x": ((), torch.int32)})
    s1.update(ops.counter("U1"))
    app.start(RuntimeConfig(batch_size=8), device="cpu")
    with pytest.raises(RuntimeError, match="already running"):
        app.source("S2", {"x": ((), torch.int32)})
    with pytest.raises(RuntimeError, match="already started"):
        app.start(RuntimeConfig(batch_size=8))
    app.close()


def test_state_handle_live_during_run():
    app = App("handle")
    s1 = app.source("S1", {"x": ((), torch.int32)})
    s1.update(ops.counter("U1"))
    h = app.start(RuntimeConfig(batch_size=16, chunk_size=2), device="cpu")
    seen = []

    def src(t, mx):
        # read through the handle mid-run: state must always be live
        if t > 0:
            seen.append(h.stats()["tick"])
        return {"S1": EventBatch.of(key=np.full(4, 7, np.int32),
                                    value={"x": np.ones(4, np.int32)},
                                    ts=np.full(4, t, np.int32),
                                    device="cpu")}

    app.run(src, 8, drain=True)
    assert seen and seen[-1] > seen[0]          # handle advanced mid-run
    assert int(app.read_slate("U1", 7)["count"]) == 32
    assert app.handle is h and isinstance(h, StateHandle)
    app.close()


# ---- front door: durability, telemetry, distribution ----

def _durable(A, dt_f, dt_i, ones_like):
    app = A("durable")
    s1 = app.source("S1", {"x": ((), dt_f)})

    @app.mapper(s1, out="S2", name="M1")
    def fwd(b):
        return type(b)(b.sid, b.ts + 1, b.key, b.value, b.valid)

    @app.updater("S2", name="U1", merge="sum", slate={"count": ((), dt_i)})
    def lift(b):
        return {"count": ones_like(b.key)}
    return app


def test_front_door_durable_recover(tmp_path):
    """A durable app run, dropped without close (a crash), then
    recovered through ``start(recover=True)``: its slates equal the
    uninterrupted run's and the JAX app's (its slates and stats)."""
    rt = lambda d: dict(batch_size=32, chunk_size=4, durable_dir=str(d),
                        flush_every=8)

    def feed(t):
        r = np.random.default_rng(t)
        return {"S1": dict(key=r.integers(0, 10, 16).astype(np.int32),
                           value={"x": r.normal(size=16).astype(np.float32)},
                           ts=np.full(16, t, np.int32))}
    jfn, tfn = both(feed)
    ones = lambda k: torch.ones_like(k, dtype=torch.int32)
    app = _durable(App, torch.float32, torch.int32, ones)
    app.run(tfn, 16, runtime=RuntimeConfig(**rt(tmp_path / "t")),
            drain=True, device="cpu")
    want = {k: app.read_slate("U1", k) for k in range(10)}
    del app   # crash: no close(), unflushed state dropped

    app2 = _durable(App, torch.float32, torch.int32, ones)
    app2.start(RuntimeConfig(**rt(tmp_path / "t")), recover=True,
               device="cpu")
    app2.run(tfn, 0, drain=True)
    japp = _durable(JApp, jnp.float32, jnp.int32, jnp.ones_like)
    japp.run(jfn, 16, runtime=JRuntime(**rt(tmp_path / "j"), **JRT),
             drain=True)
    for k, w in want.items():
        got = app2.read_slate("U1", k)
        eq_slate(japp.read_slate("U1", k), got)
        if w is None:
            assert got is None
        else:
            assert int(got["count"]) == int(w["count"])
    app2.close()
    japp.close()


def test_front_door_telemetry_and_trace(tmp_path):
    """``RuntimeConfig(telemetry=...)`` reaches the engine:
    ``app.telemetry()`` names the head key, ``export_trace`` writes the
    span trace; without telemetry both raise."""
    import json
    from repro_torch.telemetry import TelemetryConfig
    app = App("tel")
    s1 = app.source("S1", {"x": ((), torch.int32)})
    s1.update(ops.counter("U1"))
    rng = np.random.default_rng(2)

    def src(t, mx):
        k = np.where(rng.random(32) < 0.5, 0, rng.integers(1, 500, 32))
        return {"S1": EventBatch.of(key=k.astype(np.int32),
                                    value={"x": np.ones(32, np.int32)},
                                    ts=t, device="cpu")}

    path = str(tmp_path / "trace.json")
    app.run(src, 8, runtime=RuntimeConfig(
        batch_size=32, chunk_size=4,
        telemetry=TelemetryConfig(window=4, trace=True)), device="cpu",
        trace_path=path)
    rep = app.telemetry()
    assert rep.heavy_hitters[0][0] == 0
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    app.close()
    plain = App("plain")
    plain.source("S1", {"x": ((), torch.int32)}).update(ops.counter("U"))
    plain.start(RuntimeConfig(batch_size=8), device="cpu")
    with pytest.raises(RuntimeError, match="without telemetry"):
        plain.telemetry()
    with pytest.raises(RuntimeError, match="without tracing"):
        plain.export_trace(path)
    plain.close()


def test_runtime_config_compiles_to_engine_config(tmp_path):
    from repro_torch.core.queues import OverflowPolicy
    from repro_torch.slates.flush import FlushPolicy
    rt = RuntimeConfig(batch_size=64, chunk_size=4, key_dtype="int64",
                       overflow={"U": OverflowPolicy.THROTTLE},
                       durable_dir=str(tmp_path), flush_every=4,
                       truncate_wal=True)
    cfg = rt.engine_config()
    assert (cfg.batch_size, cfg.queue_capacity, cfg.chunk_size,
            cfg.key_dtype) == (64, 256, 4, "int64")
    assert cfg.overflow == {"U": OverflowPolicy.THROTTLE}
    assert cfg.durability.dir == str(tmp_path)
    assert cfg.durability.flush.policy is FlushPolicy.EVERY_K
    assert cfg.durability.flush.every_k == 4 and cfg.durability.truncate_wal
    assert cfg.telemetry is None
    with pytest.raises(TypeError, match="TelemetryConfig"):
        RuntimeConfig(telemetry=object()).engine_config()
    with pytest.raises(ValueError, match="distributed runtime"):
        RuntimeConfig(autoscale=object()).engine_config()


@pytest.mark.parametrize("kw", [dict(shards=2), dict(mesh=(2, 2))])
def test_front_door_distributed_selection_names_item_15(kw):
    """``shards > 1`` or a mesh starts the multi-shard engine (item 15a);
    ``App.run`` under an ``AutoscalePolicy`` (live elasticity) scales the
    active set mid-run (2 -> 4 at tick 2, a physical grow, then a
    rebalance) with every count exact, against the JAX front door's
    ``test_runtime_config_autoscale_front_door`` checks; a
    ``LoadAutoscaler`` is accepted and anything else refused."""
    from repro_torch.core.distributed import (AutoscalePolicy, DistConfig,
                                              DistributedEngine, make_mesh)
    from repro_torch.telemetry import LoadAutoscaler
    if "mesh" in kw:
        kw = dict(mesh=make_mesh(kw["mesh"], ("pod", "data")))

    def build():
        app = App("dist")
        app.source("S1", {"x": ((), torch.float32)}).update(
            ops.counter("U1", sum_mergeable=False))
        return app

    rt = RuntimeConfig(batch_size=16, **kw)
    assert rt.distributed
    app = build()
    app.start(rt, device="cpu")
    assert isinstance(app.engine, DistributedEngine)
    assert isinstance(rt.dist_config(), DistConfig)
    n = app.engine.n_shards
    assert n == 2          # the mesh's "data" axis, the default axis

    def src_of(app):
        def src(t, mx):     # [n_shards, B]-leading batches, live count
            n = app.engine.n_shards
            b = EventBatch.of(key=np.full(16, 3, np.int32),
                              value={"x": np.ones(16, np.float32)},
                              ts=np.full(16, t, np.int32), device="cpu")
            return {"S1": EventBatch(*[
                {k: v.reshape(n, -1) for k, v in f.items()}
                if isinstance(f, dict) else f.reshape(n, -1)
                for f in (b.sid, b.ts, b.key, b.value, b.valid)])}
        return src

    app.run(src_of(app), 4, drain=True)
    assert int(app.read_slate("U1", 3)["count"]) == 64
    app.close()
    reports = []
    pol = AutoscalePolicy(scale_at={2: 4}, rebalance_every=3,
                          on_change=reports.append)
    rt2 = RuntimeConfig(batch_size=16, autoscale=pol, **kw)
    assert rt2.dist_config().autoscale is pol
    app2 = build()
    app2.run(src_of(app2), 6, runtime=rt2, drain=True, device="cpu")
    assert app2.engine.n_shards == 4 == len(app2.engine.active_shards)
    assert reports[0].recompiled and reports[0].path == "host"
    assert int(app2.read_slate("U1", 3)["count"]) == 96
    assert app2.stats()["exchange_dropped"] == 0
    app2.close()
    lc = RuntimeConfig(shards=2, autoscale=LoadAutoscaler())
    assert isinstance(lc.dist_config().autoscale, LoadAutoscaler)
    with pytest.raises(TypeError, match="AutoscalePolicy or LoadAutoscaler"):
        RuntimeConfig(shards=2, autoscale=object()).dist_config()
    with pytest.raises(ValueError, match="distributed runtime"):
        RuntimeConfig(shards=1, autoscale=pol).engine_config()


# ---- the package surface ----

def test_public_surface():
    import repro_torch
    from repro_torch.core import distributed
    assert repro_torch.__all__ == repro.__all__
    assert set(repro_torch.__all__) <= set(dir(repro_torch))
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    assert repro_torch.App is App and repro_torch.ops.counter is ops.counter
    for name in ("AutoscalePolicy", "DistributedEngine", "DistConfig",
                 "MigrationReport"):
        assert getattr(repro_torch, name) is getattr(distributed, name)
    from repro_torch.telemetry import controller
    assert repro_torch.LoadAutoscaler is controller.LoadAutoscaler
    assert not hasattr(repro_torch, "NotThere")
    from repro_torch import ml
    assert set(ml.__all__) == set(repro.ml.__all__)


REF_SRC = ROOT / "src" / "repro"
# names of the JAX package the port leaves out on purpose
SURFACE_ALLOWED = {
    # the Pallas kernels' shape gates: a CUDA kernel takes every shape
    # its dispatcher hands it (the dispatchers keep their own rules)
    **{f"kernels/{k}/kernel.py": {"supported"} for k in (
        "countmin", "histogram", "rmsnorm", "slate_update")},
    # the attention kernels mask with -inf inside the CUDA source
    "kernels/decode_attention/kernel.py": {"supported", "NEG_INF"},
    "kernels/flash_attention/kernel.py": {"supported", "NEG_INF"},
    "kernels/ssd/ref.py": {"NEG_INF"},
    # the TPU kernel's query tile bound; the int64 planes kernel is the
    # templated kernel's int64 instance (``slate_lookup`` takes both)
    "kernels/slate_lookup/kernel.py": {"supported", "MAX_Q",
                                       "slate_lookup_wide"},
    # numpy's uint32 dtype alias for JAX's 32-bit hashing
    "core/hashing.py": {"U32"},
    # a TPU interconnect rate; the port's dry run prices NVLink
    "launch/dryrun.py": {"ICI_BW"},
    # a type alias of JAX arrays; the port annotates torch.Tensor
    "models/context.py": {"Array"},
}
# reference modules with no module of that name in the port
MODULE_ALLOWED = {
    # XLA HLO text analysis; the port's counterpart is analysis/cost.py
    "analysis/hlo.py",
}
REF_MODULES = sorted(str(p.relative_to(REF_SRC))
                     for p in REF_SRC.rglob("*.py"))


def public_names(path):
    """A module's public top-level definitions (functions, classes,
    assignments) and, for a package, the names in its ``__all__``."""
    import ast
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(n.value))
                    names.add(t.id)
    return {x for x in names if not x.startswith("_")}


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_has_every_public_name_of_the_reference(rel):
    """Each module of the JAX package has a port module that, once
    imported, has every public top-level name of the reference and
    every name of its ``__all__`` (an ``__init__.py``: the package
    exports it), but for ``SURFACE_ALLOWED``."""
    import importlib
    if rel in MODULE_ALLOWED:
        assert not (ROOT / "src" / "repro_torch" / rel).exists()
        return
    parts = ["repro_torch", *rel[:-3].split("/")]
    port = importlib.import_module(".".join(
        parts[:-1] if parts[-1] == "__init__" else parts))
    want = public_names(REF_SRC / rel) - SURFACE_ALLOWED.get(rel, set())
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_surface_allow_list_is_current():
    """Every allowed omission is still an omission of a reference name."""
    import importlib
    for rel, names in SURFACE_ALLOWED.items():
        assert names <= public_names(REF_SRC / rel), rel
        port = importlib.import_module(
            "repro_torch." + rel[:-3].replace("/", "."))
        assert not [n for n in names if hasattr(port, n)], rel
    assert all((REF_SRC / rel).exists() for rel in MODULE_ALLOWED)


def test_slate_lookup_package_exports():
    from repro_torch.kernels.slate_lookup import lookup_slots, slate_lookup
    from repro_torch.kernels.slate_lookup import ops as lk_ops
    assert slate_lookup is lk_ops.slate_lookup
    assert lookup_slots is lk_ops.lookup_slots


def test_import_stays_light():
    """``import repro_torch`` imports nothing of the port (torch
    included); the App layer imports no model module; ``repro_torch.ml``
    loads the model stack only when a name of it is touched."""
    code = (
        "import sys\n"
        "import repro_torch\n"
        "assert not [m for m in sys.modules if m.startswith('repro_torch.')"
        " or m == 'torch'], sorted(sys.modules)\n"
        "from repro_torch import App, RuntimeConfig, ops, ml\n"
        "assert not [m for m in sys.modules if"
        " m.startswith('repro_torch.models')]\n"
        "ml.SemanticTopK\n"
        "assert not [m for m in sys.modules if"
        " m.startswith('repro_torch.models')]\n"
        "ml.ModelMapper\n"
        "assert 'repro_torch.models.lm' in sys.modules\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ---- the repairs of ROADMAP queue 3 ----

def test_event_batch_with_value_matches_jax():
    rng = np.random.default_rng(4)
    d = dict(key=rng.integers(0, 9, 6).astype(np.int32),
             value={"x": rng.normal(size=6).astype(np.float32)},
             ts=np.arange(6, dtype=np.int32),
             valid=rng.random(6) < 0.5)
    new = {"y": np.arange(12, dtype=np.int32).reshape(6, 2)}
    jb = JBatch.of(**d).with_value(jax.tree.map(jnp.asarray, new))
    tb = EventBatch.of(**d, device="cpu").with_value(
        {k: torch.from_numpy(v) for k, v in new.items()})
    eq_tree(convert.to_plain(jax.device_get(jb)), convert.to_plain(tb))


def test_workflow_mappers_and_op_index_match_jax():
    japp, jwf = _jchain(False)
    _, twf = _tchain(False)
    assert [op.name for op in twf.mappers()] == \
        [op.name for op in jwf.mappers()] == ["m1", "m2", "m3"]
    for op in jwf.operators:
        assert twf.op_index(op.name) == jwf.op_index(op.name)
    with pytest.raises(ValueError):
        twf.op_index("nope")


# ---- the stream launcher ----

def _launch(capsys, *argv):
    from repro_torch.launch import stream
    stream.main(["--device", "cpu", "--batch", "32", *argv])
    return capsys.readouterr().out


def _printed(out):
    """The launcher's closing print: the stats JSON and three slates."""
    import json
    lines = out.splitlines()
    i = lines.index("{")
    j = max(k for k, l in enumerate(lines) if l == "}")
    return json.loads("\n".join(lines[i:j + 1])), lines[j + 1:]


def test_launcher_crash_and_recover_prints_the_uninterrupted_run(
        tmp_path, capsys):
    """``--crash-at 40`` then ``--recover`` prints the slates and stats
    of an uninterrupted run; ``processed`` restarts at the flush
    frontier (tick 32), as in the JAX package."""
    full = _printed(_launch(capsys, "--dir", str(tmp_path / "a")))
    out = _launch(capsys, "--dir", str(tmp_path / "b"), "--crash-at", "40")
    assert "CRASH at source tick 40" in out
    out = _launch(capsys, "--dir", str(tmp_path / "b"), "--recover")
    assert "resuming at source tick 40" in out
    rec = _printed(out)
    assert rec[1] == full[1]                       # the slates
    assert {k: v for k, v in rec[0].items() if k != "processed"} == \
        {k: v for k, v in full[0].items() if k != "processed"}
    assert rec[0]["processed"] == {"M1": 32 * 32, "U1": 32 * 32}
    assert full[0]["processed"] == {"M1": 64 * 32, "U1": 64 * 32}


def _store_rows(d):
    """Every flushed ``U1`` slate of a launcher's store, by key (the JAX
    store's files are the port's, byte for byte)."""
    from repro_torch.core.durability import DurabilityConfig
    keys, _, s = DurabilityConfig(dir=str(d)).make_store().scan_rows("U1")
    return {int(k): (int(c), float(x))
            for k, c, x in zip(keys, s["count"], s["sum"])}


def test_launcher_default_batch_recovery_matches_the_reference(
        tmp_path, capsys):
    """At the launcher's default ``--batch 256`` its 2**14-slot table
    holds ~8,100 keys and drops at the probe limit.  Recovery re-inserts
    the flushed keys in key order, so after ``--crash-at 40`` and
    ``--recover`` another key can meet the limit: the recovered state
    loses an event the uninterrupted run kept (ROADMAP queue 3, a fault
    of the reference).  The port recovers to the JAX package's state
    exactly, in both runs; within each package the slates differ from
    the uninterrupted run's only at keys the feed gave more events than
    either run counted."""
    from repro.launch import stream as jstream
    from repro_torch.launch import stream
    stats, rows = {}, {}
    for pkg, main, pre in (("jax", jstream.main, []),
                           ("torch", stream.main, ["--device", "cpu"])):
        for run, more in (("full", []), ("crash", ["--crash-at", "40"]),
                          ("crash", ["--recover"])):
            main([*pre, "--dir", str(tmp_path / pkg / run), *more])
            out = capsys.readouterr().out
            if "--crash-at" not in more:     # closed: all slates flushed
                stats[pkg, run] = _printed(out)[0]
                rows[pkg, run] = _store_rows(tmp_path / pkg / run)
    for run in ("full", "crash"):
        assert stats["torch", run] == stats["jax", run], run
        assert rows["torch", run] == rows["jax", run], run
    full, rec = rows["torch", "full"], rows["torch", "crash"]
    fed = np.zeros(10_000, np.int64)
    for t in range(64):
        keys = stream.source_fn(t, None, 256, "cpu")["S1"].key
        np.add.at(fed, keys.numpy(), 1)
    short = {k for k in np.flatnonzero(fed).tolist()
             if full.get(k, (0,))[0] != fed[k]
             or rec.get(k, (0,))[0] != fed[k]}
    differ = {k for k in set(full) | set(rec) if full.get(k) != rec.get(k)}
    assert differ <= short
    assert len(short) <= (stats["torch", "full"]["table_dropped"]["U1"]
                          + stats["torch", "crash"]["table_dropped"]["U1"])
    assert stats["torch", "crash"]["tick"] == stats["torch", "full"]["tick"]


@pytest.mark.parametrize("flag", [["--shards", "2", "--scale-at", "4:4"],
                                  ["--scale-at", "4:2"],
                                  ["--rebalance-every", "2"],
                                  ["--autoscale", "load:0.7,0.2"]])
def test_launcher_multi_shard_flags_name_item_15(tmp_path, capsys, flag):
    """The live-elasticity flags run: ``--scale-at`` and
    ``--rebalance-every`` print a line a reconfigure and the stats
    (``tests/test_torch_elastic_durable.py`` holds a run against the JAX
    launcher); ``--autoscale`` runs its closed loop and prints the
    telemetry line.  The reference's usage errors stay: a malformed
    ``--scale-at`` or ``--autoscale``, ``--autoscale`` on one shard, and
    ``--autoscale`` with a schedule exit 2 with its messages."""
    from repro_torch.launch import stream
    shards = [] if "--shards" in flag else ["--shards", "4"]
    stream.main(["--device", "cpu", "--dir", str(tmp_path / "run"),
                 "--ticks", "12", "--batch", "64", *shards, *flag])
    out = capsys.readouterr().out
    assert '"exchange_dropped": 0' in out
    if "--autoscale" in flag:
        assert "telemetry: active=" in out
    else:
        assert out.count("reconfigured:") >= 1
    bad = {"--scale-at": (["--scale-at", "4-2"], "wants TICK:N"),
           "--rebalance-every": (["--autoscale", "load:0.7,0.2",
                                  "--rebalance-every", "2", "--shards",
                                  "2"], "mutually exclusive"),
           "--autoscale": (["--autoscale", "cpu:0.7"],
                           "wants load:HI,LO")}
    bad["--shards"] = (["--autoscale", "load:0.7,0.2"], "needs --shards")
    argv, msg = bad[flag[0]]
    with pytest.raises(SystemExit) as e:
        stream.main(["--device", "cpu", "--dir", str(tmp_path / "bad"),
                     *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


# ---- build-time spec validation (tests/test_workflow_specs.py) ----

def test_spec_matches_normalizes_dtypes():
    from repro_torch.core.event import spec_matches
    assert spec_matches({"x": ((), torch.int32)}, {"x": ((), np.int32)})
    assert spec_matches({"x": ((), torch.int32)}, {"x": ((), jnp.int32)})
    assert not spec_matches({"x": ((), torch.int32)},
                            {"x": ((), torch.float32)})
    assert not spec_matches({"x": ((2,), torch.int32)},
                            {"x": ((3,), torch.int32)})
    assert not spec_matches({"x": ((), torch.int32)},
                            {"y": ((), torch.int32)})


def _spec_ops():
    from tests.test_torch_engine import TCountingUpdater, TPassThroughMapper
    return TPassThroughMapper, TCountingUpdater


@pytest.mark.parametrize("out,match", [
    (None, None),
    ({"S2": {"x": ((), torch.float32)}}, "M1"),
    ({"S2": {"x": ((4,), torch.int32)}}, "S2"),
    ({"S2": {"y": ((), torch.int32)}}, "S2")])
def test_workflow_checks_producer_against_subscriber(out, match):
    """A producer's out spec must match each subscriber's input spec:
    a dtype, shape or structure mismatch raises naming the stream and
    both operators; matching specs build."""
    mapper, counter = _spec_ops()
    m = mapper()
    if out is not None:
        m.out_streams = out
    if match is None:
        Workflow([m, counter()], external_streams=("S1",))
        return
    with pytest.raises(ValueError) as ei:
        Workflow([m, counter()], external_streams=("S1",))
    msg = str(ei.value)
    assert "S2" in msg and "M1" in msg and "U1" in msg


def test_workflow_checks_every_producer():
    mapper, counter = _spec_ops()
    good, bad = mapper(), mapper()
    good.name, bad.name = "M2", "M3"
    bad.out_streams = {"S2": {"x": ((), torch.float32)}}
    with pytest.raises(ValueError, match="M3"):
        Workflow([mapper(), good, bad, counter()], external_streams=("S1",))
