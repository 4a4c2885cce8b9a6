"""The paper's two chained-updater applications on the port, held
against the JAX package's examples on the CPU: hot topics (Example 2/5,
Figure 1c: a sequential updater that emits into a stream a second,
associative updater with an ``emit`` of its own reads through a forward
reference) and reputation (Example 3: a sequential updater over key
runs, tails past ``max_run`` deferred).

``examples/torch_hot_topics.py`` and ``examples/torch_reputation.py``
run at the JAX examples' sizes on the same numpy feed (``make_feed``)
as the JAX examples' apps, and every slate, queue and counter is
compared bitwise (``convert.state_to_numpy``), with hot topics' per-tick
``hot`` batches and both apps' stats.  ``make_feed`` at ``groups=1``
makes the JAX examples' own draws: each JAX example's ``main`` runs
against a recorder that takes the place of its ``App``.  At
``groups=2`` each port app is held against ``chip_smoke.py`` phase 21's
numpy checks (gate b), the reference code the card phase runs."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro import EventBatch as JBatch
from repro import RuntimeConfig as JRuntime
from repro_torch import convert

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        f"{path.stem}_apps_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eq_tree(a, b, path="state"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            eq_tree(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), path


class Recorder:
    """Takes the place of a JAX example's ``App``: records the runtime and
    each tick its ``source_fn`` makes, and runs nothing (so the example's
    own checks then fail, which the caller expects)."""

    def __init__(self):
        self.runtime, self.ticks = None, []

    def start(self, runtime=None):
        self.runtime = runtime

    def run(self, source_fn, n_ticks, runtime=None, drain=0):
        self.runtime = runtime or self.runtime
        self.ticks = [source_fn(t, None)["tweets"] for t in range(n_ticks)]
        return []

    def read_slate(self, updater, key):
        return None

    def stats(self):
        return {"processed": {}}

    def close(self):
        pass


def jax_source(ticks, value_of):
    def fn(tick, max_events):
        d = ticks[tick]
        return {"tweets": JBatch.of(
            key=d["key"], value=value_of(d),
            ts=np.full(d["key"].size, tick, np.int32))}
    return fn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the apps' ticks are thousands of small ops,
    and torch's thread pool spinning against the suite's other workers
    on the same cores took the groups=2 hot-topics run from ~10 s alone
    to over 300 s in the 6-worker suite."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def examples():
    return {"hot": (load("examples/hot_topics.py"),
                    load("examples/torch_hot_topics.py")),
            "rep": (load("examples/reputation.py"),
                    load("examples/torch_reputation.py"))}


@pytest.fixture(scope="module")
def chip_smoke():
    return load("chip_smoke.py")


def same_runtime(jrt, rt):
    for f in ("batch_size", "queue_capacity", "chunk_size"):
        assert getattr(jrt, f) == getattr(rt, f), f


def test_hot_topics_feed_is_the_jax_examples(examples, monkeypatch):
    """``make_feed(0, 40)`` draws the JAX example's topic directions and
    ticks, in its order; ``runtime()`` is its ``RuntimeConfig``."""
    jmod, tmod = examples["hot"]
    rec, seen = Recorder(), {}

    def build(dirs):
        seen["dirs"] = dirs
        return rec
    monkeypatch.setattr(jmod, "build_app", build)
    with pytest.raises(AssertionError, match="burst should surface"):
        jmod.main()
    dirs, ticks = tmod.make_feed(0, tmod.TICKS)
    eq_tree(seen["dirs"], dirs, "topic_dirs")
    assert len(rec.ticks) == len(ticks)
    for t, (jb, d) in enumerate(zip(rec.ticks, ticks)):
        eq_tree({"key": jb.key, "feat": jb.value["feat"], "ts": jb.ts},
                {"key": d["key"], "feat": d["feat"],
                 "ts": np.full(d["key"].size, t, np.int32)}, f"tick {t}")
    same_runtime(rec.runtime, tmod.runtime())
    for name in ("N_TOPICS", "FEAT", "TICKS_PER_MINUTE", "HOT_THRESHOLD"):
        assert getattr(jmod, name) == getattr(tmod, name), name


def test_reputation_feed_is_the_jax_examples(examples, monkeypatch):
    jmod, tmod = examples["rep"]
    rec, real = Recorder(), jmod.app
    monkeypatch.setattr(jmod, "app", rec)
    with pytest.raises(AssertionError):
        jmod.main()
    ticks = tmod.make_feed(0, tmod.TICKS)
    assert len(rec.ticks) == len(ticks)
    for t, (jb, d) in enumerate(zip(rec.ticks, ticks)):
        eq_tree({"key": jb.key, "target": jb.value["target"],
                 "actor_score": jb.value["actor_score"], "ts": jb.ts},
                {**{k: d[k] for k in ("key", "target", "actor_score")},
                 "ts": np.full(d["key"].size, t, np.int32)}, f"tick {t}")
    same_runtime(rec.runtime, tmod.runtime())
    assert jmod.N_USERS == tmod.N_USERS
    u1 = {op.name: op for op in real.build().operators}["U1"]
    assert (u1.max_run, u1.table_capacity) == (tmod.MAX_RUN,
                                               tmod.TABLE_CAPACITY)


def test_hot_topics_matches_jax_bitwise(examples):
    """40 ticks of the example in both packages: the engine state
    (slates, queues with U1's deferred tails, counters), every tick's
    ``hot`` batch and the stats bitwise."""
    jmod, tmod = examples["hot"]
    dirs, ticks = tmod.make_feed(0, tmod.TICKS)
    japp = jmod.build_app(dirs)
    jrt = JRuntime(batch_size=2048, queue_capacity=8192, chunk_size=1)
    same_runtime(jrt, tmod.runtime())
    jouts = japp.run(jax_source(ticks, lambda d: {"feat": d["feat"]}),
                     tmod.TICKS, runtime=jrt)
    app = tmod.build_app(dirs, device="cpu")
    outs = app.run(tmod.source(ticks, "cpu"), tmod.TICKS,
                   runtime=tmod.runtime(), device="cpu")
    eq_tree(convert.to_plain(jax.device_get(japp.handle.state)),
            convert.state_to_numpy(app.handle.state))
    assert len(jouts) == len(outs) == tmod.TICKS
    for t, (jo, to) in enumerate(zip(jouts, outs)):
        assert set(jo) == set(to) == {"hot"}
        eq_tree(convert.to_plain(jax.device_get(jo["hot"])),
                convert.to_plain(to["hot"]), f"tick {t} hot")
    assert app.stats() == japp.stats()
    found = tmod.hot_pairs(outs)
    assert [(k, t) for k, t, _ in found] == [(3, 27), (3, 31), (3, 35),
                                             (3, 38)]
    assert not tmod.check_hot(found)
    japp.close()
    app.close()


# XLA:CPU contracts the JAX step's ``0.95 * score + 0.05 * actor`` into
# a fused multiply-add (one rounding where the port, as plain f32 math,
# rounds each product); each step's difference is within an ulp of its
# result and the recurrence scales the earlier ones by 0.95, so they
# stay within sum(0.95**k) = 20 ulps of a score below 2 (2**-23 each).
# The port's scores are bitwise an f32 numpy replay
# (``test_reputation_groups_against_numpy``).
SCORE_TOL = 20 * 2.0**-23


def test_reputation_matches_jax(examples):
    """30 ticks and the drain in both packages: the engine state and
    the stats bitwise but the scores (within ``SCORE_TOL``), and each
    user's slate read through both."""
    jmod, tmod = examples["rep"]
    ticks = tmod.make_feed(0, tmod.TICKS)
    jrt = JRuntime(batch_size=1024, queue_capacity=4096)
    same_runtime(jrt, tmod.runtime())
    jmod.app.run(jax_source(ticks, lambda d: {
        "target": d["target"], "actor_score": d["actor_score"]}),
        tmod.TICKS, runtime=jrt, drain=True)
    app = tmod.build_app()
    app.run(tmod.source(ticks, "cpu"), tmod.TICKS, runtime=tmod.runtime(),
            drain=True, device="cpu")
    jst = convert.to_plain(jax.device_get(jmod.app.handle.state))
    tst = convert.state_to_numpy(app.handle.state)
    js = jst["tables"]["U1"]["vals"].pop("score")
    ts = tst["tables"]["U1"]["vals"].pop("score")
    eq_tree(jst, tst)
    assert js.dtype == ts.dtype and np.abs(js - ts).max() <= SCORE_TOL
    assert app.stats() == jmod.app.stats()
    for u in range(tmod.N_USERS):
        j, t = jmod.app.read_slate("U1", u), app.read_slate("U1", u)
        assert (j is None) == (t is None)
        if j is not None:
            assert int(j["interactions"]) == int(t["interactions"])
            assert abs(float(j["score"]) - float(t["score"])) <= SCORE_TOL
    jmod.app.close()
    app.close()


def test_hot_topics_groups_against_numpy(examples, chip_smoke):
    """Two groups side by side on the CPU, drained, through phase 21a's
    numpy checks: U1 counts the bincount of the (topic, minute) keys,
    U2 periods U1's emissions, each burst topic its group's hottest."""
    _, tmod = examples["hot"]
    dirs, ticks = tmod.make_feed(1, tmod.TICKS, groups=2)
    app = tmod.build_app(dirs, groups=2, device="cpu")
    outs, _, _ = chip_smoke.run_app(app, tmod.source(ticks, CPU),
                                    tmod.TICKS, tmod.runtime(2), CPU)
    found = chip_smoke.check_hot_topics(tmod, app, outs, dirs, ticks, 2,
                                        "groups=2")
    assert {k for k, _, _ in found} >= {3, 19}
    app.close()


def test_reputation_groups_against_numpy(examples, chip_smoke):
    """Two groups on the CPU, drained, through phase 21b's numpy checks:
    interactions exact, scores bitwise an f32 replay in queue order (with
    deferred tails), the celebrities on top."""
    _, tmod = examples["rep"]
    ticks = tmod.make_feed(1, tmod.TICKS, groups=2)
    app = tmod.build_app(table_capacity=tmod.TABLE_CAPACITY * 2)
    chip_smoke.run_app(app, tmod.source(ticks, CPU), tmod.TICKS,
                       tmod.runtime(2), CPU)
    assert int(app.handle.state["deferred"]) > 0
    chip_smoke.check_reputation(tmod, app, ticks, 2, tmod.N_USERS * 2,
                                "groups=2")
    app.close()
