"""Port parity: the closed-loop controller (``repro_torch.telemetry.
controller``) against the JAX package's, and the closed loop through
``DistributedEngine.run`` against the JAX engine's, on the CPU.

``LoadAutoscaler.decide`` and ``heat_weights`` are pure numpy in both
packages: they are held in-process over the same report sequences
(``tests/test_telemetry.py``'s hysteresis, skew, p99, rebalance-ratio
and adaptive-cooldown cases), action by action and streak by streak.
The square wave 2 -> 4 -> 2 of ``test_closed_loop_square_wave_2to4_
fast`` runs once in a JAX subprocess (``tests/_dist_ref.py
closed_loop``); the port's trace of active shards, reports, control log
(``pause_s`` aside), state and reads equal it bitwise."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import controller as jc
from repro.telemetry.metrics import TelemetryReport as JReport
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          make_mesh)
from repro_torch.core.workflow import Workflow
from repro_torch.telemetry import LoadAutoscaler, TelemetryConfig
from repro_torch.telemetry import controller as tc
from repro_torch.telemetry.metrics import TelemetryReport as TReport
from tests import _dist_ref as ref
from tests.test_torch_elasticity import (TECounter, elastic_ops, eq_reads,
                                         host, reads, tbatch)
from tests.test_torch_engine import _eq_tree


def report(cls, pressure, hh=(), **more):
    """``tests/test_telemetry.py``'s ``_rep`` for either package."""
    p = np.asarray(pressure, np.float64)
    z = np.zeros_like(p)
    rep = cls(tick=0, ticks=1, n_shards=len(p), active=list(range(len(p))),
              events=p * 32, events_per_tick=p * 32, queue_depth=z.copy(),
              queue_peak_delta=z.copy(), dropped_delta=z.copy(),
              occupancy=z.copy(), pressure=p, heavy_hitters=list(hh),
              migration_pause_s=0.0)
    for k, v in more.items():
        setattr(rep, k, v)
    return rep


# (controller kwargs, [(pressure, heavy hitters, report fields, decide
# kwargs), ...]) — each case a sequence of windows
HI = [1.0, 1.0]
CASES = {
    "square_wave": (dict(high=0.75, low=0.25, dwell=2, cooldown=2),
                    [([1.0, 1.0] if i % 2 == 0 else [0.05, 0.05], (), {},
                      dict(n_active=2, limit=8)) for i in range(12)]),
    "up_down_cooldown": (
        dict(high=0.75, low=0.25, dwell=2, cooldown=2, min_shards=1),
        [(HI, (), {}, dict(n_active=2, limit=8))] * 2
        + [([1.0] * 4, (), {}, dict(n_active=4, limit=8))] * 3
        + [([2.0] * 8, (), {}, dict(n_active=8, limit=8))] * 2
        + [([0.05] * 8, (), {}, dict(n_active=8, limit=8))] * 5),
    "floor": (dict(high=0.75, low=0.25, dwell=2, cooldown=0, min_shards=2),
              [([0.05] * 4, (), {}, dict(n_active=4, limit=8))] * 2
              + [([0.01] * 2, (), {}, dict(n_active=2, limit=8))] * 4),
    "skew_split": (dict(high=0.5, dwell=1, cooldown=0, skew=0.5),
                   [([1.2, 0.1], [(7, 100, 0.8)], {},
                     dict(n_active=2, limit=2)),
                    ([1.2, 0.1], [(7, 100, 0.8)], {},
                     dict(n_active=2, limit=8, can_split=False)),
                    ([1.2, 0.1], [(7, 100, 0.8), (9, 60, 0.55)], {},
                     dict(n_active=4, limit=8, already_split=(7,))),
                    ([1.2, 0.1], [(7, 100, 0.8)], {},
                     dict(n_active=4, limit=8, already_split=(7,)))]),
    "p99": (dict(high=0.75, low=0.1, dwell=1, cooldown=0, p99_high=6.0),
            [([0.3, 0.3], (), dict(event_latency_p99=9.0),
              dict(n_active=2, limit=8)),
             ([0.9, 0.9], (), dict(event_latency_p99=2.0),
              dict(n_active=4, limit=8)),
             ([0.05, 0.05], (), dict(event_latency_p99=0.0),
              dict(n_active=4, limit=8))]),
    "rebalance_ratio": (dict(high=5.0, low=0.0, dwell=1, cooldown=0,
                             rebalance_ratio=2.0),
                        [([1.0, 0.2, 0.2, 0.2], (), {},
                          dict(n_active=4, limit=4)),
                         ([0.5, 0.5, 0.5, 0.5], (), {},
                          dict(n_active=4, limit=4))]),
    "pause_cooldown": (
        dict(high=0.75, dwell=1, cooldown=1, pause_factor=2.0),
        [(HI, (), dict(migration_pause_s=5.0, window_s=1.0),
          dict(n_active=2, limit=16))]
        + [(HI, (), dict(migration_pause_s=5.0, window_s=1.0),
            dict(n_active=4, limit=16))] * 11
        + [(HI, (), dict(migration_pause_s=0.001, window_s=1.0),
            dict(n_active=8, limit=16))] * 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decide_matches_jax(case):
    """Every window's action (kind, target, keys, reason) and the streak
    and cooldown counters after it, against the JAX controller."""
    kw, windows = CASES[case]
    j, t = jc.LoadAutoscaler(**kw), tc.LoadAutoscaler(**kw)
    fired = 0
    for i, (p, hh, more, dkw) in enumerate(windows):
        a = j.decide(report(JReport, p, hh, **more), **dkw)
        b = t.decide(report(TReport, p, hh, **more), **dkw)
        assert (a is None) == (b is None), (case, i)
        if a is not None:
            fired += 1
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (case, i)
        assert (j._cool, j._hi, j._lo, j._next_cool) == \
            (t._cool, t._hi, t._lo, t._next_cool), (case, i)
    assert fired > 0 or case == "square_wave"
    j.reset(), t.reset()
    assert (t._cool, t._hi, t._lo, t._next_cool) == (0, 0, 0, 0)


@pytest.mark.parametrize("owners", ["none", "one", "rows", "rows2"])
def test_heat_weights_match_jax(owners):
    """``heat_weights`` with no owner map, a 1-D one, and the engine's
    ``[n_updaters, K]`` rows, bitwise against the JAX controller."""
    own = {"none": None,
           "one": lambda ks: np.zeros(len(ks), int),
           "rows": lambda ks: np.zeros((2, len(ks)), int),
           "rows2": lambda ks: np.stack([np.zeros(len(ks), int),
                                         np.ones(len(ks), int)])}[owners]
    for gain in (0.5, 1.0):
        j, t = jc.LoadAutoscaler(skew=0.5, gain=gain), \
            tc.LoadAutoscaler(skew=0.5, gain=gain)
        for events, hh in (([132.0, 32.0], [(7, 100, 0.6)]),
                           ([10.0, 50.0, 7.0], [(3, 40, 0.6), (5, 9, 0.1)]),
                           ([0.0, 0.0], [])):
            rj = report(JReport, [1.0] * len(events), hh,
                        events=np.asarray(events))
            rt = report(TReport, [1.0] * len(events), hh,
                        events=np.asarray(events))
            a, b = j.heat_weights(rj, owners=own), \
                t.heat_weights(rt, owners=own)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


C = ref.CLOSED_LOOP


def closed_loop_engine(ctl, shards, log=None):
    return DistributedEngine(
        Workflow(elastic_ops("U1"), external_streams=("S1",)),
        make_mesh((shards,), ("data",)),
        DistConfig(batch_size=C["G"] // C["low"], queue_capacity=4 * C["G"],
                   fused="off", exchange_slack=8.0,
                   telemetry=TelemetryConfig(width=256, alpha=1.0,
                                             control_log=log),
                   autoscale=ctl), device="cpu")


@pytest.fixture(scope="module")
def jloop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("closed_loop")
    return ref.run_reference(tmp / "closed_loop.pkl", "closed_loop",
                             tmp / "jax_control.jsonl")


def _no_pause(line):
    rec = json.loads(line)
    if rec["applied"] is not None:
        assert rec["applied"].pop("pause_s") > 0
    return rec


def test_closed_loop_square_wave_matches_jax(jloop, tmp_path):
    """A square wave of load (full for 15 ticks, then a tenth) drives the
    ``LoadAutoscaler`` 2 -> 4 shards and back to 2: the per-tick active
    count, every report, every control-log record (pressure, p99,
    queue depth, action, what was applied), the state and the reads
    equal the JAX engine's; at most 5 flips."""
    reports = []
    ctl = LoadAutoscaler(high=0.75, low=0.25, window=3, dwell=2,
                         cooldown=1, min_shards=C["low"],
                         max_shards=C["high"], on_change=reports.append)
    log = tmp_path / "control.jsonl"
    eng = closed_loop_engine(ctl, C["low"], str(log))
    got = ref.closed_loop_run(eng, tbatch, host, reads)
    eng.close()
    want = jloop
    assert got["trace"] == want["trace"]
    tr = got["trace"]
    assert tr[0] == C["low"] and max(tr) == C["high"] and tr[-1] == C["low"]
    assert sum(1 for a, b in zip(tr, tr[1:]) if a != b) <= 5
    assert [ref.report_fields(r) for r in reports] == want["reports"]
    assert all(r.pause_s > 0 for r in reports)
    _eq_tree(want["state"], got["state"])
    assert got["stats"] == want["stats"]
    eq_reads(want["reads"], got["reads"])
    assert (got["n_shards"], got["active"]) == (want["n_shards"],
                                                want["active"])
    mine = [_no_pause(l) for l in log.read_text().splitlines()]
    theirs = [_no_pause(l) for l in want["control_log"].splitlines()]
    assert mine == theirs
    assert sum(r["action"] is not None for r in mine) >= 2


def test_closed_loop_equals_a_fixed_run():
    """The reference's own bar: the closed loop's slates equal, bitwise,
    a run on a fixed 4 shards with no telemetry."""
    ctl = LoadAutoscaler(high=0.75, low=0.25, window=3, dwell=2,
                         cooldown=1, min_shards=C["low"],
                         max_shards=C["high"])
    a = ref.closed_loop_run(closed_loop_engine(ctl, C["low"]), tbatch,
                            host, reads)
    fixed = DistributedEngine(
        Workflow([TECounter()], external_streams=("S1",)),
        make_mesh((C["high"],), ("data",)),
        DistConfig(batch_size=C["G"] // C["low"], queue_capacity=4 * C["G"],
                   fused="off", exchange_slack=8.0), device="cpu")
    b = ref.closed_loop_run(fixed, tbatch, host, reads)
    eq_reads(b["reads"], a["reads"])


def test_closed_loop_ceiling_is_the_starting_slot_count():
    """A difference by design (ROADMAP queue 3): without ``max_shards``
    the JAX loop's ceiling is its visible devices; the port's is the
    physical slot count when ``run`` starts, so the loop reactivates
    parked slots (4 of 4 after a leave to 2) but never grows."""
    ctl = LoadAutoscaler(high=0.75, low=0.25, window=3, dwell=1,
                         cooldown=0, min_shards=2)
    eng = closed_loop_engine(ctl, 4)
    st = eng.init_state()
    st, rep = eng.remove_shards(st, [2, 3])
    assert eng.n_shards == 4 and not rep.recompiled
    trace = []

    def src(t, _mx):
        trace.append((len(eng.active_shards), eng.n_shards))
        keys, xs, _ = ref.closed_loop_feed(t)
        return {"S1": tbatch(keys, xs, t, eng.n_shards)}

    st, _ = eng.run(st, src, 15)
    assert max(a for a, _ in trace) == 4
    assert {n for _, n in trace} == {4}
