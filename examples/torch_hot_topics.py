"""Hot topics on the PyTorch/CUDA port: the paper's Example 2/5 — detect
hot topics on a tweet stream (Figure 1c).

Workflow::

  tweets --M1(classify into topic_minute)--> S2
  S2 --U1(count per topic_minute; emit count each minute)--> S3
  S3 --U2(compare to per-minute historical average; emit hot topics)--> hot

M1 is a matched filter against the topic directions (the app's only
weights, drawn from the seed): ``feat @ dirs.T`` and an argmax.  U1 is a
sequential step function that emits into ``S3`` on the first event of a
later minute; U2 an associative lift + emit pair that subscribes to
``S3`` before its producer is declared (a forward stream reference).
U1's emissions feed U2's queue the next tick: two updater hops.

``groups`` lays G copies of the example's stream side by side in one
key space (topics 16g..16g+15, 512 tweets a group a tick, capacities
and batch sizes times G), so each key sees the example's own rates;
``groups=1`` is the example itself.

Run:  PYTHONPATH=src python examples/torch_hot_topics.py [--device cpu]
(the default device is ``cuda``).
"""
import argparse
from collections import Counter

import numpy as np
import torch

from repro_torch import App, EventBatch, RuntimeConfig

N_TOPICS = 16                 # a group's topics
FEAT = 32
TICKS_PER_MINUTE = 4
HOT_THRESHOLD = 2.0
N = 512                       # tweets a group a tick
BURST_MINUTE = 5              # from this minute on ...
BURST_SHARE = 0.6             # ... 60% of a group's tweets ...
BURST_TOPIC = 3               # ... go to its topic 16g + 3
MAX_RUN = 192
TABLE_CAPACITY = 4096         # both updaters' (App's default)
TICKS = 40


def runtime(groups=1):
    """The example's ``RuntimeConfig``, its sizes times ``groups``."""
    return RuntimeConfig(batch_size=2048 * groups,
                         queue_capacity=8192 * groups, chunk_size=1)


def build_app(topic_dirs, *, groups=1, device="cuda"):
    """The app over ``topic_dirs`` ([16 * groups, FEAT] f32 numpy); both
    table capacities are ``TABLE_CAPACITY * groups``."""
    app = App("hot_topics")
    tweets = app.source("tweets", {"feat": ((FEAT,), torch.float32)})
    w = torch.from_numpy(np.ascontiguousarray(topic_dirs.T)).to(device)
    cap = TABLE_CAPACITY * groups

    @app.mapper(tweets, out="S2", name="M1")
    def classify(batch):
        # .to: the planner traces this on meta tensors
        scores = batch.value["feat"] @ w.to(batch.key.device)
        topic = torch.argmax(scores, dim=-1).to(torch.int32)
        minute = batch.ts // TICKS_PER_MINUTE
        key = topic * 100_000 + minute          # "v_m" composite key
        return EventBatch(sid=batch.sid, ts=batch.ts + 1, key=key,
                          value={"topic": topic}, valid=batch.valid)

    # U2 declared against "S3" before U1 (its producer) exists: forward
    # stream reference.  The lift/emit pair is the paper's
    # current-vs-historical-average comparison.
    def hot_emit(keys, old, new, ts):
        cur = new["total"] - old["total"]       # this period's count
        avg = torch.where(old["periods"] > 0,
                          old["total"] / torch.clamp(old["periods"], min=1),
                          cur)
        ratio = cur / torch.clamp(avg, min=1e-6)
        return {"hot": EventBatch(
            sid=torch.zeros_like(keys), ts=ts + 1, key=keys,
            value={"ratio_x100": (ratio * 100).to(torch.int32)},
            valid=ratio > HOT_THRESHOLD)}

    @app.updater("S3", name="U2", table_capacity=cap,
                 slate={"total": ((), torch.float32),
                        "periods": ((), torch.int32)},
                 emit=hot_emit)
    def track(batch):
        return {"total": batch.value["count"].to(torch.float32),
                "periods": torch.ones_like(batch.key)}

    @app.seq_updater("S2", name="U1", max_run=MAX_RUN, table_capacity=cap,
                     slate={"count": ((), torch.int32),
                            "emitted": ((), torch.int32)})
    def minute_count(slate, ev):
        """Count events per <topic, minute>; on the first event of the
        next minute emit <topic, count> into S3 (re-keyed to the topic:
        U2's slate holds the topic's history across minutes)."""
        new_count = slate["count"] + 1
        minute_now = ev["ts"] // TICKS_PER_MINUTE
        key_minute = ev["key"] % 100_000
        closed = minute_now > key_minute        # this minute has passed
        do_emit = closed & (slate["emitted"] == 0)
        out = {"S3": {"key": ev["key"] // 100_000,
                      "value": {"count": new_count},
                      "emit": do_emit}}
        return ({"count": new_count,
                 "emitted": torch.where(do_emit, 1, slate["emitted"])},
                out)

    return app


def make_feed(seed, n_ticks, groups=1):
    """``(topic_dirs, ticks)``: the topic directions and each tick's
    numpy arrays (``feat`` [512 G, FEAT] f32, ``key`` int32, ``topic``
    the generating topic).  At ``groups=1`` the draws are the JAX
    example's, in its order (its ``source_fn`` shares the generator that
    drew the directions)."""
    rng = np.random.default_rng(seed)
    topic_dirs = rng.normal(size=(N_TOPICS * groups, FEAT)).astype(
        np.float32)
    n = N * groups
    base = N_TOPICS * (np.arange(n) // N)       # each row's group
    ticks = []
    for tick in range(n_ticks):
        if tick // TICKS_PER_MINUTE >= BURST_MINUTE:
            burst = rng.random(n) < BURST_SHARE
            t_ids = np.where(burst, BURST_TOPIC,
                             rng.integers(0, N_TOPICS, n))
        else:
            t_ids = rng.integers(0, N_TOPICS, n)
        t_ids = base + t_ids
        feat = topic_dirs[t_ids] * 3 + rng.normal(size=(n, FEAT)).astype(
            np.float32)
        ticks.append({"feat": feat.astype(np.float32),
                      "key": rng.integers(0, 1 << 30, n).astype(np.int32),
                      "topic": t_ids.astype(np.int32)})
    return topic_dirs, ticks


def source(ticks, device):
    """``source_fn`` over ``make_feed``'s ticks (each copied to
    ``device`` when the engine asks for it)."""
    def source_fn(tick, max_events):
        d = ticks[tick]
        return {"tweets": EventBatch.of(
            key=d["key"], value={"feat": d["feat"]},
            ts=np.full(d["key"].size, tick, np.int32), device=device)}
    return source_fn


def hot_pairs(outs):
    """``[(topic, tick, ratio_x100), ...]`` of every valid ``hot`` row."""
    found = []
    for tick, o in enumerate(outs):
        if "hot" not in o:
            continue
        hb = o["hot"]
        valid = hb.valid.cpu().numpy()
        for k, r in zip(hb.key.cpu().numpy()[valid],
                        hb.value["ratio_x100"].cpu().numpy()[valid]):
            found.append((int(k), tick, int(r)))
    return found


def check_hot(found, groups=1):
    """Each group's burst topic surfaces as hot and is its group's most
    frequent hot topic; returns the mismatches."""
    bad = []
    for g in range(groups):
        mine = Counter(k for k, _, _ in found if k // N_TOPICS == g)
        want = N_TOPICS * g + BURST_TOPIC
        if not mine or mine.most_common(1)[0][0] != want:
            bad.append(f"group {g}: hot topics {dict(mine)}, burst topic "
                       f"{want} should dominate")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    topic_dirs, ticks = make_feed(args.seed, TICKS)
    app = build_app(topic_dirs, device=args.device)
    app.start(runtime(), device=args.device)
    outs = app.run(source(ticks, args.device), n_ticks=TICKS)
    found = hot_pairs(outs)
    for k, tick, r in found:
        print(f"tick {tick}: HOT topic={k} ratio={r / 100:.1f}x")
    bad = check_hot(found)
    print(f"\ndetected {len(found)} hot <topic,minute> pairs; "
          f"stats: {app.stats()['processed']}")
    app.close()
    if bad:
        raise SystemExit("MISMATCH: " + "; ".join(bad))
    print(f"burst topic {BURST_TOPIC} dominates — OK")


if __name__ == "__main__":
    main()
