"""Reputation on the PyTorch/CUDA port: the paper's Example 3 — maintain
a reputation score per Twitter user.

"if a user A retweets or replies to a user B, then the score of B may
change, depending on the score of A" — order matters (B's bump depends
on A's *current* score), so the update is a sequential step function:
strict per-key timestamp order, run tails past ``max_run`` deferred to
the next tick.

``groups`` scales the feed: 512 tweets a group a tick, celebrities
``0 .. 5 G - 1`` mentioned by 30% of them (so each celebrity sees the
example's rate), the rest a user drawn uniformly from the others of
``n_users``; ``groups=1`` is the example itself.

Run:  PYTHONPATH=src python examples/torch_reputation.py [--device cpu]
(the default device is ``cuda``).
"""
import argparse

import numpy as np
import torch

from repro_torch import App, EventBatch, RuntimeConfig

N_USERS = 200
CELEBRITIES = 5               # a group's
CELEBRITY_SHARE = 0.3
N = 512                       # tweets a group a tick
MAX_RUN = 32
TABLE_CAPACITY = 1024
TICKS = 30


def runtime(groups=1):
    """The example's ``RuntimeConfig``, its sizes times ``groups``."""
    return RuntimeConfig(batch_size=1024 * groups,
                         queue_capacity=4096 * groups)


def build_app(*, table_capacity=TABLE_CAPACITY):
    """The app; U1 holds ``table_capacity`` slates (a scaled feed's
    users need more than ``TABLE_CAPACITY``)."""
    app = App("reputation")
    tweets = app.source("tweets", {"target": ((), torch.int32),
                                   "actor_score": ((), torch.float32)})

    @app.mapper(tweets, out="S2", name="M1")
    def interaction(batch):
        """M1: tweet -> <target_user, actor_score> scoring event."""
        return EventBatch(sid=batch.sid, ts=batch.ts + 1,
                          key=batch.value["target"],
                          value={"actor_score": batch.value["actor_score"]},
                          valid=batch.valid)

    @app.seq_updater("S2", name="U1", table_capacity=table_capacity,
                     max_run=MAX_RUN,
                     slate={"score": ((), torch.float32),
                            "interactions": ((), torch.int32)})
    def reputation(slate, ev):
        """U1: score' = 0.95*score + 0.05*actor_score + 0.01 (sequential:
        the bump size depends on the score's current value)."""
        new_score = (0.95 * slate["score"]
                     + 0.05 * ev["value"]["actor_score"] + 0.01)
        return ({"score": new_score,
                 "interactions": slate["interactions"] + 1}, {})

    return app


def make_feed(seed, n_ticks, groups=1, n_users=None):
    """Each tick's numpy arrays (``target`` and ``actor_score`` of
    512 G tweets, ``key``).  ``n_users`` defaults to ``N_USERS * groups``.
    At ``groups=1`` the draws are the JAX example's, in its order."""
    rng = np.random.default_rng(seed)
    n, celebs = N * groups, CELEBRITIES * groups
    n_users = N_USERS * groups if n_users is None else n_users
    ticks = []
    for _ in range(n_ticks):
        celebrity = rng.random(n) < CELEBRITY_SHARE
        target = np.where(celebrity, rng.integers(0, celebs, n),
                          rng.integers(celebs, n_users, n)).astype(np.int32)
        actor_score = np.where(celebrity, rng.uniform(0.8, 1.0, n),
                               rng.uniform(0.0, 0.3, n)).astype(np.float32)
        ticks.append({"target": target, "actor_score": actor_score,
                      "key": rng.integers(0, 1 << 30, n).astype(np.int32)})
    return ticks


def source(ticks, device):
    """``source_fn`` over ``make_feed``'s ticks."""
    def source_fn(tick, max_events):
        d = ticks[tick]
        return {"tweets": EventBatch.of(
            key=d["key"], value={"target": d["target"],
                                 "actor_score": d["actor_score"]},
            ts=np.full(d["key"].size, tick, np.int32), device=device)}
    return source_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    app = build_app()
    app.run(source(make_feed(args.seed, TICKS), args.device), n_ticks=TICKS,
            runtime=runtime(), drain=True, device=args.device)

    scores = []
    for u in range(N_USERS):
        s = app.read_slate("U1", u)
        if s is not None:
            scores.append((float(s["score"]), int(s["interactions"]), u))
    scores.sort(reverse=True)
    print("top-10 reputation:")
    for sc, n, u in scores[:10]:
        print(f"  user {u:4d}: score={sc:.3f}  ({n} interactions)")
    print("processed:", app.stats()["processed"])
    app.close()
    top = {u for _, _, u in scores[:CELEBRITIES]}
    if top != set(range(CELEBRITIES)):
        raise SystemExit(f"MISMATCH: the top {CELEBRITIES} are {top}")
    print(f"\ncelebrities 0-{CELEBRITIES - 1} rank on top — OK")


if __name__ == "__main__":
    main()
