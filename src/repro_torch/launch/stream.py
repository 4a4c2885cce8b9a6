"""Durable stream-engine launcher (port of ``repro.launch.stream``): the
counting workflow (paper Examples 1/4) with the
DESIGN.md section 10 durability layer, exposing the ``--recover`` path
— built on the declarative app layer (section 11).

Normal run::

    python -m repro_torch.launch.stream --dir /tmp/muppet --ticks 64

Simulated crash (exit mid-run without flushing) then recovery::

    python -m repro_torch.launch.stream --dir /tmp/muppet --ticks 64 --crash-at 40
    python -m repro_torch.launch.stream --dir /tmp/muppet --ticks 64 --recover

The recovered run restores flushed slates from the KV store, replays the
WAL suffix from the frontier, then continues to ``--ticks`` and prints
stats + a few slates, matching what the uninterrupted run would print
(``processed`` counts restart at the frontier, as in the JAX package).
``--serve`` starts the live HTTP slate server for the duration of the
run (reads go through the engine's :class:`StateHandle`, republished
every chunk).  ``--device`` picks the card (default ``cuda``) or
``cpu``.

``--shards N`` above 1 runs ``DistributedEngine`` with N shards on the
one device (a WAL a shard), fed the same global events each tick
(``source_fn_sharded``)::

    python -m repro_torch.launch.stream --dir /tmp/m --ticks 64 --shards 8

Started by ``torch.distributed.run`` (``WORLD_SIZE`` above 1), each rank
joins the launcher's process group (NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``) and holds its block of the shards; every rank
makes the same global feed from the seed and keeps its block's rows.
Rank 0 prints what the one-process run prints; the others print
nothing.  With ``--serve`` rank 0 serves the slates: a read is a
collective, so its request waits on the read queue that every rank
drains after each chunk (``StateHandle.drain``), and ``app.close()``
answers what is still queued::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.stream --device cpu --dir /tmp/r --shards 8 \
        --serve

Live elasticity (DESIGN.md section 12) on the same shards::

    python -m repro_torch.launch.stream --dir /tmp/m --ticks 64 \
        --shards 8 --scale-at 24:16 --scale-at 48:8

Each ``--scale-at TICK:N`` rescales the active shard set live before
source tick TICK, migrating slates and in-flight events loss-free;
``--rebalance-every K`` reweights the ring from the per-shard load
signal every K ticks.  Growing needs no devices: every shard lives on
``--device``.

Closed-loop autoscaling (DESIGN.md section 13) replaces the declared
schedule with watermarks on the telemetry pressure signal::

    python -m repro_torch.launch.stream --dir /tmp/m --ticks 48 \
        --shards 2 --autoscale load:0.75,0.2

``--autoscale load:HI,LO`` attaches a ``LoadAutoscaler``: the active
shard set grows when windowed per-shard pressure stays above HI and
shrinks back once it stays below LO (hysteresis: dwell + cooldown); the
final telemetry report is printed with the stats.  Without
``max_shards`` the controller's ceiling is the shard count the run
starts with.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch import (App, AutoscalePolicy, EventBatch, LoadAutoscaler,
                         RuntimeConfig)


def start_ranks(device: str):
    """Join the process group ``torch.distributed.run`` set up when
    ``WORLD_SIZE`` is above 1: NCCL on this rank's card
    (``cuda:LOCAL_RANK``), gloo on the CPU.  A rank with no card raises
    unless ``--device cpu`` asked for the CPU.  Returns ``(group,
    device)``; ``(None, device)`` in a world of one."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, device
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this rank found no CUDA device; pass --device cpu to run "
                "the ranks on the CPU (gloo)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl")
        return dist.group.WORLD, str(dev)
    dist.init_process_group("gloo")
    return dist.group.WORLD, device


def make_app(args, group=None) -> App:
    app = App("stream")
    s1 = app.source("S1", {"x": ((), torch.float32)})

    @app.mapper(s1, out="S2", name="M1")
    def forward(batch):
        return EventBatch(sid=batch.sid, ts=batch.ts + 1, key=batch.key,
                          value=batch.value, valid=batch.valid)

    @app.updater("S2", name="U1", merge="sum",
                 slate={"count": ((), torch.int32),
                        "sum": ((), torch.float32)},
                 table_capacity=1 << 14)
    def lift(batch):
        return {"count": torch.ones_like(batch.key, dtype=torch.int32),
                "sum": batch.value["x"]}

    def on_change(rep):
        say(f"reconfigured: active={len(rep.active)} shards, moved "
              f"{sum(rep.moved_rows.values())} rows + "
              f"{sum(rep.moved_events.values())} queued events "
              f"({'recompiled' if rep.recompiled else 'ring swap only'})")

    autoscale = None
    if args.autoscale is not None:
        hi, lo = args.autoscale
        autoscale = LoadAutoscaler(high=hi, low=lo, window=4, dwell=1,
                                   cooldown=1, on_change=on_change)
    elif args.scale_at or args.rebalance_every:
        autoscale = AutoscalePolicy(
            scale_at=dict(args.scale_at or ()),
            rebalance_every=args.rebalance_every,
            on_change=on_change)
    telemetry = None
    if getattr(args, "trace", None):
        from repro_torch.telemetry import TelemetryConfig
        telemetry = TelemetryConfig(trace=True)
    app.start(RuntimeConfig(batch_size=args.batch,
                            queue_capacity=args.batch * 4,
                            chunk_size=args.chunk,
                            shards=args.shards,
                            group=group,
                            autoscale=autoscale,
                            telemetry=telemetry,
                            durable_dir=args.dir,
                            flush_every=args.flush_every,
                            truncate_wal=args.truncate_wal),
              recover=args.recover, device=args.device)
    return app


def source_fn(t, max_events, batch, device=None):
    rng = np.random.default_rng(t)           # deterministic per tick:
    n = min(batch, max_events or batch)      # replay == original feed
    keys = rng.integers(0, 10_000, size=n).astype(np.int32)
    return {"S1": EventBatch.of(
        key=keys, value={"x": rng.normal(size=n).astype(np.float32)},
        ts=np.full(n, t, np.int32), device=device)}


def source_fn_sharded(t, app, batch, device=None):
    """Distributed feed: the same *global* event multiset per tick
    whatever the shard count, reshaped to the engine's ``[n_shards, B]``
    layout and padded with invalid rows up to the next multiple of
    ``n_shards``."""
    n = app.engine.n_shards
    b = source_fn(t, None, batch, device)["S1"].pad_to(-(-batch // n) * n)
    shaped = EventBatch(
        sid=b.sid.reshape(n, -1), ts=b.ts.reshape(n, -1),
        key=b.key.reshape(n, -1),
        value={"x": b.value["x"].reshape(n, -1)},
        valid=b.valid.reshape(n, -1))
    return {"S1": shaped}


def parse_scale_at(spec: str):
    try:
        tick, n = spec.split(":")
        return int(tick), int(n)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--scale-at wants TICK:N (e.g. 24:16), got {spec!r}")


def parse_autoscale(spec: str):
    try:
        mode, rest = spec.split(":")
        if mode != "load":
            raise ValueError
        hi, lo = (float(x) for x in rest.split(","))
        return hi, lo
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--autoscale wants load:HI,LO (e.g. load:0.75,0.2), "
            f"got {spec!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True,
                    help="durability root (wal.log, store/, FRONTIER)")
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--flush-every", type=int, default=16)
    ap.add_argument("--truncate-wal", action="store_true",
                    help="compact the WAL at each flush frontier")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda)")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard count (>1 = DistributedEngine, every "
                         "shard on --device)")
    ap.add_argument("--scale-at", type=parse_scale_at, action="append",
                    default=None, metavar="TICK:N",
                    help="live-rescale to N active shards before source "
                         "tick TICK (repeatable)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="reweight the ring from the per-shard load "
                         "signal every K source ticks")
    ap.add_argument("--autoscale", type=parse_autoscale, default=None,
                    metavar="load:HI,LO",
                    help="closed-loop autoscaling: grow the active "
                         "shard set when windowed pressure > HI, "
                         "shrink when < LO (DESIGN.md section 13)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="hard-exit after this many source ticks "
                         "(simulated machine crash; no final flush)")
    ap.add_argument("--recover", action="store_true",
                    help="restore slates + replay WAL before running")
    ap.add_argument("--serve", action="store_true",
                    help="HTTP slate server live during the run")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record engine phase spans and export them as "
                         "Chrome trace JSON (open in Perfetto) after "
                         "the run")
    args = ap.parse_args(argv)
    if args.autoscale is not None and args.shards < 2:
        ap.error("--autoscale needs --shards >= 2 (a distributed "
                 "runtime to scale)")
    if args.autoscale is not None and (args.scale_at
                                       or args.rebalance_every):
        ap.error("--autoscale (closed loop) and --scale-at/"
                 "--rebalance-every (declared schedule) are mutually "
                 "exclusive")

    group, args.device = start_ranks(args.device)
    try:
        run(args, group)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def say(*a, **kw):
    """Print on rank 0 only (every rank of a world of one)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*a, **kw)


def run(args, group):
    app = make_app(args, group)
    eng = app.engine
    done = 0
    if args.recover:
        # resume the source stream where it left off: the frontier's
        # driver cursor survives even full WAL truncation, and events
        # carry their source tick as ts, so post-frontier WAL records
        # advance it further.  (The engine tick is no substitute — it
        # also counts flush drain ticks.)  Every shard's log: over ranks
        # a rank owns only its block's, so it reads the others' too.
        if eng.dur.frontier.meta:
            done = int(eng.dur.frontier.meta.get("source_tick", 0))
        if args.shards > 1:
            from repro_torch.slates.wal import WriteAheadLog
            wals = [WriteAheadLog(eng.dur.cfg.wal_path(s), read_only=True)
                    for s in range(eng.n_shards)]
        else:
            wals = eng.dur.wals
        for wal in wals:
            for _, srcs in wal.replay():
                if "S1" in srcs:
                    done = max(done, int(srcs["S1"].ts.max()) + 1)
        say(f"recovered: frontier tick {eng.dur.frontier.tick}, "
              f"engine tick {app.stats()['tick']}, "
              f"resuming at source tick {done}")

    if args.serve:
        server = app.serve()
        say(f"slates live at http://127.0.0.1:{server.port}/slate/U1/<k>")

    remaining = max(0, args.ticks - done)
    if args.crash_at is not None:
        remaining = min(remaining, args.crash_at - done)
    if args.shards > 1:
        app.run(lambda t, mx: source_fn_sharded(t, app, args.batch,
                                                eng.device),
                remaining, source_offset=done)
    else:
        app.run(lambda t, mx: source_fn(t, mx, args.batch, eng.device),
                remaining, source_offset=done)

    if args.crash_at is not None and not args.recover:
        say(f"CRASH at source tick {args.crash_at} (state dropped; "
              f"rerun with --recover)")
        return   # no close(): unflushed slates die with the process

    if args.trace and (group is None or eng.rank == 0):
        # over ranks rank 0 writes its own spans
        path = app.export_trace(args.trace)
        with open(path) as f:          # verify it round-trips as JSON
            n_spans = len(json.load(f)["traceEvents"])
        say(f"trace: {n_spans} span(s) -> {path} "
            f"(load in Perfetto / chrome://tracing)")

    say(json.dumps(app.stats(), indent=2))
    if args.autoscale is not None:
        rep = app.telemetry()
        say(f"telemetry: active={len(rep.active)} shards, "
              f"pressure={np.round(rep.pressure, 3).tolist()}, "
              f"heavy={rep.heavy_hitters[:3]}")
    for key in (0, 1, 2):
        say(f"slate[{key}] =", _show(app.read_slate("U1", key)))
    app.close()


def _show(slate):
    """A slate as plain Python numbers (the JAX launcher prints its
    arrays' values)."""
    if slate is None:
        return None
    return {k: v.item() for k, v in slate.items()}


if __name__ == "__main__":
    main()
