#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--ticks 128] [--seed 0]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/``, then:

1. prints the card (``nvidia-smi`` name and power limit) and the
   torch / CUDA versions;
2. builds both kernels (one nvcc per source, started together) and
   prints the build time;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (B=65,536 events, D=8 lanes, C=2**22 slots,
   Q=4,096 reads), for int32 and int64 keys, and times both on the
   same inputs by device time from torch.profiler.  No single PyTorch
   call computes either function (a segmented combine fused with a slot
   read-modify-write; a probe walk fused with a row gather), so there is
   no library time;
4. checks that a ``run_chunk`` tick never syncs the host (torch's sync
   debug mode set to "error"), on a small engine;
5. drives the main path end to end through the engine's entry points:
   ``S1 -> M1 (pass-through) -> S2 -> {U1 sum, U2 max}`` with
   ``table_capacity=2**22`` per updater, 65,536 events a tick,
   ``Engine.run`` over ``--ticks`` ticks, ``drain``, then
   ``read_slates`` / ``read_slate``.  Keys are Zipf(1.2) over 1,048,576
   keys drawn on the card from a seeded generator; lane 0 of each value
   is 1 (a count) and lanes 1-7 integers in [0, 8), so every lane is
   exact in f32.  Every slate is held against an independent numpy
   reference (bincounts and maxima over every event fed), the launch
   counters must show both kernels ran, and no queue may drop.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  Without a CUDA device, or outside
a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
SECTOR = 32                      # bytes per random device-memory access

B, D, C, Q = 65536, 8, 2**22, 4096
N_KEYS = 1 << 20
ZIPF_ALPHA = 1.2


def log(*a):
    print(*a, flush=True)


def sectors(nbytes: int) -> int:
    return -(-nbytes // SECTOR) * SECTOR


def device_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn()`` in ms: the sum of the kernels and
    copies it runs, from torch.profiler, with no host gaps between them.
    Raises when the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / reps / 1e3


def zipf_cdf(device):
    import torch
    ranks = torch.arange(1, N_KEYS + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-ZIPF_ALPHA)
    return torch.cumsum(p / p.sum(), 0)


def zipf_keys(cdf, n, gen):
    import torch
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=N_KEYS - 1).to(torch.int32)


def tick_values(n, gen, device):
    """[n, 8] f32: lane 0 = 1 (the count), lanes 1..7 integers in [0, 8)."""
    import torch
    v = torch.randint(0, 8, (n, D), generator=gen, device=device)
    v[:, 0] = 1
    return v.to(torch.float32)


# ---------------------------------------------------------------- phase 3
def check_slate_update(dev, seed):
    import torch
    from repro_torch.kernels.slate_update import kernel as uk
    from repro_torch.kernels.slate_update import ref as ur
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdf = zipf_cdf(dev)
    keys32 = torch.sort(zipf_keys(cdf, B, gen)).values
    last = torch.ones(B, dtype=torch.bool, device=dev)
    last[:-1] = keys32[1:] != keys32[:-1]
    n_runs = int(last.sum())
    slots = torch.full((B,), -1, dtype=torch.int32, device=dev)
    slots[last] = torch.randperm(C, generator=gen, device=dev)[:n_runs].to(
        torch.int32)
    runs = torch.unique_consecutive(keys32, return_counts=True)[1]
    hot = int(runs.max())
    table = torch.randint(0, 1000, (C + 1, D), generator=gen,
                          device=dev).to(torch.float32)
    ints = tick_values(B, gen, dev)
    floats = torch.randn(B, D, generator=gen, device=dev)
    log(f"slate_update inputs: B={B} D={D} C={C} runs={n_runs} "
        f"longest_run={hot} ({hot / B:.3f} of the batch)")

    max_err = 0.0
    for kd in (torch.int32, torch.int64):
        # int64 keys beyond 2**33 keep the int32 keys' order
        keys = keys32 if kd == torch.int32 else \
            keys32.to(torch.int64) * (2**33 + 1) - 2**40
        for op in ("sum", "max"):
            a = uk.slate_update(keys, ints, slots, table.clone(), op=op)
            b = ur.slate_update(keys, ints, slots, table.clone(), op=op)
            torch.cuda.synchronize()
            ok = torch.equal(a, b)
            log(f"slate_update {op} keys={str(kd)[6:]} integer deltas: "
                f"bitwise={ok}")
            if not ok:
                raise AssertionError(f"slate_update {op} {kd} differs from "
                                     f"its plain version")
        # float deltas: both sides are within (n + 1) * 2**-24 * mass of
        # the exact sum of a run of n terms plus the table value, in any
        # order; their difference is within twice that
        a = uk.slate_update(keys, floats, slots, table.clone(), op="sum")
        b = ur.slate_update(keys, floats, slots, table.clone(), op="sum")
        seg = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.int64,
                                                 device=dev),
                                      (keys[1:] != keys[:-1]).long()]), 0) - 1
        mass = torch.zeros(n_runs, D, device=dev).index_add_(
            0, seg, floats.abs())
        nrun = torch.bincount(seg, minlength=n_runs).float()[:, None]
        w = slots >= 0
        tol = torch.zeros_like(table)
        tol[slots[w]] = 2 * (nrun[seg[w]] + 1) * 2.0**-24 * (
            mass[seg[w]] + table[slots[w]].abs())
        err = (a - b).abs()
        torch.cuda.synchronize()
        if not bool((err <= tol).all()):
            raise AssertionError("slate_update float sum outside tolerance")
        max_err = max(max_err, float(err.max()))
        log(f"slate_update sum keys={str(kd)[6:]} float deltas: max_abs_err="
            f"{float(err.max())} within 2*(n+1)*2**-24*(|table|+sum|d|)")

    scratch = table.clone()
    ms = device_ms(lambda: uk.slate_update(keys32, ints, slots, scratch))
    plain_ms = device_ms(lambda: ur.slate_update(keys32, ints, slots,
                                                 scratch))
    # keys, int32 slots and deltas read once; one row read and written
    # per run
    nbytes = (B * 4 + B * 4 + B * D * 4
              + n_runs * 2 * sectors(D * 4))
    ops = B * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"slate_update sum int32: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms (device time, torch.profiler, mean of 20), bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes at 3.35 TB/s)")
    return {"name": "slate_update", "route": "cuda",
            "source": "src/repro_torch/csrc/slate_update.cu",
            "replaces": "src/repro/kernels/slate_update/kernel.py:83",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def check_slate_lookup(dev, seed):
    import torch
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_lookup import ref as lr
    from repro_torch.slates import table as tbl
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    entry = None
    max_err = 0.0
    for kd in (torch.int32, torch.int64):
        draw = torch.randint(0, 2**30, (N_KEYS + N_KEYS // 8,),
                             generator=gen, device=dev)
        ids = torch.unique(draw)[:N_KEYS]
        ids = ids[torch.randperm(ids.numel(), generator=gen, device=dev)]
        keys = ids.to(kd) if kd == torch.int32 else \
            ids.to(torch.int64) * (2**33 + 3) - 2**45
        t = tbl.make_table(C, {"v": ((D,), torch.float32)}, key_dtype=kd,
                           device=dev)
        for i in range(0, N_KEYS, B):
            part = keys[i:i + B]
            tbl.insert_or_find(t, part, torch.ones_like(part, dtype=torch.bool))
        t.vals["v"].copy_(torch.randn(C + 1, D, generator=gen, device=dev))
        # TTL: a quarter of the rows are stale at tick 100 with ttl 10
        t.ts.copy_(torch.where(torch.rand(C + 1, generator=gen, device=dev)
                               < 0.25, 0, 95).to(torch.int32))
        tbl.expire_ttl(t, torch.tensor(100, dtype=torch.int32, device=dev),
                       10)
        present = (t.keys[:C] != tbl.EMPTY)
        live = t.keys[:C][present]
        dead = keys[~torch.isin(keys, live)]
        absent = (keys[:Q // 4] + 1) if kd == torch.int64 else \
            torch.randint(2**30, 2**31 - 1, (Q // 4,), generator=gen,
                          device=dev).to(kd)
        pick = lambda x, n: x[torch.randperm(x.numel(), generator=gen,
                                             device=dev)[:n]]
        query = torch.cat([pick(live, Q // 2), pick(dead, Q // 4), absent])
        query = query[torch.randperm(Q, generator=gen, device=dev)]
        cand = tbl._probe_seq(query, C).to(torch.int32)
        a = lk.slate_lookup(t.keys, query, cand, t.vals["v"])
        b = lr.slate_lookup(t.keys, query, cand, t.vals["v"])
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        max_err = max(max_err, float((a[2] - b[2]).abs().max()),
                      float((a[0] - b[0]).abs().max()))
        n_found = int(a[1].sum())
        log(f"slate_lookup keys={str(kd)[6:]} Q={Q} found={n_found} "
            f"(live {Q // 2}, ttl-expired {Q // 4}, absent {Q // 4}): "
            f"bitwise={same}")
        if not same or n_found != Q // 2:
            raise AssertionError(f"slate_lookup {kd} differs from its plain "
                                 f"version or misses live keys")
        kname = str(kd)[6:]
        ms = device_ms(
            lambda: lk.slate_lookup(t.keys, query, cand, t.vals["v"]))
        plain_ms = device_ms(
            lambda: lr.slate_lookup(t.keys, query, cand, t.vals["v"]))
        # the read path as ops.slate_lookup runs it: the probe chain
        # hashed on the card, then the kernel or its plain version
        hashed = lambda: tbl._probe_seq(query, C).to(torch.int32)
        path_ms = device_ms(lambda: lk.slate_lookup(
            t.keys, query, hashed(), t.vals["v"]))
        plain_path_ms = device_ms(lambda: lr.slate_lookup(
            t.keys, query, hashed(), t.vals["v"]))
        # probes needed: up to the first hit, all P on a miss
        hit = t.keys[cand] == query[None]
        first = torch.where(hit.any(0),
                            torch.argmax(hit.to(torch.uint8), 0) + 1,
                            cand.shape[0])
        probes = int(first.sum())
        kb = query.element_size()
        # query and int32 candidates read once, one sector per probe
        # and per found row, int32 slot + found + row written per query
        nbytes = (Q * kb + cand.numel() * 4 + probes * SECTOR
                  + n_found * sectors(D * 4) + Q * (4 + 1 + D * 4))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"slate_lookup {kname}: kernel {ms:.5f} ms, plain {plain_ms:.5f}"
            f" ms on the same candidates (device time, torch.profiler, "
            f"mean of 20); with the probe chain hashed on the card "
            f"kernel {path_ms:.5f} ms, plain {plain_path_ms:.5f} ms; bound "
            f"{bound_ms:.6f} ms ({nbytes} bytes at 3.35 TB/s)")
        if kd == torch.int32:       # the main path's key type
            entry = {"name": "slate_lookup", "route": "cuda",
                     "source": "src/repro_torch/csrc/slate_lookup.cu",
                     "replaces": "src/repro/kernels/slate_lookup/"
                                 "kernel.py:124",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None}
        del t
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max_err
    return entry


# ---------------------------------------------------------------- workflow
def build_workflow(capacity):
    import torch
    from repro_torch.core.event import EventBatch
    from repro_torch.core.operators import AssociativeUpdater, Mapper
    from repro_torch.core.workflow import Workflow
    spec = {"v": ((D,), torch.float32)}

    class PassThrough(Mapper):
        name = "M1"
        subscribes = ("S1",)
        in_value_spec = spec
        out_streams = {"S2": spec}

        def map_batch(self, batch):
            return {"S2": EventBatch(batch.sid, batch.ts + 1, batch.key,
                                     batch.value, batch.valid)}

    class Counter(AssociativeUpdater):
        name = "U1"
        subscribes = ("S2",)
        in_value_spec = spec
        out_streams = {}
        table_capacity = capacity
        sum_mergeable = True

        def slate_spec(self):
            return spec

        def lift(self, batch):
            return {"v": batch.value["v"]}

        def combine(self, a, b):
            return {"v": a["v"] + b["v"]}

        merge = combine

    class Peak(Counter):
        name = "U2"
        sum_mergeable = False
        monoid = "max"

        def combine(self, a, b):
            return {"v": torch.maximum(a["v"], b["v"])}

        merge = combine

    return Workflow([PassThrough(), Counter(), Peak()],
                    external_streams=("S1",))


def make_source(cdf, batch, seed):
    """``source_fn(tick, max_events)``: tick t's events come from a
    generator seeded by (seed, t), so the reference regenerates them."""
    import torch
    from repro_torch.core.event import EventBatch

    def gen_tick(t):
        g = torch.Generator(device=cdf.device).manual_seed(
            seed * 1_000_003 + t)
        return zipf_keys(cdf, batch, g), tick_values(batch, g, cdf.device)

    def source_fn(t, max_events):
        keys, vals = gen_tick(t)
        dev = keys.device
        valid = torch.ones(batch, dtype=torch.bool, device=dev)
        if max_events is not None:
            valid = torch.arange(batch, device=dev) < max_events
        return {"S1": EventBatch(
            sid=torch.zeros(batch, dtype=torch.int32, device=dev),
            ts=torch.full((batch,), t, dtype=torch.int32, device=dev),
            key=keys, value={"v": vals}, valid=valid)}

    return source_fn, gen_tick


def check_no_host_sync(dev, seed):
    """One chunk of ticks with torch's sync debug mode on "error": any
    host sync inside the tick raises."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, stack_sources
    eng = Engine(build_workflow(1 << 16),
                 EngineConfig(batch_size=4096, queue_capacity=16384),
                 device=dev)
    state = eng.init_state()
    source_fn, _ = make_source(zipf_cdf(dev), 4096, seed + 7)
    stacked = stack_sources([source_fn(t, None) for t in range(3)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _, info = eng.run_chunk(state, stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = info["throttle_hits"].tolist()
    log(f"run_chunk of 3 ticks under sync debug mode 'error': no host "
        f"sync (throttle trace {hits})")


# ---------------------------------------------------------------- phase 5
def end_to_end(dev, ticks, seed, card):
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.kernels.slate_lookup import kernel as lk
    from repro_torch.kernels.slate_update import kernel as uk

    cfg = EngineConfig(batch_size=B, queue_capacity=262144, chunk_size=8)
    eng = Engine(build_workflow(C), cfg, device=dev)
    cdf = zipf_cdf(dev)
    source_fn, gen_tick = make_source(cdf, B, seed)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    state = eng.init_state()

    uk.slate_update.launches = 0
    lk.slate_lookup.launches = 0
    t0 = time.perf_counter()
    state, _ = eng.run(state, source_fn, ticks)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, drained = eng.drain(state)
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    hot = np.arange(Q // 2)
    n_never = Q // 16
    cold = rng.integers(Q // 2, N_KEYS, Q // 2 - n_never)
    never = np.arange(N_KEYS, N_KEYS + n_never)      # never fed
    read_keys = np.concatenate([hot, cold, never])
    t0 = time.perf_counter()
    got_sum = eng.read_slates(state, "U1", read_keys)
    got_max = eng.read_slates(state, "U2", read_keys)
    t_reads = time.perf_counter() - t0
    singles = [int(k) for k in read_keys[[0, 1, 7, Q // 2, -1]]]
    single = {k: (eng.read_slate(state, "U1", k),
                  eng.read_slate(state, "U2", k)) for k in singles}
    launches = {"slate_update": uk.slate_update.launches,
                "slate_lookup": lk.slate_lookup.launches}
    stats = eng.stats(state)
    log(f"end to end: {ticks} ticks x {B} events in {t_run:.3f} s = "
        f"{t_run / ticks * 1e3:.3f} ms/tick, {ticks * B / t_run:.4e} "
        f"events/s (source generation on the card included), drain "
        f"{drained} ticks in {t_drain:.3f} s, {2 * read_keys.size} "
        f"read_slates keys in {t_reads:.4f} s; {card}")
    log(f"engine state on the card: "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB after "
        f"the run; launches on the main path {launches}")
    log(f"stats: processed={stats['processed']} "
        f"queue_dropped={stats['queue_dropped']} "
        f"queue_peak={stats['queue_peak']} "
        f"table_occupancy={stats['table_occupancy']} "
        f"table_dropped={stats['table_dropped']}")

    # ---- the independent reference: every event fed, in numpy ----
    counts = np.zeros(N_KEYS + n_never, np.int64)
    sums = np.zeros((N_KEYS + n_never, D), np.float64)
    maxes = np.zeros((N_KEYS + n_never, D), np.float32)
    for t in range(ticks):
        k, v = gen_tick(t)
        k, v = k.cpu().numpy(), v.cpu().numpy()
        counts += np.bincount(k, minlength=counts.size)
        for lane in range(D):
            sums[:, lane] += np.bincount(k, weights=v[:, lane],
                                         minlength=counts.size)
        np.maximum.at(maxes, k, v)

    fed = ticks * B
    if any(v != 0 for v in stats["queue_dropped"].values()):
        raise AssertionError(f"queues dropped events: {stats}")
    if stats["processed"] != {"M1": fed, "U1": fed, "U2": fed}:
        raise AssertionError(f"processed counts wrong: {stats['processed']}")
    if sums.max() >= 2**24:
        raise AssertionError("a lane sum reached 2**24: f32 not exact")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")

    def check(name, got, want):
        missing = 0
        for k, row in zip(read_keys, got):
            if counts[k] == 0:
                if row is not None:
                    raise AssertionError(f"{name}: key {k} never fed")
                continue
            if row is None:
                missing += 1
                continue
            if not np.array_equal(row["v"].numpy(),
                                  want[k].astype(np.float32)):
                raise AssertionError(f"{name}: key {k} reads "
                                     f"{row['v'].tolist()}, reference "
                                     f"{want[k].tolist()}")
        if missing and stats["table_dropped"][name] == 0:
            raise AssertionError(f"{name}: {missing} keys missing and no "
                                 "table drop counted")
        return missing

    miss_sum = check("U1", got_sum, sums)
    miss_max = check("U2", got_max, maxes)
    for k, (a, b) in single.items():
        for name, row, want in (("U1", a, sums), ("U2", b, maxes)):
            if counts[k] and row is not None and not np.array_equal(
                    row["v"].numpy(), want[k].astype(np.float32)):
                raise AssertionError(f"read_slate {name} {k} differs")
            if not counts[k] and row is not None:
                raise AssertionError(f"read_slate {name} {k}: never fed")

    # every slate in both tables, not just the read set
    n_seen = int((counts > 0).sum())
    for name, want in (("U1", sums), ("U2", maxes)):
        t = state["tables"][name]
        occ = t.keys[:C] != -1
        ks = t.keys[:C][occ].long().cpu().numpy()
        vals = t.vals["v"][:C][occ].cpu().numpy()
        if not np.array_equal(vals, want[ks].astype(np.float32)):
            raise AssertionError(f"{name}: table rows differ from the "
                                 "reference")
        lost = n_seen - ks.size
        if lost and stats["table_dropped"][name] == 0:
            raise AssertionError(f"{name}: {lost} keys lost, none counted")
        log(f"{name}: {ks.size} slates equal to the reference, {lost} of "
            f"{n_seen} fed keys dropped by the table (counted "
            f"{stats['table_dropped'][name]}); read set {read_keys.size} "
            f"keys, {miss_sum if name == 'U1' else miss_max} missing")
    profile_ticks(eng, state, source_fn, ticks, t_run / ticks)
    return launches


def profile_ticks(eng, state, source_fn, start, tick_s, n=8):
    """Where a tick's time goes: one chunk of ``n`` more ticks under
    torch.profiler — device busy time per tick (sum of kernel and copy
    time), device operations per tick, and the kernels that take most
    of the device time.  The idle share compares the busy time with the
    unprofiled tick time of the main run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(state, source_fn, n, source_offset=start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log(f"profile of {n} ticks: the profiler recorded no device "
            f"events (device busy time not measured)")
        return
    busy_us = sum(e.device_time_total for e in dev_events) / n
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile of {n} ticks: device busy {busy_us / 1e3:.4f} ms/tick, "
        f"{len(dev_events) / n:.1f} device operations/tick, profiled wall "
        f"{wall / n * 1e3:.3f} ms/tick; idle share against the unprofiled "
        f"{tick_s * 1e3:.3f} ms/tick: {1 - busy_us / 1e6 / tick_s:.4f}")
    for name, us in top:
        log(f"  {us / 1e3:.4f} ms/tick  {name[:100]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build(["slate_update", "slate_lookup"])
    log(f"built {sorted(libs)} with {_build.nvcc_path()} in "
        f"{time.perf_counter() - t0:.2f} s")

    entries = [check_slate_update(dev, args.seed),
               check_slate_lookup(dev, args.seed)]
    torch.cuda.empty_cache()
    check_no_host_sync(dev, args.seed)
    torch.cuda.empty_cache()
    launches = end_to_end(dev, args.ticks, args.seed, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
