"""Updater execution paths (port of ``repro.core.apply``).

- ``apply_associative``: sort by key -> segmented scan pre-combines every
  key's events into one delta -> one slate gather/merge/scatter.
  Updaters declaring ``sum_mergeable`` (or ``monoid="max"``) and no
  output streams take the fused route instead: deltas and the slate
  table are packed into [B, D] / [C, D] f32 buffers
  (``core/packing.py``) and the whole combine + scatter is one
  ``kernels/slate_update`` call, in place.

- ``apply_sequential``: sort by (key, ts) -> padded-run scan keeping the
  paper's strict per-key timestamp order; run tails beyond ``max_run``
  are deferred back to the caller (re-queued next tick).

Tables are updated in place (the JAX engine donates them instead).  No
function here reads a value back to the host, so a tick is enqueued on
the card without a sync.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch._device import torch_dtype
from repro_torch.core import packing
from repro_torch.core.event import EventBatch, flatten_sorted, tree_map
from repro_torch.core.operators import AssociativeUpdater, SequentialUpdater
from repro_torch.kernels.slate_update import ops as slate_ops
from repro_torch.kernels.slate_update import ref as slate_ref
from repro_torch.slates import table as tbl


def _bshape(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _last_valid_of_run(key, valid):
    """Per-key write point: the last *valid* row of each sorted run.

    Invalid rows carry the sink key (the key dtype's max) and sort behind
    valid rows; a genuine event with that key shares the sink run, so the
    run's write point is its last valid row."""
    next_key = torch.cat([key[1:], torch.full((1,), -3, dtype=key.dtype,
                                              device=key.device)])
    next_valid = torch.cat([valid[1:], torch.zeros(1, dtype=torch.bool,
                                                   device=valid.device)])
    return (key != next_key) | (valid & ~next_valid)


def _segmented_combine(updater, deltas, boundary):
    """Inclusive segmented scan: each row ends up holding the combine of
    its run's prefix; run-last rows hold run totals.

    ``lax.associative_scan`` becomes a Hillis-Steele doubling scan over
    the user's ``combine``: at step ``sh`` row i takes
    ``op(x[i - sh], x[i])`` with the segmented operator
    ``op((fa, va), (fb, vb)) = (fa | fb, vb if fb else combine(va, vb))``.
    Exact for integer and max monoids; float sums may round in another
    order than the JAX scan."""
    flags = boundary
    vals = deltas
    B = boundary.shape[0]
    sh = 1
    while sh < B:
        prev = tree_map(lambda v: v[:-sh], vals)
        cur = tree_map(lambda v: v[sh:], vals)
        combined = updater.combine(prev, cur)
        f_cur = flags[sh:]
        new_tail = tree_map(
            lambda c, y: torch.where(_bshape(f_cur, y), y, c.to(y.dtype)),
            combined, cur)
        vals = tree_map(lambda v, t: torch.cat([v[:sh], t]), vals, new_tail)
        flags = torch.cat([flags[:sh], flags[:-sh] | f_cur])
        sh *= 2
    return vals


def merge_monoid(updater: AssociativeUpdater) -> str:
    """The elementwise monoid the fused path may run this updater under:
    "sum" (``sum_mergeable`` or ``monoid="sum"``), "max" (``monoid="max"``,
    non-negative leaves), or "" (generic combine — fused path
    ineligible)."""
    if getattr(updater, "sum_mergeable", False):
        return "sum"
    return getattr(updater, "monoid", "") or ""


def fused_eligible(updater: AssociativeUpdater) -> bool:
    """The fused path handles updaters whose combine/merge are a monoid
    the kernel implements (sum or non-negative max) and that emit
    nothing."""
    return (merge_monoid(updater) in ("sum", "max")
            and not updater.out_streams)


def apply_associative(updater: AssociativeUpdater, table: tbl.SlateTable,
                      batch: EventBatch, tick, *, impl: str = "auto"
                      ) -> Tuple[tbl.SlateTable, Dict[str, EventBatch],
                                 torch.Tensor]:
    """Returns (table, emissions, n_processed).

    ``impl`` selects the backend for ``fused_eligible`` updaters:
      - "off":  always the generic scan/gather/merge/scatter below
      - "auto": the fused path — the CUDA kernel for a CUDA table, the
        ``ref`` backend for a CPU table.  (The JAX package's "auto"
        keeps the generic path off the TPU; here the kernel exists on
        the target device.)
      - "cuda": force the kernel (packed [C, D] table, in place)
      - "jnp":  segment totals + direct scatter into the slate leaves, no
        table pack (the JAX package's portable fused fallback)
      - "ref":  the packed-table plain oracle
        (``kernels/slate_update/ref``), same layout as the kernel
    """
    if impl != "off" and fused_eligible(updater):
        return _apply_associative_fused(updater, table, batch, tick,
                                        impl=impl)
    batch = batch.sort_by_key_ts()
    key = batch.key
    prev_key = torch.cat([torch.full((1,), -2, dtype=key.dtype,
                                     device=key.device), key[:-1]])
    boundary = key != prev_key                       # run starts
    run_last = _last_valid_of_run(key, batch.valid)  # run totals live here

    deltas = updater.lift(batch)
    scanned = _segmented_combine(updater, deltas, boundary)

    unique = run_last & batch.valid
    table, slot, found, placed = tbl.insert_or_find(table, key, unique)
    ok = unique & placed
    old = tbl.read_slates(table, slot, found & ok, updater.init_slate)
    new = updater.merge(old, scanned)
    table = tbl.write_slates(table, slot, ok, new, tick)

    emissions = updater.emit(key, old, new, batch.ts)
    emissions = {s: eb.mask(ok) for s, eb in emissions.items()}
    return table, emissions, batch.count()


def _apply_associative_fused(updater: AssociativeUpdater,
                             table: tbl.SlateTable, batch: EventBatch,
                             tick, *, impl: str
                             ) -> Tuple[tbl.SlateTable,
                                        Dict[str, EventBatch],
                                        torch.Tensor]:
    """Counter-style hot path: pack deltas/table to [B, D] / [C, D] f32
    and run the fused segmented combine + in-place scatter.  Exact for
    the max monoid; for sum, exact under the counter contract (integer
    values in f32 lanes) and equal up to f32 summation order
    otherwise."""
    op = merge_monoid(updater)
    batch = batch.sort_by_key_ts()
    key = batch.key                       # invalid rows sorted to sink
    run_last = _last_valid_of_run(key, batch.valid)
    unique = run_last & batch.valid

    spec = packing.pack_spec(updater.slate_spec())
    deltas = updater.lift(batch)
    # invalid rows sharing the sink run with a genuine max-valued key must
    # contribute the identity — zero for sum, and zero again for max
    # thanks to the non-negative contract
    deltas = tree_map(
        lambda d: torch.where(_bshape(batch.valid, d), d,
                              torch.zeros((), dtype=d.dtype,
                                          device=d.device)), deltas)
    if (flatten_sorted(deltas)[1]
            != flatten_sorted(updater.slate_spec(), is_leaf=_is_spec_leaf)[1]):
        raise TypeError(
            f"sum_mergeable updater {updater.name!r}: lift() pytree must "
            "match slate_spec() structure for the packed path")
    table, slot, found, placed = tbl.insert_or_find(table, key, unique)
    ok = unique & placed
    C = table.capacity
    # -1 = no write; int32, the kernel's index width (the JAX package's)
    slots = torch.where(ok, slot, -1).to(torch.int32)
    safe = torch.where(ok, slot, C)                       # C = sink row

    # Newly placed keys may land in a slot freed by expire_ttl, which
    # clears the key but keeps the dead occupant's vals; the generic path
    # masks them out via read_slates' init_slate substitution, the
    # additive path must zero them before the add.
    safe_fresh = torch.where(ok & ~found, slot, C)
    tree_map(lambda tv: tbl.fill_rows(tv, safe_fresh, 0), table.vals)

    backend = impl
    if backend == "auto":
        backend = "cuda" if key.is_cuda else "ref"
    if backend == "jnp":
        # one segment reduce, then scatter run totals into the slate
        # leaves directly — no [C, D] table pack and no lane padding
        packed_deltas = packing.pack(deltas, spec, pad=False)
        totals = slate_ref.run_totals(key, packed_deltas, op=op)  # [B, D]
        total_tree = packing.unpack(totals, spec)          # [B, ...]
        if op == "max":
            def put(tv, dv):
                idx = _bshape(safe, dv).expand_as(dv)
                tv.scatter_reduce_(0, idx, dv.to(tv.dtype), "amax")
        else:
            def put(tv, dv):
                tv.index_put_((safe,), dv.to(tv.dtype), accumulate=True)
        tree_map(put, table.vals, total_tree)
    elif backend in ("cuda", "ref"):
        packed_deltas = packing.pack(deltas, spec)        # [B, D] aligned
        packed_vals = packing.pack(table.vals, spec)      # [C+1, D]
        packed_vals = slate_ops.slate_update(key, packed_deltas, slots,
                                             packed_vals, impl=backend,
                                             op=op)
        new_vals = packing.unpack(packed_vals, spec)
        # a single aligned f32 leaf was updated through a view; other
        # layouts copy the packed result back into the leaves
        tree_map(lambda tv, nv: tv if nv.data_ptr() == tv.data_ptr()
                 else tv.copy_(nv), table.vals, new_vals)
    else:
        raise ValueError(f"unknown fused backend {impl!r}")

    # bookkeeping scatter (ts / dirty), same slots write_slates would hit
    tbl.fill_rows(table.ts, safe, tick)
    tbl.fill_rows(table.dirty, safe, True)
    return table, {}, batch.count()


def apply_sequential(updater: SequentialUpdater, table: tbl.SlateTable,
                     batch: EventBatch, tick
                     ) -> Tuple[tbl.SlateTable, Dict[str, EventBatch],
                                EventBatch, torch.Tensor]:
    """Returns (table, emissions, deferred_events, n_processed).

    Deferred = valid events whose per-key run exceeded ``max_run`` this
    tick (hotspot backpressure); the engine re-queues them.  The JAX
    package vmaps ``updater.step`` over key runs; here ``step`` takes all
    runs' rows at once (see ``SequentialUpdater``)."""
    batch = batch.sort_by_key_ts()
    B = batch.capacity
    dev = batch.device
    key, valid = batch.key, batch.valid
    first_idx = torch.searchsorted(key, key, side="left")
    idx_all = torch.arange(B, dtype=torch.int64, device=dev)
    pos = idx_all - first_idx
    run_start = (pos == 0) & valid
    in_budget = pos < updater.max_run
    deferred = batch.mask(valid & ~in_budget)

    table, slot, found, placed = tbl.insert_or_find(table, key, run_start)
    ok = run_start & placed
    slates = tbl.read_slates(table, slot, found & ok, updater.init_slate)

    # emission accumulators at sorted-row granularity, one sink row (B)
    out_specs = updater.out_streams
    em_vals = {s: tree_map(
        lambda sp: torch.zeros((B + 1,) + tuple(sp[0]),
                               dtype=torch_dtype(sp[1]), device=dev),
        spec, is_leaf=_is_spec_leaf) for s, spec in out_specs.items()}
    em_keys = {s: torch.zeros(B + 1, dtype=key.dtype, device=dev)
               for s in out_specs}
    em_flag = {s: torch.zeros(B + 1, dtype=torch.bool, device=dev)
               for s in out_specs}

    for j in range(updater.max_run):
        idx = (idx_all + j).clamp(0, B - 1)
        active = (ok & (idx_all + j < B) & (key[idx] == key) & valid[idx])
        ev = {
            "sid": batch.sid[idx], "ts": batch.ts[idx], "key": key[idx],
            "value": tree_map(lambda a: a[idx], batch.value),
        }
        new_slates, emits = updater.step(slates, ev)
        slates = tree_map(
            lambda n, o: torch.where(_bshape(active, n), n.to(o.dtype), o),
            new_slates, slates)
        for s in out_specs:
            if s not in emits:
                continue
            row = emits[s]
            emit = row["emit"]
            if isinstance(emit, torch.Tensor):
                flag = emit.expand(B) & active
            else:   # a Python bool for every row
                flag = active if emit else torch.zeros_like(active)
            safe = torch.where(flag, idx, B)
            tree_map(lambda acc, v: acc.index_put_((safe,), v.to(acc.dtype)),
                     em_vals[s], row["value"])
            em_keys[s].index_put_((safe,), row["key"].to(key.dtype))
            tbl.fill_rows(em_flag[s], safe, True)

    table = tbl.write_slates(table, slot, ok, slates, tick)

    emissions = {}
    for s in out_specs:
        emissions[s] = EventBatch(
            sid=torch.zeros(B, dtype=torch.int32, device=dev),
            ts=batch.ts + 1,
            key=em_keys[s][:B],
            value=tree_map(lambda a: a[:B], em_vals[s]),
            valid=em_flag[s][:B],
        )
    n_proc = (valid & in_budget).sum(dtype=torch.int32)
    return table, emissions, deferred, n_proc


def _is_spec_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
