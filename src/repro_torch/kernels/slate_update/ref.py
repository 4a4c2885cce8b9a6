"""Plain PyTorch version of the fused slate update (the CPU path and the
kernel's oracle)."""
from __future__ import annotations

import torch


def _segments(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Run ids (0-based) of a sorted key vector."""
    seg_start = torch.ones_like(keys_sorted, dtype=torch.bool)
    seg_start[1:] = keys_sorted[1:] != keys_sorted[:-1]
    return torch.cumsum(seg_start.to(torch.int64), 0) - 1


def run_totals(keys_sorted, deltas, *, op: str = "sum") -> torch.Tensor:
    """[B] sorted keys + [B, D] deltas -> [B, D] f32 where every row
    holds its run's total.  ``op`` is "sum" (segment sum) or "max"
    (segment max over the non-negative domain: 0 is the identity, as
    the JAX oracle's ``maximum(segment_max, 0)``)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown run_totals op {op!r}")
    seg = _segments(keys_sorted)
    d = deltas.to(torch.float32)
    totals = torch.zeros_like(d)
    if op == "max":
        totals.scatter_reduce_(0, seg[:, None].expand_as(d), d, "amax")
    else:
        totals.index_add_(0, seg, d)
    return totals[seg]


def run_prefixes(keys_sorted, deltas, *, op: str = "sum") -> torch.Tensor:
    """[B] sorted keys + [B, D] deltas -> [B, D] f32 where every row holds
    the inclusive prefix of its run: the segmented doubling scan of the
    TPU kernel (step ``2**k`` folds row ``i - 2**k`` into row ``i`` when
    both lie in one run).  "max" combines over the non-negative domain
    (0 is the identity).  A run-last row holds its run's total."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown run_prefixes op {op!r}")
    d = deltas.to(torch.float32)
    d = torch.clamp(d, min=0.0) if op == "max" else d.clone()
    B, sh = d.shape[0], 1
    while sh < B:
        same = (keys_sorted[sh:] == keys_sorted[:-sh])[:, None]
        comb = torch.maximum(d[sh:], d[:-sh]) if op == "max" \
            else d[sh:] + d[:-sh]
        d = torch.cat([d[:sh], torch.where(same, comb, d[sh:])])
        sh *= 2
    return d


def slate_update(keys_sorted, deltas, slots, table_vals, *,
                 op: str = "sum") -> torch.Tensor:
    """The inclusive prefix of each slotted row's run (slot >= 0; the
    engine slots run-last rows, whose prefix is the run's total) merged
    into ``table_vals[slot]``: added for "sum", elementwise-maxed for
    "max".  Updates ``table_vals`` in place and returns it.

    Only rows with a slot change the table, but a fixed-shape scatter
    (no host sync) writes every row somewhere.  So the rows with a slot
    are listed first, by prefix counts, and row j of that list writes
    what row ``j % n_ok`` writes: every address gets one value however
    many rows write it, and none more than ceil(B / n_ok) writes.  When
    no row has a slot, all write row 0's own value back."""
    prefix = run_prefixes(keys_sorted, deltas, op=op)
    B = slots.shape[0]
    ok = slots >= 0
    ok64 = ok.to(torch.int64)
    n_ok = ok64.sum()
    pos = torch.where(ok, torch.cumsum(ok64, 0) - 1,
                      n_ok + torch.cumsum(1 - ok64, 0) - 1)
    rows = torch.arange(B, device=slots.device)
    listed = torch.empty_like(rows).scatter_(0, pos, rows)
    src = listed[rows % n_ok.clamp(min=1)]
    writes = ok[src]
    idx = torch.where(writes, slots[src], 0)
    cur = table_vals[idx]
    total = prefix[src].to(table_vals.dtype)
    new = torch.maximum(cur, total) if op == "max" else cur + total
    table_vals.index_put_((idx,), torch.where(writes[:, None], new, cur))
    return table_vals
