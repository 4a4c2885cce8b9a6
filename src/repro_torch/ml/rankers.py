"""Online rankers over streamed model outputs (port of
``repro.ml.rankers``; DESIGN.md section 16.2).

``SemanticTopK`` — per-key top-k by model score as an *associative*
updater with a real elementwise-max combine, so it rides the fused
``kernels/slate_update`` path (its max monoid: packed f32 lanes, an
in-place scatter), stays durable through the flush/WAL machinery
unchanged, and remains hot-key-splittable (max is commutative,
associative, and idempotent — partial merges and at-least-once replay
are exact, not approximate).

The slate is a slotted max-sketch: item ids hash to one of ``n_slots``
columns; each column holds one f32 word packing
``quantized_score * 2^ITEM_BITS + (item mod 2^ITEM_BITS)`` — score in
the high bits so elementwise max keeps, per column, the best-scoring
item seen.  SCORE_BITS + ITEM_BITS <= 24 keeps every word exact in a
f32 lane (the packing contract, ``core/packing.py``).  Two items
hashing to one column keep only the better one — sketch semantics, the
price of an O(1)-merge top-k; scores are quantized to SCORE_BITS by
construction.  Because f32 max is order-independent, fused vs generic
execution is *bitwise* identical; from equal scores the words equal the
JAX package's bitwise (every step of :func:`pack_word` is exact in
f32).

``Personalization`` — per-user EMA embedding + re-scored candidate
slate.  Order-sensitive (the EMA and the rescoring depend on arrival
order), so it runs on the sequential padded-run path; its slate carries
a wide ``[k, D]`` float leaf — the wide-value case the packing/flush
layers must round-trip.  Its step is written batched over key runs (the
port's ``SequentialUpdater`` contract); row by row it is the JAX
package's step.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.operators import AssociativeUpdater, SequentialUpdater

SCORE_BITS = 14   # score quantization levels (high bits)
ITEM_BITS = 10    # item id space per packed word (low bits)
# SCORE_BITS + ITEM_BITS <= 24: packed words stay exact in f32 lanes


def pack_word(score, item):
    """(score in [0,1), item id) -> nonneg f32-exact word; elementwise
    max over words ranks by quantized score, tie-broken by item id."""
    q = torch.clamp(torch.floor(score * (1 << SCORE_BITS)), 0.0,
                    float((1 << SCORE_BITS) - 1))
    low = (item & ((1 << ITEM_BITS) - 1)).to(torch.float32)
    return q * (1 << ITEM_BITS) + low


def unpack_word(word: float) -> Tuple[int, float]:
    """Packed word -> (item id mod 2^ITEM_BITS, quantized score)."""
    w = int(word)
    return w & ((1 << ITEM_BITS) - 1), (w >> ITEM_BITS) / (1 << SCORE_BITS)


class SemanticTopK(AssociativeUpdater):
    """Per-key top-k (item, model score) as an elementwise-max slate.

    Score per event, in ranking priority: ``score_fn(value) -> [B]``,
    else ``value[score_field]``, else the default embedding score
    ``sigmoid(mean(value[emb_field]))`` — all expected in [0, 1).
    Item ids must be positive (0 marks an empty column on read).
    """

    monoid = "max"

    def __init__(self, name: str = "semantic_topk", *, k: int = 8,
                 n_slots: int = 32, item_field: str = "item",
                 emb_field: str = "emb",
                 score_field: Optional[str] = None, score_fn=None,
                 table_capacity: int = 4096, ttl: int = 0):
        if k > n_slots:
            raise ValueError(f"k={k} > n_slots={n_slots}")
        self.name = name
        self.k = int(k)
        self.n_slots = int(n_slots)
        self.item_field = item_field
        self.emb_field = emb_field
        self.score_field = score_field
        self.score_fn = score_fn
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.subscribes = ()
        self.out_streams = {}

    def slate_spec(self):
        return {"cells": ((self.n_slots,), torch.float32)}

    def scores(self, value):
        """The score of each event of a batch's ``value``, [B] f32."""
        if self.score_fn is not None:
            return self.score_fn(value)
        if self.score_field is not None:
            return value[self.score_field].to(torch.float32)
        return torch.sigmoid(
            value[self.emb_field].to(torch.float32).mean(dim=-1))

    def lift(self, batch):
        item = batch.value[self.item_field].to(torch.int32)
        word = pack_word(self.scores(batch.value), item)     # [B]
        col = torch.remainder(item, self.n_slots)
        slots = torch.arange(self.n_slots, dtype=torch.int32,
                             device=item.device)
        hot = col[:, None] == slots[None, :]
        return {"cells": torch.where(hot, word[:, None], 0.0)}

    def combine(self, a, b):
        return {"cells": torch.maximum(a["cells"], b["cells"])}

    merge = combine

    # ---- host-side read path ----
    def top(self, slate, k: Optional[int] = None
            ) -> List[Tuple[int, float]]:
        """Slate row -> [(item, score)] best-first (item ids are modulo
        2^ITEM_BITS; empty columns are skipped)."""
        cells = np.asarray(slate["cells"])
        out = []
        for w in sorted(cells, reverse=True)[:(k or self.k)]:
            if w <= 0:
                break
            out.append(unpack_word(w))
        return out


class Personalization(SequentialUpdater):
    """Per-user slate: EMA user embedding + re-scored candidate items.

    Each event carries an item id (> 0) and its model embedding
    ``[D]``.  The step folds the embedding into the user's EMA profile,
    then re-scores the stored candidates *plus* the new item against
    the updated profile (dot product) and keeps the top ``k`` — so
    earlier candidates are re-ranked as the user's taste drifts.
    Duplicate item arrivals replace their old entry.
    """

    def __init__(self, name: str = "personalization", *, d: int,
                 k: int = 4, alpha: float = 0.2,
                 item_field: str = "item", emb_field: str = "emb",
                 table_capacity: int = 4096, ttl: int = 0,
                 max_run: int = 32):
        self.name = name
        self.d = int(d)
        self.k = int(k)
        self.alpha = float(alpha)
        self.item_field = item_field
        self.emb_field = emb_field
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.max_run = max_run
        self.subscribes = ()
        self.out_streams = {}

    def slate_spec(self):
        return {"user": ((self.d,), torch.float32),
                "items": ((self.k,), torch.int32),
                "cand": ((self.k, self.d), torch.float32),   # wide leaf
                "scores": ((self.k,), torch.float32),
                "n": ((), torch.int32)}

    def step(self, slates, ev):
        """One event for each of R key runs: slates and ``ev`` leaves
        lead with R."""
        emb = ev["value"][self.emb_field].to(torch.float32)      # [R, D]
        item = ev["value"][self.item_field].to(torch.int32)      # [R]
        first = (slates["n"] == 0)[:, None]
        user = torch.where(first, emb, (1.0 - self.alpha) * slates["user"]
                           + self.alpha * emb)
        cand = torch.cat([slates["cand"], emb[:, None]], 1)   # [R, k+1, D]
        items = torch.cat([slates["items"], item[:, None]], 1)  # [R, k+1]
        stored = torch.arange(self.k + 1, device=emb.device) < self.k
        # a re-seen item drops its stored copy in favor of the new one
        live = (items > 0) & ~((items == item[:, None]) & stored)
        dots = (cand @ user[:, :, None])[..., 0]                # [R, k+1]
        scores = torch.where(live, dots, -torch.inf)
        order = torch.argsort(-scores, dim=-1, stable=True)[:, :self.k]
        top = torch.gather(scores, 1, order)
        sel = torch.isfinite(top)
        picked = torch.gather(cand, 1, order[..., None].expand(
            -1, -1, self.d))
        new = {
            "user": user,
            "items": torch.where(sel, torch.gather(items, 1, order), 0),
            "cand": torch.where(sel[..., None], picked, 0.0),
            "scores": torch.where(sel, top, 0.0),
            "n": slates["n"] + 1,
        }
        return new, {}

    # ---- host-side read path ----
    def ranked(self, slate) -> List[Tuple[int, float]]:
        items = np.asarray(slate["items"])
        scores = np.asarray(slate["scores"])
        return [(int(i), float(s)) for i, s in zip(items, scores)
                if i > 0]


def semantic_topk(name: str = "semantic_topk", **kw) -> SemanticTopK:
    return SemanticTopK(name, **kw)


def personalization(name: str = "personalization", **kw
                    ) -> Personalization:
    return Personalization(name, **kw)
