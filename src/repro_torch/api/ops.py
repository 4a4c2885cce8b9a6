"""Prebuilt update combinators for the declarative builder (port of
``repro.api.ops``).

Each factory returns an :class:`~repro_torch.core.operators.Updater`
instance with its subscriptions and input spec left blank —
``Stream.update`` (or ``App.add``) wires those in, and the planner fills
``in_value_spec`` from the upstream stream's spec.  They are ordinary
operators: the subclass API can use them too by setting ``subscribes``
/ ``in_value_spec`` by hand.  ``Ema``'s step is written batched (all key
runs' rows at once), the port's ``SequentialUpdater`` contract.
"""
from __future__ import annotations

import torch

from repro_torch.core.operators import AssociativeUpdater, SequentialUpdater


class Counter(AssociativeUpdater):
    """Count events per key — the paper's Examples 1/4 update function.

    ``sum_mergeable`` by construction (all-adds, zero init), so the
    engine routes it through the fused ``kernels/slate_update`` path
    (its sum monoid).
    """

    def __init__(self, name: str = "counter", *, table_capacity: int = 4096,
                 ttl: int = 0, sum_mergeable: bool = True):
        self.name = name
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.sum_mergeable = sum_mergeable
        self.subscribes = ()
        self.out_streams = {}

    def slate_spec(self):
        return {"count": ((), torch.int32)}

    def lift(self, batch):
        return {"count": torch.ones_like(batch.key, dtype=torch.int32)}

    def combine(self, a, b):
        return {"count": a["count"] + b["count"]}

    def merge(self, slate, delta):
        return {"count": slate["count"] + delta["count"]}


class TopK(AssociativeUpdater):
    """Keep the k largest values of ``field`` seen per key.

    Top-k is a commutative monoid (merge two sorted top-k lists, keep
    the k largest), so it rides the associative pre-combine path.
    """

    def __init__(self, k: int, field: str = "x", name: str = "topk", *,
                 table_capacity: int = 4096, ttl: int = 0):
        self.k = k
        self.field = field
        self.name = name
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.subscribes = ()
        self.out_streams = {}

    def slate_spec(self):
        return {"top": ((self.k,), torch.float32)}

    def init_slate(self, n: int, device=None):
        return {"top": torch.full((n, self.k), -torch.inf,
                                  dtype=torch.float32, device=device)}

    def _merge_top(self, a, b):
        cat = torch.cat([a, b], dim=-1)
        return -torch.sort(-cat, dim=-1).values[..., :self.k]

    def lift(self, batch):
        x = batch.value[self.field].to(torch.float32)
        pad = torch.full(x.shape + (self.k - 1,), -torch.inf,
                         dtype=torch.float32, device=x.device)
        return {"top": torch.cat([x[..., None], pad], dim=-1)}

    def combine(self, a, b):
        return {"top": self._merge_top(a["top"], b["top"])}

    def merge(self, slate, delta):
        return {"top": self._merge_top(slate["top"], delta["top"])}


class Ema(SequentialUpdater):
    """Exponential moving average of ``field`` per key.

    Order-sensitive (the bump depends on the running value), so it runs
    on the strict per-key-timestamp-order padded-run path.
    """

    def __init__(self, alpha: float = 0.1, field: str = "x",
                 name: str = "ema", *, table_capacity: int = 4096,
                 ttl: int = 0, max_run: int = 32):
        self.alpha = float(alpha)
        self.field = field
        self.name = name
        self.table_capacity = table_capacity
        self.ttl = ttl
        self.max_run = max_run
        self.subscribes = ()
        self.out_streams = {}

    def slate_spec(self):
        return {"ema": ((), torch.float32), "n": ((), torch.int32)}

    def step(self, slates, ev):
        x = ev["value"][self.field].to(torch.float32)
        first = slates["n"] == 0
        new = torch.where(first, x, (1.0 - self.alpha) * slates["ema"]
                          + self.alpha * x)
        return {"ema": new, "n": slates["n"] + 1}, {}


def counter(name: str = "counter", **kw) -> Counter:
    return Counter(name, **kw)


def topk(k: int, field: str = "x", name: str = "topk", **kw) -> TopK:
    return TopK(k, field, name, **kw)


def ema(alpha: float = 0.1, field: str = "x", name: str = "ema",
        **kw) -> Ema:
    return Ema(alpha, field, name, **kw)


# ---- streaming-ML stages (repro_torch/ml, DESIGN.md section 16) ----
# imported lazily: repro_torch.ml pulls in the model stack, which apps
# that only count and rank plain fields should not pay for

def model_mapper(cfg, params=None, **kw):
    """:class:`repro_torch.ml.ModelMapper` — microbatched model inference
    as a mapper stage (FLOP-heavy tagged, output spec from ``bind``)."""
    from repro_torch.ml.mapper import ModelMapper
    return ModelMapper(cfg, params, **kw)


def semantic_topk(name: str = "semantic_topk", **kw):
    """:class:`repro_torch.ml.SemanticTopK` — per-key top-k by model
    score on the fused elementwise-max slate path."""
    from repro_torch.ml.rankers import SemanticTopK
    return SemanticTopK(name, **kw)


def personalization(name: str = "personalization", **kw):
    """:class:`repro_torch.ml.Personalization` — per-user EMA embedding +
    re-scored candidate slate (sequential path)."""
    from repro_torch.ml.rankers import Personalization
    return Personalization(name, **kw)
