"""MapUpdate operators (port of ``repro.core.operators``).

The paper's ``map(event) -> event*`` and ``update(event, slate) ->
event*`` become vectorized operators over EventBatches.  Updaters come in
two flavors matching the engine's two execution paths (DESIGN.md
section 2):

- ``AssociativeUpdater``: declares ``lift / combine / merge`` so the
  engine can pre-combine same-key events with a segmented scan;
- ``SequentialUpdater``: declares ``step(slate, event)`` with strict
  per-key timestamp order, run as a padded-run scan.

User functions are written in torch on the batch's device.  Emissions
are shape-static: at most one event per input event per declared output
stream, masked by validity.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch._device import torch_dtype
from repro_torch.core.event import EventBatch, tree_map


class Operator:
    """Base: every operator subscribes to streams and has a unique name."""
    name: str = "op"
    subscribes: Sequence[str] = ()

    # value_spec of events this operator consumes: pytree of
    # ((shape_suffix, dtype)) leaves — needed to preallocate queues.
    in_value_spec: Dict[str, Any] = {}

    # stream -> value_spec this operator can emit to
    out_streams: Dict[str, Any] = {}


class Mapper(Operator):
    """Stateless.  ``map_batch`` runs torch ops on the batch's device and
    must respect ``batch.valid`` (emitted batches carry their own
    validity masks)."""

    def map_batch(self, batch: EventBatch) -> Dict[str, EventBatch]:
        raise NotImplementedError


class Updater(Operator):
    """Stateful: owns one slate per (updater, key) — paper section 3."""

    ttl: int = 0          # ticks; 0 = forever (paper's default)
    table_capacity: int = 4096   # slate-table capacity

    def slate_spec(self) -> Dict[str, Any]:
        """pytree of (shape_suffix, dtype) describing one slate."""
        raise NotImplementedError

    def init_slate(self, n: int, device=None):
        """Fresh slates for first-seen keys: pytree with leading dim n."""
        return tree_map(
            lambda s: torch.zeros((n,) + tuple(s[0]), dtype=torch_dtype(s[1]),
                                  device=device),
            self.slate_spec(), is_leaf=_is_spec_leaf)


class AssociativeUpdater(Updater):
    """update is a commutative monoid over per-event deltas.

    Engine contract:
      total_k = combine(lift(e_1), ..., lift(e_m))   for key k's events
      slate_k' = merge(slate_k, total_k)
      emit(keys, old, new, ts) -> optional events (<=1 per key per stream)

    ``sum_mergeable`` (DESIGN.md section 2.3, the counter contract):
    ``combine`` and ``merge`` add every leaf elementwise, a fresh slate
    is all zeros, and leaf values stay exact in f32 lanes (|v| < 2**24
    for integers).  Such updaters take the fused ``kernels/slate_update``
    path.  ``monoid="max"`` is the same contract with elementwise
    maximum over non-negative leaves.  Leave ``monoid`` "" for a general
    combine.
    """

    sum_mergeable: bool = False
    monoid: str = ""

    def lift(self, batch: EventBatch):
        """EventBatch -> delta pytree with leading dim B."""
        raise NotImplementedError

    def combine(self, d1, d2):
        """Elementwise-batched associative combine of two delta pytrees."""
        raise NotImplementedError

    def merge(self, slate, delta):
        """Fold combined delta into slate (batched over keys)."""
        raise NotImplementedError

    def emit(self, keys, old_slate, new_slate, ts) -> Dict[str, EventBatch]:
        return {}


class SequentialUpdater(Updater):
    """General update function: strict per-key arrival order.

    ``step(slates, ev)`` consumes one event for each of a batch of keys:
    ``slates`` is a slate pytree with leading dim R (one row per key run)
    and ``ev`` a dict(sid, ts, key, value) of [R]-leading rows.  The JAX
    package writes ``step`` for one row and vmaps it; the port takes the
    rows batched, so ``step`` is written with the batch dimension
    explicit.  Returns (new_slates, emissions) where emissions is
    {stream: {"key": [R], "value": pytree [R, ...], "emit": bool [R]}}.
    """

    max_run: int = 32     # static per-key events per tick (hotspot bound)

    def step(self, slates, ev) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError


def _is_spec_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
