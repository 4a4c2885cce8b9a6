"""Workflow graph: operators wired by streams (port of
``repro.core.workflow``; paper section 3, Figure 1).

A MapUpdate application is a directed graph (cycles allowed) whose nodes
are map/update functions and edges are streams.  The engine executes one
*tick* per step: every operator consumes from its input queue, produced
events land on subscriber queues for the next tick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.core.event import format_spec, spec_matches
from repro_torch.core.operators import Mapper, Operator, Updater


@dataclass
class Workflow:
    operators: Sequence[Operator]
    external_streams: Sequence[str] = ()   # fed by sources (never emitted
                                           # into by operators: throttle-safe)

    def __post_init__(self):
        names = [op.name for op in self.operators]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate operator names: {names}")
        self.by_name: Dict[str, Operator] = {op.name: op
                                             for op in self.operators}
        # stream -> subscriber operator names
        self.subscribers: Dict[str, List[str]] = {}
        for op in self.operators:
            for s in op.subscribes:
                self.subscribers.setdefault(s, []).append(op.name)
        self._validate()

    def _validate(self):
        produced = set(self.external_streams)
        for op in self.operators:
            produced.update(op.out_streams)
        for op in self.operators:
            for s in op.subscribes:
                if s not in produced:
                    raise ValueError(
                        f"operator {op.name!r} subscribes to stream {s!r} "
                        f"that nothing produces")
        for s in self.external_streams:
            for op in self.operators:
                if s in op.out_streams:
                    raise ValueError(
                        f"{op.name!r} emits into external stream {s!r}; "
                        "the paper forbids this (source-throttling "
                        "deadlock analysis, section 5)")
        # producer/subscriber spec agreement: a mismatch would otherwise
        # surface as an opaque dtype/shape error inside enqueue.  External
        # streams carry no declared spec — the subscriber's is
        # authoritative there.
        for prod in self.operators:
            for s, out_spec in prod.out_streams.items():
                for sub_name in self.subscribers.get(s, []):
                    sub = self.by_name[sub_name]
                    if not spec_matches(out_spec, sub.in_value_spec):
                        raise ValueError(
                            f"stream {s!r}: producer {prod.name!r} emits "
                            f"value_spec {format_spec(out_spec)} but "
                            f"subscriber {sub_name!r} expects "
                            f"{format_spec(sub.in_value_spec)} "
                            f"(in_value_spec)")

    # ---- helpers ----
    def updaters(self) -> List[Updater]:
        return [op for op in self.operators if isinstance(op, Updater)]

    def mappers(self) -> List[Mapper]:
        return [op for op in self.operators if isinstance(op, Mapper)]

    def dests_of(self, stream: str) -> List[str]:
        return self.subscribers.get(stream, [])

    def op_index(self, name: str) -> int:
        return [op.name for op in self.operators].index(name)
