"""Per-operator bounded event queues (ring buffers) + overflow policies
(port of ``repro.core.queues``).

Paper section 4.3 "Queue Overflow": when a worker's queue is full the
sender drops (+count), diverts to an overflow stream, or throttles the
source.  Capacities are static, so the policy applies at enqueue time.

Storage: ``buf`` holds ``capacity + 1`` rows.  Row ``capacity`` is a
hidden sink that masked scatters write to — the JAX package's
``mode="drop"`` scatter, kept fixed-shape with no boolean indexing (a
host sync on CUDA).  Nothing reads the sink; ``convert.state_to_numpy``
strips it.  ``enqueue`` / ``dequeue`` write into ``q.buf`` in place (the
JAX engine donates the state instead) and return the queue.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.event import (EventBatch, compact, register_dataclass,
                                    tree_map)


class OverflowPolicy(enum.Enum):
    DROP = "drop"
    OVERFLOW_STREAM = "overflow_stream"
    THROTTLE = "throttle"


@register_dataclass
@dataclass
class QueueState:
    buf: EventBatch            # capacity + 1 rows (last = sink)
    head: torch.Tensor         # int32 []
    size: torch.Tensor         # int32 []
    dropped: torch.Tensor      # int32 [] lifetime overflow count
    peak: torch.Tensor         # int32 [] high-water mark

    @property
    def capacity(self) -> int:
        return self.buf.capacity - 1


def make_queue(capacity: int, value_spec, key_dtype=torch.int32,
               device=None) -> QueueState:
    buf = EventBatch.empty(capacity + 1, value_spec, key_dtype=key_dtype,
                           device=device)
    z = lambda: torch.zeros((), dtype=torch.int32, device=buf.device)
    return QueueState(buf=buf, head=z(), size=z(), dropped=z(), peak=z())


def enqueue(q: QueueState, incoming: EventBatch
            ) -> Tuple[QueueState, EventBatch]:
    """Append valid events in place; returns (queue, overflowed_events).

    Overflowed events keep their validity so the engine can apply the
    operator's policy (drop-count / overflow stream / throttle signal).
    """
    inc = compact(incoming)
    B, Q = inc.capacity, q.capacity
    n = inc.count()
    space = torch.clamp(Q - q.size, min=0)
    ranks = torch.arange(B, dtype=torch.int32, device=inc.device)
    accept = inc.valid & (ranks < space)
    pos = (q.head + q.size + ranks) % Q
    safe_pos = torch.where(accept, pos, Q).long()    # sink row = dropped

    def put(dst, src):
        dst.index_put_((safe_pos,), src.to(dst.dtype))
        return dst

    buf = q.buf
    put(buf.sid, inc.sid)
    put(buf.ts, inc.ts)
    put(buf.key, inc.key)
    tree_map(put, buf.value, inc.value)
    put(buf.valid, accept)
    size = q.size + torch.minimum(n, space)
    overflowed = inc.mask(inc.valid & (ranks >= space))
    nq = QueueState(buf=buf, head=q.head, size=size, dropped=q.dropped,
                    peak=torch.maximum(q.peak, size))
    return nq, overflowed


def dequeue(q: QueueState, batch: int) -> Tuple[QueueState, EventBatch]:
    Q = q.capacity
    ranks = torch.arange(batch, dtype=torch.int32, device=q.head.device)
    take = ranks < torch.clamp(q.size, max=batch)
    idx = ((q.head + ranks) % Q).long()
    buf = q.buf
    out = EventBatch(
        sid=buf.sid[idx], ts=buf.ts[idx], key=buf.key[idx],
        value=tree_map(lambda a: a[idx], buf.value),
        valid=buf.valid[idx] & take,
    )
    n_taken = take.sum(dtype=torch.int32)
    # clear validity of consumed slots (hygiene for debugging)
    buf.valid.index_put_((torch.where(take, idx, Q),),
                         torch.zeros((), dtype=torch.bool, device=idx.device))
    nq = QueueState(buf=buf, head=(q.head + n_taken) % Q,
                    size=q.size - n_taken, dropped=q.dropped, peak=q.peak)
    return nq, out


def count_drop(q: QueueState, overflowed: EventBatch) -> QueueState:
    return QueueState(buf=q.buf, head=q.head, size=q.size,
                      dropped=q.dropped + overflowed.count(), peak=q.peak)
