"""Synthetic fast-data sources (port of ``repro.data.synthetic``).

- ``ZipfEventSource``: tweet/checkin-like events with Zipfian keys — the
  skew regime of paper section 5 ("the distribution of event keys can be
  strongly skewed") used by the hotspot benchmarks.  Its arrays come
  from numpy with the JAX package's generator calls, so a batch equals
  the JAX source's bitwise; it is built on ``device`` (default
  ``cuda``).
- ``TokenStream``: an endless tokenized text stream for LM training
  (synthetic Markovian corpus: deterministic, seedable, non-trivial
  next-token structure so training loss visibly falls).
- ``Prefetcher``: a host-side double buffer over any iterator.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.core.event import EventBatch


@dataclass
class ZipfEventSource:
    n_keys: int = 10_000
    alpha: float = 1.2            # zipf exponent (1.0 = heavy skew)
    payload_dim: int = 8
    seed: int = 0
    events_per_tick: int = 256
    device: Any = None            # None = cuda

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.n_keys + 1, dtype=np.float64)
        p = ranks ** (-self.alpha)
        self.p = p / p.sum()
        self._tick = 0

    def next_batch(self, max_events: Optional[int] = None) -> EventBatch:
        n = self.events_per_tick
        take = min(max_events, n) if max_events else n
        keys = self.rng.choice(self.n_keys, size=n, p=self.p
                               ).astype(np.int32)
        vals = self.rng.normal(size=(n, self.payload_dim)
                               ).astype(np.float32)
        valid = np.arange(n) < take
        ts = np.full(n, self._tick, np.int32)
        self._tick += 1
        return EventBatch.of(key=keys, value={"x": vals}, ts=ts,
                             valid=valid, device=self.device)


class TokenStream:
    """Markov-chain token stream: P(next | cur) concentrated on a few
    successors, so an LM can learn structure.  Infinite iterator of
    (tokens, labels) [B, S] numpy arrays."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, branching: int = 4):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        rng = np.random.default_rng(seed)
        self.succ = rng.integers(0, vocab_size,
                                 size=(vocab_size, branching)
                                 ).astype(np.int32)
        self.rng = rng

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, size=B)
        choices = self.rng.integers(0, self.succ.shape[1], size=(B, S))
        # 10% noise tokens break determinism
        noise = self.rng.random((B, S)) < 0.1
        rand_tok = self.rng.integers(0, self.vocab, size=(B, S))
        for t in range(S):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Host-side double-buffered prefetch with bounded skip-ahead: if the
    consumer falls behind (straggler host), up to ``max_skip`` batches are
    dropped instead of stalling the step loop."""

    def __init__(self, it: Iterator, depth: int = 2, max_skip: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._max_skip = max_skip
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                try:
                    self._q.put(item, timeout=5.0)
                except queue.Full:
                    if self._max_skip > 0:
                        self._max_skip -= 1
                        continue
                    self._q.put(item)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
