"""Hot-key cache of the read tier (the ``HotKeyCache`` half of
``repro.slates.replica``, DESIGN.md section 15).

:class:`HotKeyCache` fronts the live read path (``StateHandle``) for
the keys the count-min telemetry sketch reports as heavy hitters: the
run loop warms the admission set from each window's ``heavy_hitters`` and
invalidates whole-sale whenever the flush frontier advances.  A bounded
LRU with optional wall-clock TTL; only admitted (hot) keys are stored,
so one scan of cold keys cannot evict the working set.

``SlateReplica`` (stale-bounded reads from flush-frontier snapshots)
reads the durable store and is ported with durability.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple


class HotKeyCache:
    """LRU/TTL cache admitting only telemetry-designated hot keys.

    ``warm(keys)`` swaps the admission set (the window's heavy
    hitters); ``put`` silently drops non-admitted keys.  ``get``
    returns ``(hit, value)`` so a cached ``None``-free design stays
    simple: misses and cold keys look identical to the caller, which
    falls through to the live read.  ``invalidate()`` clears entries
    but keeps the admission set (the keys are still hot; their values
    are merely suspect after a frontier advance).  Thread-safe.
    """

    def __init__(self, capacity: int = 256,
                 ttl_s: Optional[float] = None,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._clock = clock
        self._hot: set = set()
        self._entries: "OrderedDict[Tuple[str, int], Tuple[float, Any]]" \
            = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def warm(self, keys: Iterable[int]):
        """Replace the admission set with this window's heavy hitters."""
        with self._lock:
            self._hot = {int(k) for k in keys}

    def hot_keys(self) -> List[int]:
        with self._lock:
            return sorted(self._hot)

    def get(self, updater: str, key: int) -> Tuple[bool, Any]:
        k = (updater, int(key))
        with self._lock:
            ent = self._entries.get(k)
            if ent is not None:
                stamp, val = ent
                if self.ttl_s is None or \
                        self._clock() - stamp <= self.ttl_s:
                    self._entries.move_to_end(k)
                    self.hits += 1
                    return True, val
                del self._entries[k]        # TTL-expired
            self.misses += 1
            return False, None

    def put(self, updater: str, key: int, value: Any):
        with self._lock:
            if int(key) not in self._hot:
                return
            self._entries[(updater, int(key))] = (self._clock(), value)
            self._entries.move_to_end((updater, int(key)))
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def invalidate(self):
        """Drop every cached value (flush frontier advanced)."""
        with self._lock:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "hot_keys": len(self._hot),
                    "hits": self.hits, "misses": self.misses,
                    "invalidations": self.invalidations}
