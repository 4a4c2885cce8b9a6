"""Host-side span tracing + the control-plane JSONL log; a copy of
``repro.telemetry.trace``, which the port may not import.

``Tracer`` wraps the phases the drive loops already split — chunk
dispatch, WAL fence, flush begin/commit, telemetry observe,
reconfigure/migration, recovery restore/replay — into Chrome
trace-event JSON (``ph: "X"`` complete events).  ``Tracer.export``
writes a file that loads directly in Perfetto / ``chrome://tracing``.
The buffer is a bounded ring so tracing can stay on for long runs;
everything here is host wall-clock around calls the run loops make
anyway — no device syncs, no effect on the tick.

``ControlLog`` is the autoscaler's flight recorder: one JSON line per
observe→decide→act cycle (report summary, decision + reason, applied
action outcome), append-only so post-hoc analysis can replay exactly
what the controller saw and did.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np


def json_safe(v: Any) -> Any:
    """Best-effort conversion to JSON-serializable values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return json_safe(dataclasses.asdict(v))
    try:                                   # 0-d tensors etc.
        return v.item()
    except Exception:
        return str(v)


class Tracer:
    """Ring-buffered Chrome-trace span recorder (thread-safe)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "engine", **args):
        """Record a complete ("X") event around the block.  Yields the
        mutable args dict so outcomes measured inside the span (e.g. a
        migration's ``pause_s``) land on the span itself."""
        t0 = self._now_us()
        a: Dict[str, Any] = dict(args)
        try:
            yield a
        finally:
            self._push({"name": name, "cat": cat, "ph": "X",
                        "ts": t0, "dur": self._now_us() - t0,
                        "pid": 0,
                        "tid": threading.get_ident() % 100000,
                        "args": json_safe(a)})

    def instant(self, name: str, cat: str = "engine", **args):
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._now_us(), "pid": 0,
                    "tid": threading.get_ident() % 100000,
                    "args": json_safe(args)})

    def _push(self, ev: Dict[str, Any]):
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def spans(self, name: str) -> List[Dict[str, Any]]:
        """All recorded spans with the given name, oldest first."""
        return [e for e in self.events() if e["name"] == name]

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON (opens in Perfetto)."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def null_span(**args):
    """Stand-in for ``Tracer.span`` when tracing is off: yields the
    same mutable args dict, records nothing."""
    return _null_span(args)


@contextmanager
def _null_span(args):
    yield args


class ControlLog:
    """Append-only JSONL log of controller cycles (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def log(self, record: Dict[str, Any]):
        line = json.dumps(json_safe(record))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()
