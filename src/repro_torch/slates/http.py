"""Live slate reads over HTTP (paper section 4.4); a copy of
``repro.slates.http``, which the port may not import.

"Muppet provides a small HTTP server on each node for slate fetches...
The fetch retrieves the slate from Muppet's slate cache ... rather than
from the durable key-value store to ensure an up-to-date reply."

GET /slate/<updater>/<key>     -> JSON slate (from the device table)
GET /slates/<updater>?keys=a,b -> batched read: {"slates": {key: slate|null}}
GET /status                    -> engine stats JSON
GET /metrics                   -> Prometheus text exposition (0.0.4)

A read function that raises :class:`Unavailable` answers 503 (a read
queued for a drain that did not come in time, or after the handle
closed), one that raises :class:`BadRequest` 400.  With ``ticked=True``
every read function returns ``(value, source tick)`` and the tick goes
out as the ``X-Source-Tick`` header (a read served by a drain).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


def _jsonable(tree):
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


class Unavailable(RuntimeError):
    """A read the server cannot answer now: HTTP 503."""


class BadRequest(ValueError):
    """A read no engine can answer (a key outside its key type): 400."""


class NoServer:
    """What ``StateHandle.serve`` returns on a rank other than 0 of a
    process group: no server (``port`` None); rank 0 answers."""
    port = None

    def close(self):
        pass


class SlateServer:
    """Serves reads from a live engine; ``read_fn(updater, key)`` and
    ``stats_fn()`` are bound to the engine + its current state by the
    caller (which swaps the state reference every tick)."""

    def __init__(self, read_fn: Callable[[str, int], Any],
                 stats_fn: Callable[[], Any], port: int = 0,
                 read_many_fn: Optional[Callable[[str, list], list]]
                 = None,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 ticked: bool = False):
        handler = self._make_handler(read_fn, stats_fn, read_many_fn,
                                     metrics_fn, ticked)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _make_handler(read_fn, stats_fn, read_many_fn=None,
                      metrics_fn=None, ticked=False):
        def call(fn, *a):
            return fn(*a) if ticked else (fn(*a), None)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload, tick=None):
                self._send_text(code, json.dumps(payload),
                                "application/json", tick)

            def _send_text(self, code: int, text: str, ctype: str,
                           tick=None):
                raw = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                if tick is not None:
                    self.send_header("X-Source-Tick", str(tick))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                try:
                    if parts[:1] == ["status"]:
                        self._send(200, *call(stats_fn))
                    elif parts[:1] == ["metrics"]:
                        if metrics_fn is None:
                            self._send(404,
                                       {"error": "metrics not enabled"})
                        else:
                            text, tick = call(metrics_fn)
                            self._send_text(
                                200, text,
                                "text/plain; version=0.0.4; "
                                "charset=utf-8", tick)
                    elif len(parts) == 3 and parts[0] == "slate":
                        slate, tick = call(read_fn, parts[1], int(parts[2]))
                        if slate is None:
                            self._send(404, {"error": "no such slate"},
                                       tick)
                        else:
                            self._send(200, _jsonable(slate), tick)
                    elif len(parts) == 2 and parts[0] == "slates":
                        # batched read: one device dispatch for the
                        # whole key vector (the serving-rate path)
                        q = parse_qs(url.query).get("keys", [""])[0]
                        keys = [int(k) for k in q.split(",") if k]
                        if not keys:
                            self._send(400, {"error": "keys= required"})
                            return
                        if read_many_fn is not None:
                            slates, tick = call(read_many_fn, parts[1],
                                                keys)
                        else:       # engines without a batched path
                            slates = [call(read_fn, parts[1], k)[0]
                                      for k in keys]
                            tick = None
                        self._send(200, {"slates": {
                            str(k): (None if s is None else _jsonable(s))
                            for k, s in zip(keys, slates)}}, tick)
                    else:
                        self._send(404, {"error": "unknown path"})
                except Unavailable as e:
                    self._send(503, {"error": str(e)})
                except BadRequest as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # pragma: no cover
                    self._send(500, {"error": str(e)})
        return Handler

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
