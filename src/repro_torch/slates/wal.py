"""Write-ahead log of source event batches (port of ``repro.slates.wal``).

Paper section 4.3: "Developing a replay capability to recover the lost
events in the queue is a subject of future work."  The JAX package's
answer, kept here byte for byte: the ingest path appends every tick's
source batches to a log of tagged frames; after a crash, ``replay``
re-feeds the batches from the last flush frontier.  Associative
updaters make replay exactly-once-by-merge when combined with slate
snapshots at flush boundaries (DESIGN.md section 10).

Format (shared with the JAX package, so either replays the other's
log): a header ``MWH1`` + u64 logical base offset, then records of
``MWAL`` + u32 length + a tagged frame (``slates._compress``) of the
msgpack map ``{"tick": t, "src": {stream: {"sid", "ts", "key",
"valid": array, "value": {leaf path: array}}}}``, each array as
``{b"d": bytes, b"t": numpy dtype str, b"s": shape}``.  Offsets are
*logical*: a record's offset survives ``truncate_before`` (the header
records the logical offset of the first record kept), so a flush
frontier's ``wal_offset`` stays valid after the log is compacted.
Files without a header read back with base offset 0.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.event import EventBatch
from repro_torch.slates import _compress
from repro_torch.slates import _msgpack as msgpack

_MAGIC = b"MWAL"
_HDR_MAGIC = b"MWH1"
_HDR_LEN = 12           # magic + u64 logical base offset


def _enc(a):
    """An array (numpy, or a tensor: copied to the host if it is on a
    card) as the log's array map."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return {b"d": a.tobytes(), b"t": a.dtype.str, b"s": list(a.shape)}


def _dec(e) -> torch.Tensor:
    a = np.frombuffer(e[b"d"], np.dtype(e[b"t"])).reshape(e[b"s"])
    return torch.from_numpy(a.copy())


class WriteAheadLog:
    """Append-only log of ``(tick, {stream: EventBatch})`` records.

    ``append`` returns the logical end offset after the record — the
    replay point for a frontier recorded *after* that tick.  ``sync=True``
    fsyncs every append (durable against power loss, slower); the default
    flushes to the OS (durable against a process crash, the failure model
    of the recovery tests).
    """

    def __init__(self, path: str, *, sync: bool = False,
                 level: Optional[int] = None, read_only: bool = False):
        self.path = path
        self.sync = sync
        if read_only:
            # a reader of a log another process owns (a multi-rank
            # engine's recovery): no header, no trim, no append handle
            self._cctx, self._dctx = None, _compress.Decompressor()
            self._base, self._hdr_len = self._read_header()
            self._f = None
            self._end = self._base + max(0, (os.path.getsize(path) if
                                             os.path.exists(path) else 0)
                                         - self._hdr_len)
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # append sits on the ingest path: zstd-1 where zstandard is
        # installed, raw frames under the zlib fallback.  Frames are
        # tagged, so a log written at one level replays anywhere.
        if level is None:
            level = 1 if _compress.HAVE_ZSTD else 0
        self._cctx = _compress.Compressor(level=level)
        self._dctx = _compress.Decompressor()
        self._base, self._hdr_len = self._read_header()
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "wb") as f:
                f.write(_HDR_MAGIC + struct.pack("<Q", 0))
            self._base, self._hdr_len = 0, _HDR_LEN
        self._trim_torn_tail()
        self._f = open(path, "ab")
        self._end = self._base + os.path.getsize(path) - self._hdr_len

    # ---- offsets ----
    def _read_header(self) -> Tuple[int, int]:
        """(logical base offset, physical header length)."""
        if not os.path.exists(self.path):
            return 0, 0
        with open(self.path, "rb") as f:
            head = f.read(_HDR_LEN)
        if len(head) >= _HDR_LEN and head[:4] == _HDR_MAGIC:
            return struct.unpack("<Q", head[4:12])[0], _HDR_LEN
        return 0, 0   # headerless file

    def _trim_torn_tail(self):
        """Cut a half-written record left by a crash mid-append, so the
        next append starts on a clean boundary."""
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            f.seek(self._hdr_len)
            good = self._hdr_len
            while True:
                hdr = f.read(8)
                if len(hdr) < 8 or hdr[:4] != _MAGIC:
                    break
                (n,) = struct.unpack("<I", hdr[4:])
                if f.seek(n, 1) > size or f.tell() > size:
                    break
                good = f.tell()
        if good < size:
            with open(self.path, "r+b") as f:
                f.truncate(good)

    @property
    def offset(self) -> int:
        """Logical end offset (replay point for 'everything from now'),
        tracked as records are appended: the append path never stats."""
        return self._end

    # ---- write path ----
    def append(self, tick: int, sources: Dict[str, EventBatch]) -> int:
        """Log one tick's source batches (tensors on any device, or numpy
        arrays); returns the logical end offset."""
        payload = {}
        for stream, b in sources.items():
            payload[stream] = {
                "sid": _enc(b.sid), "ts": _enc(b.ts), "key": _enc(b.key),
                "valid": _enc(b.valid),
                "value": {k: _enc(v) for k, v in _flat(b.value)},
            }
        raw = self._cctx.compress(msgpack.packb({"tick": int(tick),
                                                 "src": payload}))
        self._f.write(_MAGIC + struct.pack("<I", len(raw)) + raw)
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
        self._end += 8 + len(raw)
        return self._end

    def close(self):
        if self._f is not None:
            self._f.close()

    # ---- compaction ----
    def truncate_before(self, offset: int):
        """Drop records wholly before logical ``offset`` (typically the
        flush frontier's wal_offset: those events are already in flushed
        slates and are never replayed).  Logical offsets of the records
        kept are unchanged."""
        if offset <= self._base:
            return
        end = self.offset
        if offset > end:
            raise ValueError(f"truncate offset {offset} beyond log end "
                             f"{end}")
        # frontier offsets come from append(), so they sit on record
        # boundaries; a mid-record offset drops the straddling record
        keep = []
        new_base = self._base
        for rec_off, rec_len, blob in self._iter_raw():
            if rec_off >= offset:
                keep.append(blob)
            else:
                new_base = rec_off + rec_len
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_HDR_MAGIC + struct.pack("<Q", new_base))
            for blob in keep:
                f.write(blob)
        os.replace(tmp, self.path)
        self._base, self._hdr_len = new_base, _HDR_LEN
        self._f = open(self.path, "ab")
        self._end = self._base + os.path.getsize(self.path) - _HDR_LEN

    # ---- read path ----
    def _iter_raw(self) -> Iterator[Tuple[int, int, bytes]]:
        """(logical offset, record length, raw record bytes) per record."""
        if self._f is not None:
            self._f.flush()
        elif not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            f.seek(self._hdr_len)
            off = self._base
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                if hdr[:4] != _MAGIC:
                    raise ValueError(f"corrupt WAL {self.path} at logical "
                                     f"offset {off}")
                (n,) = struct.unpack("<I", hdr[4:])
                body = f.read(n)
                if len(body) < n:
                    return   # torn tail (crash mid-append): ignored
                yield off, 8 + n, hdr + body
                off += 8 + n

    def replay(self, from_tick: int = 0, *,
               from_offset: Optional[int] = None
               ) -> Iterator[Tuple[int, Dict[str, EventBatch]]]:
        """Yield ``(tick, sources)`` records, batches of CPU tensors.

        ``from_offset`` (logical, e.g. a frontier's wal_offset) skips
        records below it without decoding them; ``from_tick`` further
        filters by tick.  An offset below the truncation base starts at
        the first record kept.
        """
        for off, _, blob in self._iter_raw():
            if from_offset is not None and off < from_offset:
                continue
            rec = msgpack.unpackb(self._dctx.decompress(blob[8:]))
            if rec["tick"] < from_tick:
                continue
            out = {}
            for stream, b in rec["src"].items():
                sname = stream if isinstance(stream, str) \
                    else stream.decode()
                value = _unflat({(k if isinstance(k, str)
                                  else k.decode()): _dec(v)
                                 for k, v in b["value"].items()})
                out[sname] = EventBatch(
                    sid=_dec(b["sid"]), ts=_dec(b["ts"]),
                    key=_dec(b["key"]), value=value,
                    valid=_dec(b["valid"]))
            yield rec["tick"], out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflat(flat: Dict[str, torch.Tensor]):
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
