"""Persistent slate store — the role Cassandra plays in paper section 4.2
(port of ``repro.slates.kvstore``, byte-compatible with it).

Slates are serialized (msgpack) and compressed ("our applications often
use JSON ... so Muppet compresses each slate before storing it").  The
store simulates a replicated cluster: N replica directories, write
quorum W and read quorum R (the paper's ONE / QUORUM / ALL knob),
per-write TTL with garbage collection, and bucketed segment files whose
rewrite stands in for compaction.  Layout and bytes are the JAX
store's: ``root/replica_<i>/<updater>/bucket_<b>.seg``, each segment a
msgpack map ``{key: [ts, ttl, blob]}``, each blob a tagged frame
(``_compress``) of ``_pack_tree(slate)``; either package reads what the
other wrote.

Two differences of cost, none of bytes:

- ``put_many`` / ``put_rows`` merge each touched segment once per batch.
  The JAX store flushes every 1,024 buffered puts and each flush
  rewrites every touched segment whole, so one batch of n rows rewrites
  each segment n / 1,024 times.  The port keeps the same rounds of
  1,024 puts but folds them in memory by the merge's own rule (a key
  keeps the place of its first write; a later write replaces its record
  when its ``ts`` is not older), so the files are the same bytes after
  every call.
- A segment's records are kept in memory as their encoded bytes, next
  to the file bytes they were read from or written as; a merge re-reads
  the file and re-parses it only when the bytes differ (another store
  object or process wrote it).  A merge then costs the rows it writes,
  not the segment's size.

``put_rows`` packs a batch of rows of one slate layout in one numpy
pass: for a fixed layout a row packs to constant bytes around each
leaf's row bytes (:class:`RowCodec`), equal to ``_pack_tree`` of the
row.  ``scan_rows`` reads them back the same way.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.slates import _compress
from repro_torch.slates import _msgpack as msgpack


def _enc_leaf(a: np.ndarray) -> dict:
    return {b"__nd__": True, b"d": a.tobytes(), b"t": a.dtype.str,
            b"s": list(a.shape)}


def _pack_tree(tree) -> bytes:
    """Serialize a pytree of numpy arrays / scalars."""
    return msgpack.packb([(k, _enc_leaf(np.asarray(v)))
                          for k, v in _flatten(tree)])


def _unpack_tree(raw: bytes):
    flat = []
    for k, e in msgpack.unpackb(raw):
        a = np.frombuffer(e[b"d"], dtype=np.dtype(e[b"t"])).reshape(e[b"s"])
        flat.append((k if isinstance(k, str) else k.decode(), a))
    return _unflatten(flat)


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(flat):
    out: Dict[str, Any] = {}
    for k, v in flat:
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    if list(out.keys()) == [""]:
        return out[""]
    return out


class RowCodec:
    """``_pack_tree`` of one slate layout, a batch of rows at a time.

    A layout is the sorted leaf paths with each leaf's row shape and
    dtype.  Packed, a row is constant bytes around each leaf's raw row
    bytes, so a batch packs into one ``[n, L]`` byte matrix and unpacks
    from one.  ``encode`` equals ``[_pack_tree(row) for row in rows]``;
    ``decode`` inverts it."""

    def __init__(self, layout: List[Tuple[str, Tuple[int, ...], np.dtype]]):
        self.layout = layout
        parts: List[Any] = [msgpack.array_header(len(layout))]
        for i, (k, shape, dt) in enumerate(layout):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            parts += [msgpack.array_header(2) + msgpack.packb(k)
                      + msgpack.map_header(4) + msgpack.packb(b"__nd__")
                      + b"\xc3" + msgpack.packb(b"d")
                      + msgpack.bin_header(nbytes),
                      (i, nbytes),                # the leaf's row bytes
                      msgpack.packb(b"t") + msgpack.packb(dt.str)
                      + msgpack.packb(b"s") + msgpack.packb(list(shape))]
        # (constant bytes or a leaf index, first column, end column)
        self.cols, col = [], 0
        for p in parts:
            width = len(p) if isinstance(p, bytes) else p[1]
            self.cols.append((p if isinstance(p, bytes) else p[0], col,
                              col + width))
            col += width
        self.width = col

    @staticmethod
    def of(vals) -> "RowCodec":
        """The layout of a pytree of ``[n, ...]`` arrays."""
        return RowCodec([(k, tuple(np.shape(a)[1:]), np.asarray(a).dtype)
                         for k, a in _flatten(vals)])

    @staticmethod
    def of_row(row) -> "RowCodec":
        """The layout of one row (a pytree of arrays, as ``_unpack_tree``
        gives it)."""
        return RowCodec([(k, tuple(np.shape(a)), np.asarray(a).dtype)
                         for k, a in _flatten(row)])

    def encode(self, vals, n: int) -> List[bytes]:
        leaves = [np.ascontiguousarray(a) for _, a in _flatten(vals)]
        buf = np.empty((n, self.width), np.uint8)
        for p, lo, hi in self.cols:
            if isinstance(p, bytes):
                buf[:, lo:hi] = np.frombuffer(p, np.uint8)
            elif hi > lo:
                buf[:, lo:hi] = leaves[p].reshape(n, -1).view(np.uint8)
        whole, w = buf.tobytes(), self.width
        return [whole[i * w:(i + 1) * w] for i in range(n)]

    def decode(self, raws: List[bytes]):
        """Rows packed in this layout -> pytree of ``[n, ...]`` arrays, or
        None when any row is not in it."""
        n, w = len(raws), self.width
        if any(len(r) != w for r in raws):
            return None
        buf = np.frombuffer(b"".join(raws), np.uint8).reshape(n, w)
        flat = []
        for p, lo, hi in self.cols:
            if isinstance(p, bytes):
                if not (buf[:, lo:hi] == np.frombuffer(p, np.uint8)).all():
                    return None
            else:
                k, shape, dt = self.layout[p]
                col = np.ascontiguousarray(buf[:, lo:hi])
                flat.append((k, col.view(dt).reshape((n,) + shape)))
        return _unflatten(flat)


@dataclass
class Record:
    ts: int          # write tick
    ttl: int         # 0 = forever
    blob: bytes      # compressed slate


def _entry_bytes(key: int, rec: Record) -> bytes:
    """One segment entry, ``key: [ts, ttl, blob]``, as msgpack bytes."""
    return (msgpack.pack_int(key) + b"\x93" + msgpack.pack_int(rec.ts)
            + msgpack.pack_int(rec.ttl) + msgpack.bin_header(len(rec.blob))
            + rec.blob)


def _parse_segment(raw: bytes):
    """Yield ``(key, ts, ttl, blob, entry bytes)`` of a segment file."""
    if not raw:
        return
    n, pos = _map_len(raw)
    for _ in range(n):
        start = pos
        k, pos = msgpack.unpack_from(raw, pos)
        v, pos = msgpack.unpack_from(raw, pos)
        yield int(k), v[0], v[1], v[2], raw[start:pos]


def _map_len(raw: bytes) -> Tuple[int, int]:
    b = raw[0]
    if 0x80 <= b <= 0x8F:
        return b & 0x0F, 1
    if b == 0xDE:
        return int.from_bytes(raw[1:3], "big"), 3
    if b == 0xDF:
        return int.from_bytes(raw[1:5], "big"), 5
    raise ValueError(f"segment does not start with a map (0x{b:02x})")


def _read_file(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return b""


class KVStore:
    """Replicated, bucketed, compressed key-value store for slates.

    Layout: root/replica_<i>/<updater>/bucket_<b>.seg — each segment is a
    msgpack map {key: [ts, ttl, blob]}.
    """

    def __init__(self, root: str, *, replicas: int = 3, write_quorum: int = 2,
                 read_quorum: int = 2, buckets: int = 64,
                 flush_buffer: int = 1024):
        if not (1 <= write_quorum <= replicas
                and 1 <= read_quorum <= replicas):
            raise ValueError(f"quorums W={write_quorum}, R={read_quorum} "
                             f"must lie in [1, replicas={replicas}]")
        self.root = root
        self.replicas = replicas
        self.write_quorum = write_quorum
        self.read_quorum = read_quorum
        self.buckets = buckets
        self._cctx = _compress.Compressor(level=3)
        self._dctx = _compress.Decompressor()
        self._lock = threading.Lock()
        # the open round of buffered puts, and the full rounds not yet
        # merged into the segments
        self._buffer: Dict[Tuple[str, int], Record] = {}
        self._closed: Dict[Tuple[str, int], Record] = {}
        self._flush_buffer = flush_buffer
        self._replica_down = [False] * replicas
        # segment path -> (file bytes, {key: ts}, {key: entry bytes}) as
        # this store last read or wrote them
        self._segs: Dict[str, Tuple[bytes, Dict[int, int],
                                    Dict[int, bytes]]] = {}
        self.bytes_written = 0          # segment bytes written, all replicas
        os.makedirs(root, exist_ok=True)

    # ---- fault injection (simulated replica failures) ----
    def set_replica_down(self, i: int, down: bool = True):
        self._replica_down[i] = down

    # ---- write path ----
    def put(self, updater: str, key: int, slate, *, ts: int, ttl: int = 0):
        blob = self._cctx.compress(_pack_tree(slate))
        self._buffer_batch(updater, [(int(key), Record(ts=int(ts), ttl=ttl,
                                                       blob=blob))])

    def put_many(self, updater: str, items: Iterable[Tuple[int, Any]], *,
                 ts, ttl: int = 0):
        """``ts`` is one write tick for the whole batch or a per-item
        sequence (each slate's own last-update tick, so TTL expiry and
        newest-wins reads stay per-key exact across flushes)."""
        per_item = isinstance(ts, (list, tuple, np.ndarray))
        recs = [(int(key), Record(
            ts=int(ts[i]) if per_item else int(ts), ttl=ttl,
            blob=self._cctx.compress(_pack_tree(slate))))
            for i, (key, slate) in enumerate(items)]
        self._buffer_batch(updater, recs)

    def put_rows(self, updater: str, keys, vals, *, ts, ttl: int = 0):
        """``put_many`` of the rows of a pytree of ``[n, ...]`` numpy
        arrays (``keys`` [n], ``ts`` [n]), packed in one numpy pass."""
        keys = np.asarray(keys).tolist()
        ts = np.asarray(ts).tolist()
        raws = RowCodec.of(vals).encode(vals, len(keys))
        c = self._cctx.compress
        self._buffer_batch(updater, [
            (k, Record(ts=t, ttl=ttl, blob=c(r)))
            for k, t, r in zip(keys, ts, raws)])

    def _buffer_batch(self, updater: str, recs):
        """Buffer puts in rounds of ``flush_buffer`` records, as the JAX
        store does; where it would merge each full round into the
        segments, fold the round into ``_closed`` instead and merge once
        at the end of the batch.  A later record replaces an earlier one
        of its key inside a round always, across rounds when its ``ts``
        is not older — what successive merges would leave."""
        with self._lock:
            for key, rec in recs:
                self._buffer[(updater, key)] = rec
                if len(self._buffer) >= self._flush_buffer:
                    self._close_round()
            if self._closed:
                self._write_closed()

    def _close_round(self):
        for k, rec in self._buffer.items():
            old = self._closed.get(k)
            if old is None or old.ts <= rec.ts:
                self._closed[k] = rec
        self._buffer.clear()

    def flush(self):
        with self._lock:
            self._close_round()
            self._write_closed()

    def _write_closed(self):
        if not self._closed:
            return
        by_seg: Dict[Tuple[str, int], Dict[int, Tuple[int, bytes]]] = {}
        for (upd, key), rec in self._closed.items():
            b = _bucket_of(key, self.buckets)
            by_seg.setdefault((upd, b), {})[key] = (rec.ts,
                                                    _entry_bytes(key, rec))
        self._closed.clear()
        for (upd, b), recs in by_seg.items():
            written = 0
            last = None     # (file bytes before, segment after) last merged
            for i in range(self.replicas):
                if self._replica_down[i]:
                    continue
                path = self._seg_path(i, upd, b)
                raw = _read_file(path)
                # replicas that hold the same bytes merge to the same
                # bytes: merge once, write each
                if last is None or last[0] != raw:
                    last = (raw, self._merged(path, raw, recs))
                self._write_segment(path, *last[1])
                written += 1
                if written >= self.write_quorum and \
                        written >= self._alive_count():
                    break
            if written < self.write_quorum:
                raise IOError(
                    f"write quorum failed ({written}/{self.write_quorum})")

    def _alive_count(self):
        return sum(1 for d in self._replica_down if not d)

    def _seg_path(self, replica: int, updater: str, bucket: int) -> str:
        d = os.path.join(self.root, f"replica_{replica}", updater)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"bucket_{bucket:04d}.seg")

    def _merged(self, path: str, raw: bytes, recs):
        """The segment ``raw`` (the file at ``path``) with ``recs``
        (``{key: (ts, entry bytes)}``) merged in by the newest-wins rule:
        ``(ts, entries, bytes)``.  The file's records are parsed again
        only when it is not what this store last read or wrote there."""
        held = self._segs.get(path)
        if held is None or held[0] != raw:
            ts, entries = {}, {}
            for k, t, _, _, e in _parse_segment(raw):
                ts[k], entries[k] = t, e
            held = self._segs[path] = (raw, ts, entries)
        ts, entries = dict(held[1]), dict(held[2])
        for k, (t, e) in recs.items():
            old = ts.get(k)
            if old is None or old <= t:
                ts[k], entries[k] = t, e
        return ts, entries, msgpack.map_header(len(entries)) + b"".join(
            entries.values())

    def _write_segment(self, path: str, ts, entries, raw: bytes):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)  # atomic
        self._segs[path] = (raw, ts, entries)
        self.bytes_written += len(raw)

    @staticmethod
    def _read_segment_file(path: str) -> Dict[int, Tuple[int, int, bytes]]:
        return {k: (ts, ttl, blob)
                for k, ts, ttl, blob, _ in _parse_segment(_read_file(path))}

    # ---- read path ----
    def get(self, updater: str, key: int, *, now: Optional[int] = None):
        """Quorum read: newest ts among read_quorum replicas; expired
        records (TTL) read as missing."""
        self.flush()
        b = _bucket_of(int(key), self.buckets)
        best: Optional[Tuple[int, int, bytes]] = None
        seen = 0
        for i in range(self.replicas):
            if self._replica_down[i]:
                continue
            seg = self._read_segment_file(self._seg_path(i, updater, b))
            rec = seg.get(int(key))
            seen += 1
            if rec is not None and (best is None or rec[0] > best[0]):
                best = rec
            if seen >= self.read_quorum:
                break
        if seen < self.read_quorum:
            raise IOError(f"read quorum failed ({seen}/{self.read_quorum})")
        if best is None:
            return None
        ts, ttl, blob = best
        if ttl and now is not None and now - ts > ttl:
            return None
        return _unpack_tree(self._dctx.decompress(blob))

    def _newest(self, updater: str, now: Optional[int]
                ) -> Dict[int, Tuple[int, bytes]]:
        """``{key: (ts, blob)}``: each live key's newest record over the
        replicas that are up."""
        self.flush()
        out: Dict[int, Tuple[int, bytes]] = {}
        for i in range(self.replicas):
            if self._replica_down[i]:
                continue
            d = os.path.join(self.root, f"replica_{i}", updater)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".seg"):
                    continue
                raw = _read_file(os.path.join(d, fn))
                for k, ts, ttl, blob, _ in _parse_segment(raw):
                    if ttl and now is not None and now - ts > ttl:
                        continue
                    old = out.get(k)
                    if old is None or ts > old[0]:
                        out[k] = (ts, blob)
        return out

    def scan(self, updater: str, *, now: Optional[int] = None):
        """Bulk read of every live slate (paper section 5 'bulk reading of
        slates')."""
        return {k: slate
                for k, (_, slate) in self.scan_records(updater,
                                                       now=now).items()}

    def scan_records(self, updater: str, *, now: Optional[int] = None
                     ) -> Dict[int, Tuple[int, Any]]:
        """Like ``scan`` but returns ``{key: (ts, slate)}`` — recovery
        needs each slate's write tick to restore per-slot TTL clocks."""
        return {k: (ts, _unpack_tree(self._dctx.decompress(blob)))
                for k, (ts, blob) in self._newest(updater, now).items()}

    def scan_rows(self, updater: str, *, now: Optional[int] = None):
        """``scan_records`` as arrays, keys ascending: ``(keys [n] int64,
        ts [n] int32, slates)`` with ``slates`` a pytree of ``[n, ...]``
        arrays, or ``None`` when the updater has no live slate.  Rows of
        one layout unpack in one numpy pass; a store holding several
        layouts for one updater unpacks row by row."""
        recs = self._newest(updater, now)
        if not recs:
            return None
        keys = np.asarray(sorted(recs), np.int64)
        ts = np.asarray([recs[k][0] for k in keys.tolist()], np.int32)
        dec = self._dctx.decompress
        raws = [dec(recs[k][1]) for k in keys.tolist()]
        codec = RowCodec.of_row(_unpack_tree(raws[0]))
        slates = codec.decode(raws)
        if slates is None:
            rows = [_flatten(_unpack_tree(r)) for r in raws]
            slates = _unflatten([(k, np.stack([r[i][1] for r in rows]))
                                 for i, (k, _) in enumerate(rows[0])])
        return keys, ts, slates

    # ---- maintenance ----
    def gc(self, updater: str, *, now: int):
        """Drop expired records (the store-side TTL GC of section 4.2)."""
        removed = 0
        with self._lock:
            for i in range(self.replicas):
                if self._replica_down[i]:
                    continue
                d = os.path.join(self.root, f"replica_{i}", updater)
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    if not fn.endswith(".seg"):
                        continue
                    path = os.path.join(d, fn)
                    seg = list(_parse_segment(_read_file(path)))
                    live = [(k, ts, e) for k, ts, ttl, _, e in seg
                            if not (ttl and now - ts > ttl)]
                    if len(live) != len(seg):
                        removed += len(seg) - len(live)
                        entries = {k: e for k, _, e in live}
                        self._write_segment(
                            path, {k: ts for k, ts, _ in live}, entries,
                            msgpack.map_header(len(entries))
                            + b"".join(entries.values()))
        return removed


def _bucket_of(key: int, buckets: int) -> int:
    x = key & 0xFFFFFFFF
    x = (x ^ (x >> 16)) * 0x7FEB352D & 0xFFFFFFFF
    x = (x ^ (x >> 15)) * 0x846CA68B & 0xFFFFFFFF
    return (x ^ (x >> 16)) % buckets
