"""Slate compression codec with a stdlib fallback (a copy of
``repro.slates._compress``, which the port may not import).

The paper compresses every slate before it hits the store; zstd is
preferred (fast, high ratio), but a checkout without ``zstandard`` (the
machines with a card have none) still runs, on zlib.  Frames are
**self-describing**: every compressed blob starts with a one-byte codec
tag, because the WAL and the KV store outlive the process that wrote
them: a log written where zstd was installed must replay where it is
not (and the other way round).  Decompressing a zstd frame without
``zstandard`` installed fails with an actionable error.
"""
from __future__ import annotations

import zlib as _zlib

_ZSTD = b"z"
_ZLIB = b"g"
_RAW = b"r"

try:
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:
    _zstd = None
    HAVE_ZSTD = False


class Compressor:
    """Compresses with the best codec available; output is a tagged
    frame (1 codec byte + payload).  ``level <= 0`` stores raw (still
    tagged): latency-critical writers (the WAL append hot path) opt out
    of compression without changing the frame format."""

    def __init__(self, level: int = 3):
        self._c = None
        if level <= 0:
            self._tag = _RAW
        elif HAVE_ZSTD:
            self._tag = _ZSTD
            self._c = _zstd.ZstdCompressor(level=level)
        else:
            self._tag = _ZLIB
            self._level = min(max(level, 1), 9)

    def compress(self, data: bytes) -> bytes:
        if self._tag == _RAW:
            return self._tag + data
        if self._c is not None:
            return self._tag + self._c.compress(data)
        return self._tag + _zlib.compress(data, self._level)


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class Decompressor:
    """Dispatches on the frame's codec tag — independent of which codec
    the local environment would compress with.  Untagged blobs from
    before the tag existed are sniffed by their codec magic (zstd frame
    magic / zlib 0x78 header; neither collides with the tag bytes)."""

    def __init__(self):
        self._zd = _zstd.ZstdDecompressor() if HAVE_ZSTD else None

    def _zstd_decompress(self, payload: bytes) -> bytes:
        if self._zd is None:
            raise RuntimeError(
                "blob was written with zstd but 'zstandard' is not "
                "installed here — pip install -r requirements-dev.txt")
        return self._zd.decompress(payload)

    def decompress(self, data: bytes) -> bytes:
        tag, payload = data[:1], data[1:]
        if tag == _RAW:
            return payload
        if tag == _ZLIB:
            return _zlib.decompress(payload)
        if tag == _ZSTD:
            return self._zstd_decompress(payload)
        if data[:4] == _ZSTD_MAGIC:          # legacy untagged zstd
            return self._zstd_decompress(data)
        if tag == b"\x78":                   # legacy untagged zlib
            return _zlib.decompress(data)
        raise ValueError(f"unknown compression codec tag {tag!r}")
