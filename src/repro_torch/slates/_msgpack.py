"""The msgpack subset the durable files use, in pure Python.

The WAL records, the KV store's segment files and its slate blobs are
msgpack (``repro.slates.wal`` / ``kvstore``).  The port keeps their
bytes and reads files that the JAX package wrote, without the
``msgpack`` package, which the machines with a card do not have.

``packb`` writes what ``msgpack.packb(obj)`` writes with its defaults
(``use_bin_type=True``): the smallest encoding of each value, ``str`` as
str8/16/32, ``bytes`` as bin8/16/32, non-negative ints as positive
fixint or uint8-uint64, negative ints as negative fixint or
int8-int64.  Types: ``None``, ``bool``, ``int`` in [-2**63, 2**64),
``str``, ``bytes`` / ``bytearray`` / ``memoryview``, ``list`` /
``tuple`` (arrays) and ``dict`` (maps, in iteration order).

``unpackb`` reads what ``msgpack.unpackb(raw, strict_map_key=False)``
gives for those types: arrays as lists, str as ``str``, bin as
``bytes``.  Other msgpack types (floats, ext) raise ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_U16, _U32 = struct.Struct(">H"), struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8, _I16 = struct.Struct(">b"), struct.Struct(">h")
_I32, _I64 = struct.Struct(">i"), struct.Struct(">q")


def pack_int(x: int) -> bytes:
    """One int, as msgpack-python encodes it."""
    if 0 <= x < 0x80:
        return bytes((x,))
    if x >= 0:
        if x <= 0xFF:
            return b"\xcc" + bytes((x,))
        if x <= 0xFFFF:
            return b"\xcd" + _U16.pack(x)
        if x <= 0xFFFFFFFF:
            return b"\xce" + _U32.pack(x)
        if x <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + _U64.pack(x)
        raise OverflowError(f"int {x} too large for msgpack")
    if x >= -32:
        return bytes((x & 0xFF,))
    if x >= -0x80:
        return b"\xd0" + _I8.pack(x)
    if x >= -0x8000:
        return b"\xd1" + _I16.pack(x)
    if x >= -0x80000000:
        return b"\xd2" + _I32.pack(x)
    if x >= -0x8000000000000000:
        return b"\xd3" + _I64.pack(x)
    raise OverflowError(f"int {x} too small for msgpack")


def _len_header(n: int, fix: int, fix_max: int, codes: bytes) -> bytes:
    """Header of a str / bin / array / map of length ``n``: a fix form
    (``fix | n`` for ``n < fix_max``; none where ``fix_max`` is 0), then
    the 8-, 16- and 32-bit length forms in ``codes`` (0 where absent)."""
    if n < fix_max:
        return bytes((fix | n,))
    if n <= 0xFF and codes[0]:
        return bytes((codes[0], n))
    if n <= 0xFFFF:
        return bytes((codes[1],)) + _U16.pack(n)
    if n <= 0xFFFFFFFF:
        return bytes((codes[2],)) + _U32.pack(n)
    raise ValueError(f"length {n} too large for msgpack")


def str_header(n: int) -> bytes:
    return _len_header(n, 0xA0, 32, b"\xd9\xda\xdb")


def bin_header(n: int) -> bytes:
    return _len_header(n, 0, 0, b"\xc4\xc5\xc6")


def array_header(n: int) -> bytes:
    return _len_header(n, 0x90, 16, b"\x00\xdc\xdd")


def map_header(n: int) -> bytes:
    return _len_header(n, 0x80, 16, b"\x00\xde\xdf")


def _pack(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(pack_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(str_header(len(b)))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(bin_header(len(b)))
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---- reading ----
# type byte -> (kind, width of the length field); ints -> (width, struct)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_INTS = {0xCC: (1, struct.Struct(">B")), 0xCD: (2, _U16),
         0xCE: (4, _U32), 0xCF: (8, _U64), 0xD0: (1, _I8),
         0xD1: (2, _I16), 0xD2: (4, _I32), 0xD3: (8, _I64)}
_LEN = {1: struct.Struct(">B"), 2: _U16, 4: _U32}


def unpack_from(raw, pos: int) -> Tuple[Any, int]:
    """Decode one object at ``pos``; returns (object, end position)."""
    b = raw[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(raw[pos:pos + n]).decode("utf-8"), pos + n
    if 0x90 <= b <= 0x9F:
        return _array(raw, pos, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(raw, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _INTS:
        w, st = _INTS[b]
        return st.unpack_from(raw, pos)[0], pos + w
    if b in _SIZED:
        kind, w = _SIZED[b]
        n = _LEN[w].unpack_from(raw, pos)[0]
        pos += w
        if kind == "bin":
            return bytes(raw[pos:pos + n]), pos + n
        if kind == "str":
            return bytes(raw[pos:pos + n]).decode("utf-8"), pos + n
        if kind == "array":
            return _array(raw, pos, n)
        return _map(raw, pos, n)
    raise ValueError(f"msgpack type byte 0x{b:02x} at {pos - 1} is outside "
                     "the subset this module reads")


def _array(raw, pos, n):
    out = []
    for _ in range(n):
        x, pos = unpack_from(raw, pos)
        out.append(x)
    return out, pos


def _map(raw, pos, n):
    out = {}
    for _ in range(n):
        k, pos = unpack_from(raw, pos)
        v, pos = unpack_from(raw, pos)
        out[k] = v
    return out, pos


def unpackb(raw) -> Any:
    obj, end = unpack_from(raw, 0)
    if end != len(raw):
        raise ValueError(f"{len(raw) - end} extra bytes after the object")
    return obj
