"""Hotspot mitigation: key splitting (port of ``repro.core.hotspot``;
paper section 5, Example 6).

"Instead of using just a single updater U, we can use a set of updaters,
each of which counts just a subset of Best Buy events" — for associative
+ commutative updates, a hot key k is rewritten to W sub-keys
``k*W + r`` by a splitting mapper; per-sub-key partial aggregates are
re-combined on read.

Sub-key arithmetic is *windowed* so it never overflows the key dtype:
only keys inside ``|k| < split_window(W)`` are split (their sub-keys
tile ``(-2**(bits-2), 2**(bits-2))`` exactly); keys outside the window
pass through unsplit, so the dtype's extremes round-trip bit-exactly.
The mid band ``split_window(W) <= |k| < 2**(bits-2)`` passes through
too and may share a slate row with an in-window key's sub-key, as in
the JAX package (DESIGN.md 12.5).

``split_keys`` hashes in the JAX package's int32 arithmetic (wrapping
products), so every sub-key is bitwise the JAX package's.
``read_split_slate`` merges the W partials with the updater's own
combine, on the single-shard ``Engine`` and on ``DistributedEngine``,
where each sub-key read routes through the hash ring.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List

import torch

from repro_torch.core.event import EventBatch
from repro_torch.core.hashing import M32, hash_key
from repro_torch.core.operators import Mapper


class SplitSlateReadError(RuntimeError):
    """``read_split_slate`` was handed an engine it cannot read from
    (no ``read_slate``/workflow surface) or an unknown updater."""


def split_window(ways: int, bits: int = 32) -> int:
    """Largest ``L`` such that every ``|k| < L`` splits W ways with
    sub-keys confined to ``(-2**(bits-2), 2**(bits-2))``."""
    if ways < 1:
        raise ValueError(f"ways must be >= 1, got {ways}")
    return (1 << (bits - 2)) // ways


def _key_bits(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size() * 8


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their low 32 bits as signed int32 values (still
    int64): the JAX package's wrapping int32 product."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def split_keys(keys: torch.Tensor, ts: torch.Tensor, ways: int,
               nonce=None) -> torch.Tensor:
    """key -> key*W + r with r pseudo-random per event (salted by ts and
    a per-row nonce so a hot key's events spread across all W sub-keys
    even within one microbatch).  Keys outside ``split_window(ways,
    bits)`` pass through unsplit."""
    kd = keys.dtype
    if nonce is None:
        nonce = torch.arange(keys.shape[0], dtype=torch.int32,
                             device=keys.device)
    k64 = keys.to(torch.int64)
    # int32 products that wrap, as jnp's; 2654435761 is -1640531535
    salt = _wrap32(ts.to(torch.int64) * -1640531535) ^ \
        _wrap32(nonce.to(torch.int64) * 40503)
    mixin = k64 ^ salt
    if _key_bits(kd) == 32:
        mixin = _wrap32(mixin)
    r = (hash_key(mixin.to(kd), salt=0x51717) % ways).to(kd)
    w = split_window(ways, _key_bits(kd))
    in_window = (keys > -w) & (keys < w)
    return torch.where(in_window, keys * ways + r, keys)


def merge_keys(split: torch.Tensor, ways: int) -> torch.Tensor:
    """Exact inverse of :func:`split_keys` for every key inside the
    split window and every ``|k| >= 2**(bits-2)``."""
    bound = split_window(ways, _key_bits(split.dtype)) * ways
    in_image = (split > -bound) & (split < bound)
    return torch.where(in_image,
                       torch.div(split, ways, rounding_mode="floor"), split)


def subkeys_of(key: int, ways: int, bits: int = 32) -> List[int]:
    """The sub-keys a key's events may have been rewritten to (host
    side, for reads).  Mirrors :func:`split_keys` exactly."""
    if abs(int(key)) < split_window(ways, bits):
        return [int(key) * ways + r for r in range(ways)]
    return [int(key)]


class KeySplitMapper(Mapper):
    """Rewrites keys on ``in_stream`` to W-way sub-keys on ``out_stream``."""

    def __init__(self, in_stream: str, out_stream: str, value_spec,
                 ways: int = 8, name: str = "key_split"):
        self.name = name
        self.subscribes = (in_stream,)
        self.in_value_spec = value_spec
        self.out_streams = {out_stream: value_spec}
        self.ways = ways
        self._out = out_stream

    def map_batch(self, batch: EventBatch) -> Dict[str, EventBatch]:
        new_key = split_keys(batch.key, batch.ts, self.ways)
        return {self._out: EventBatch(sid=batch.sid, ts=batch.ts + 1,
                                      key=new_key, value=batch.value,
                                      valid=batch.valid)}


def read_split_slate(engine, state, updater: str, key: int, ways: int,
                     combine=None):
    """Merge the W partial slates of a split key.

    Works on both engines: each sub-key read goes through
    ``engine.read_slate``, which on :class:`DistributedEngine` routes
    the sub-key through the hash ring to its owner shard (and merges
    two-choice partials).  Raises :class:`SplitSlateReadError` for
    engines without that surface or unknown updaters.
    """
    wf = getattr(engine, "wf", None)
    read = getattr(engine, "read_slate", None)
    if wf is None or read is None:
        raise SplitSlateReadError(
            f"read_split_slate needs an engine exposing .wf and "
            f".read_slate; got {type(engine).__name__}")
    op = wf.by_name.get(updater)
    if op is None:
        raise SplitSlateReadError(
            f"unknown updater {updater!r}; workflow has "
            f"{sorted(wf.by_name)}")
    combine = combine or getattr(op, "combine", None)
    if combine is None:
        raise SplitSlateReadError(
            f"{updater!r} is a {type(op).__name__} with no combine — "
            f"split-slate reads need an associative updater")
    partials = []
    # every sub-key read under one read_lock hold (re-entrant: the
    # engine's read_slate takes it again), so a concurrent run cannot
    # hand back partials of two different ticks
    lock = getattr(engine, "read_lock", None) or nullcontext()
    bits = int(getattr(engine, "key_bits", 32))
    with lock:
        for sub in subkeys_of(key, ways, bits):
            s = read(state, updater, sub)
            if s is not None:
                partials.append(s)
    if not partials:
        return None
    out = partials[0]
    for p in partials[1:]:
        out = combine(out, p)
    return out
