"""Integer hashing (the hashing half of ``repro.core.hashing``).

The JAX package hashes in uint32.  PyTorch has no uint32 ``>>``, ``%``
or ``+`` on the CPU, so the port carries uint32 values in int64 tensors
and masks with ``0xFFFFFFFF`` after every step.  Each 32-bit multiply is
split into 16-bit halves so no intermediate passes 2**48: the low 32
bits come out exactly as uint32 arithmetic gives them, with no reliance
on int64 wrap-around.  Results are int64 tensors holding values in
``[0, 2**32)``, bitwise equal to the JAX package's uint32 hashes.

The Muppet hash ring (``HashRing``, ``route``, ``route_secondary``) is
the JAX package's: built on the host in numpy, bitwise the same ring
arrays, and queried on the engine's device.  The ring is a runtime
*tensor* input of the tick with a fixed shape, so a failure re-routes
without changing any shape (paper section 4.3: "the master broadcasts
the failure, all workers update their hash ring").

- **Fixed-shape tables.**  ``table()`` always returns ``n_shards *
  vnodes`` entries, padded at the top with ``0xFFFFFFFF`` entries that
  alias the wrap target; membership and weight changes swap contents,
  never shapes.
- **Weighted virtual nodes.**  Each alive shard owns vnode indices
  ``0..c_i-1`` with ``c_i`` proportional to its weight (the sum fixed at
  ``alive_count * vnodes``), bit-identical to the classic equal-vnode
  ring when every weight is 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PAD_HASH = np.uint32(0xFFFFFFFF)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, without any product above 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche over uint32 values held in int64."""
    x = x.to(torch.int64) & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def fold_u32(key: torch.Tensor) -> torch.Tensor:
    """Fold a key tensor to uint32 (in int64): xor-fold for 64-bit keys,
    the identity bit pattern for 32-bit keys.  int64 ``>>`` is an
    arithmetic shift, so the high word is masked after the shift."""
    k = key.to(torch.int64)
    if key.element_size() > 4:
        return (k ^ ((k >> 32) & M32)) & M32
    return k & M32


def hash_key(key: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Hash integer keys (+salt) to uint32 values (int64 tensor)."""
    return mix32(fold_u32(key) ^ (salt & M32))


def fold_u32_np(x: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`fold_u32` (numpy uint32)."""
    if x.dtype.itemsize > 4:
        u = x.astype(np.uint64)
        return (u ^ (u >> np.uint64(32))).astype(np.uint32)
    return x.astype(np.uint32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x


class HashRing:
    """Consistent-hash ring with weighted virtual nodes (host-built,
    device-queried).

    ``table(device)`` returns ``(ring_hashes [R] ascending, ring_shards
    [R] int32)`` with R = ``n_shards * vnodes`` fixed; the hashes are
    uint32 values held in int64, as :func:`hash_key` gives them.
    """

    def __init__(self, n_shards: int, *, vnodes: int = 64,
                 alive: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None, seed: int = 0x5EED):
        self.n_shards = n_shards
        self.vnodes = vnodes
        self.seed = seed
        self.alive = (np.ones(n_shards, bool) if alive is None
                      else np.asarray(alive, bool).copy())
        self.weights = (np.ones(n_shards, np.float64) if weights is None
                        else np.clip(np.asarray(weights, np.float64), 0.0,
                                     None).copy())
        self._build()

    def vnode_counts(self) -> np.ndarray:
        """Per-shard vnode allocation: proportional to weight over the
        alive set, every alive positive-weight shard gets >= 1, total
        fixed at ``alive_count * vnodes``."""
        return self.counts_for(self.weights)

    def counts_for(self, weights: np.ndarray) -> np.ndarray:
        """The vnode allocation a candidate weight vector would yield
        (pure: detects no-op reweights without a ring rebuild)."""
        w = np.where(self.alive, np.clip(weights, 0.0, None), 0.0)
        total = float(w.sum())
        alive_n = int(self.alive.sum())
        if alive_n == 0 or total <= 0.0:
            raise RuntimeError("hash ring has no alive shards with "
                               "positive weight")
        budget = alive_n * self.vnodes
        raw = budget * w / total
        counts = np.floor(raw).astype(np.int64)
        counts = np.where((w > 0) & (counts == 0), 1, counts)
        # largest remainder: settle to the exact budget
        frac = raw - np.floor(raw)
        order = [int(i) for i in np.argsort(-frac, kind="stable")
                 if w[i] > 0]
        i = 0
        while counts.sum() < budget:
            counts[order[i % len(order)]] += 1
            i += 1
        donors = [int(i) for i in np.argsort(frac, kind="stable")
                  if w[i] > 0]
        i = 0
        while counts.sum() > budget:
            d = donors[i % len(donors)]
            if counts[d] > 1:
                counts[d] -= 1
            i += 1
        return counts.astype(np.int64)

    def _build(self):
        counts = self.vnode_counts()
        ids = np.repeat(np.arange(self.n_shards, dtype=np.uint32), counts)
        vix = np.concatenate([np.arange(c, dtype=np.uint32)
                              for c in counts]) if len(ids) else \
            np.zeros(0, np.uint32)
        h = _mix32_np(ids * np.uint32(0x9E3779B9) ^ _mix32_np(
            vix + np.uint32(self.seed)))
        order = np.argsort(h, kind="stable")
        real_h = h[order]
        real_s = ids[order].astype(np.int32)
        # pad to the fixed shape: every pad hash ties at the maximum, so
        # a left search lands only on the first pad entry, which aliases
        # the wrap target; the rest cycle the real ring so the secondary
        # walk meets distinct shards across the pad region
        R = self.n_shards * self.vnodes
        pad = R - len(real_h)
        self.real_size = len(real_h)
        self.ring_hashes = np.concatenate(
            [real_h, np.full(pad, _PAD_HASH, np.uint32)])
        self.ring_shards = np.concatenate(
            [real_s, real_s[np.arange(pad) % len(real_s)]])
        self._tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    # ---- host-side membership / weight changes (master broadcast) ----
    def fail(self, shard: int):
        self.alive[shard] = False
        self._build()

    def join(self, shard: int):
        """(Re)activate a slot; its weight resets to neutral."""
        if shard >= self.n_shards:
            self.grow(shard + 1)
        self.alive[shard] = True
        self.weights[shard] = 1.0
        self._build()

    def grow(self, new_n_shards: int):
        """Extend the physical shard count (the ring's shape changes)."""
        if new_n_shards < self.n_shards:
            raise ValueError("grow() cannot shrink; use fail()/leave "
                             "to deactivate shards")
        grown = np.ones(new_n_shards, bool)
        grown[:self.n_shards] = self.alive
        w = np.ones(new_n_shards, np.float64)
        w[:self.n_shards] = self.weights
        self.alive, self.weights = grown, w
        self.n_shards = new_n_shards
        self._build()

    def set_weights(self, weights: np.ndarray):
        """Load-aware reweighting: a hot shard (low weight) sheds arcs;
        same shape."""
        w = np.clip(np.asarray(weights, np.float64), 0.0, None)
        if w.shape != (self.n_shards,):
            raise ValueError(f"weights must have shape "
                             f"({self.n_shards},), got {w.shape}")
        self.weights = w.copy()
        self._build()

    def table(self, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        """The ring arrays on ``device``, cached until the next rebuild
        (every tick reads them: no host-to-device copy a tick)."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._tables:
            self._tables[key] = (
                torch.from_numpy(self.ring_hashes.astype(np.int64)).to(dev),
                torch.from_numpy(self.ring_shards).to(dev))
        return self._tables[key]

    def owners(self, keys, dest_salt: int) -> np.ndarray:
        """Host-side routing: shard id per key.  Arrays keep their key
        width (int64 keys route on the folded hash); bare sequences
        default to int32."""
        k = keys if hasattr(keys, "dtype") else np.asarray(keys, np.int32)
        k = torch.as_tensor(np.asarray(k))
        return route(k, dest_salt, *self.table()).numpy()


def route(keys: torch.Tensor, dest_salt: int, ring_hashes: torch.Tensor,
          ring_shards: torch.Tensor) -> torch.Tensor:
    """Ring lookup on the keys' device: shard id (int32) per key, any key
    shape.  The hash of (key, destination operator) walks clockwise to
    the next virtual node: Muppet's ``h(key, dest function) -> worker``."""
    h = hash_key(keys, salt=dest_salt)
    idx = torch.searchsorted(ring_hashes, h, side="left")
    idx = torch.where(idx == ring_hashes.shape[0], 0, idx)     # wrap
    return ring_shards[idx]


def route_secondary(keys: torch.Tensor, dest_salt: int,
                    ring_hashes: torch.Tensor, ring_shards: torch.Tensor
                    ) -> torch.Tensor:
    """The other choice for two-choice dispatch: the next distinct shard
    clockwise on the ring (Muppet 2.0's secondary queue), within 8
    vnodes."""
    h = hash_key(keys, salt=dest_salt)
    R = ring_hashes.shape[0]
    idx = torch.searchsorted(ring_hashes, h, side="left") % R
    primary = ring_shards[idx]
    best = primary
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for step in range(1, 9):
        cand = ring_shards[(idx + step) % R]
        take = ~found & (cand != primary)
        best = torch.where(take, cand, best)
        found = found | take
    return best
