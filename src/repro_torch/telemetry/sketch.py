"""Count-min key-heat sketch: device state + host readout (port of
``repro.telemetry.sketch``).

``depth`` hash rows of ``width`` counters; an event increments one
counter per row; ``estimate`` reads the min over rows — an upper bound
on the true count (error <= e*N/width with prob 1 - e^-depth).  A
count-min sketch cannot enumerate keys, so the state also carries a
small key-sample ring, from which ``heavy_hitters`` takes its
candidates.

``sketch_update`` runs inside the tick on the keys each updater
dequeues (``kernels/countmin``; on the card its kernel hashes the
columns itself); ``estimate`` / ``heavy_hitters`` read a
host snapshot taken at window boundaries only.  ``decay`` ages the
counters at those boundaries; ``total`` stays monotone.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device, torch_dtype
from repro_torch.core.hashing import _mix32_np, fold_u32_np
from repro_torch.kernels.countmin import countmin_update_keys
# the plain column hash, kept here under its JAX package name
from repro_torch.kernels.countmin.ref import (  # noqa: F401
    columns, salts_tensor)


def make_salts(depth: int, seed: int = 0x7E1E) -> np.ndarray:
    """Per-row hash salts (uint32), deterministic in (depth, seed)."""
    rows = np.arange(depth, dtype=np.uint32)
    return _mix32_np(rows * np.uint32(0x85EBCA6B) + np.uint32(seed))


def make_sketch(depth: int, width: int, sample: int,
                key_dtype=torch.int32, device=None) -> Dict[str, Any]:
    """Fresh sketch state.  The sample ring carries raw keys, so it
    shares the key dtype."""
    dev = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "counts": torch.zeros((depth, width), dtype=torch.int32, device=dev),
        "total": z(),
        "sample": torch.zeros(sample, dtype=torch_dtype(key_dtype),
                              device=dev),
        "sample_n": z(),
    }


def sketch_update(sk, keys, valid, salts, *, impl: str = "auto"):
    """Fold one batch of (keys, valid) into the sketch inside the tick:
    fixed shapes, no host sync.  ``salts``: the numpy uint32 row salts of
    :func:`make_salts` (kernel arguments on the card, a tensor made once
    per device on the plain route).  ``counts`` is updated in place; the
    other leaves are new tensors.

    The sample ring update is an elementwise select: batch row ``i``
    overwrites ring slot ``i`` when valid, so a key enters only via the
    first ``S`` rows — enough to discover heavy hitters; the counters
    are the exact part."""
    add = valid.to(torch.int32)
    counts = countmin_update_keys(sk["counts"], keys, add, salts, impl=impl)
    S = sk["sample"].shape[0]
    B = keys.shape[0]
    if B >= S:
        k, v = keys[:S], valid[:S]
    else:
        k = torch.cat([keys, keys.new_zeros(S - B)])
        v = torch.cat([valid, valid.new_zeros(S - B)])
    n = add.sum(dtype=torch.int32)
    return {
        "counts": counts,
        "total": sk["total"] + n,
        "sample": torch.where(v, k, sk["sample"]),
        "sample_n": sk["sample_n"] + n,
    }


def decay(sk, factor: float):
    """Age the counters at a window boundary: ``factor`` in (0, 1) scales
    heat down as ``floor(f32(counts) * factor)`` (the JAX package's f32
    arithmetic, so bitwise equal), 0 or less hard-resets.  ``total`` and
    the sample ring are left alone."""
    counts = sk["counts"]
    if factor <= 0.0:
        counts = torch.zeros_like(counts)
    else:
        counts = torch.floor(counts.to(torch.float32) * factor) \
            .to(counts.dtype)
    return {**sk, "counts": counts}


# ---- host-side readout (window-boundary snapshots) -------------------

def estimate(counts: np.ndarray, keys, salts: np.ndarray) -> np.ndarray:
    """Point estimates for ``keys`` from a host snapshot of one sketch:
    min over rows, always >= the true (decayed) count.  Pure numpy."""
    counts = np.asarray(counts)
    # arrays keep their key width (the fold matches the device path);
    # bare sequences default to int32
    if not (isinstance(keys, np.ndarray) and keys.dtype.kind in "iu"):
        keys = np.asarray(keys, np.int32)
    keys = np.atleast_1d(keys)
    width = counts.shape[1]
    ests = []
    for d, s in enumerate(salts):
        cols = _mix32_np(fold_u32_np(keys) ^ np.uint32(s))
        ests.append(counts[d, cols % np.uint32(width)])
    return np.min(np.stack(ests), axis=0)


def candidates(sample: np.ndarray, sample_n: int) -> np.ndarray:
    """Distinct keys currently resident in the sample ring."""
    sample = np.asarray(sample)
    n = min(int(sample_n), sample.shape[0])
    return np.unique(sample[:n]) if n else np.zeros(0, sample.dtype)


def heavy_hitters(counts: np.ndarray, sample: np.ndarray, sample_n: int,
                  salts: np.ndarray, k: int = 8
                  ) -> List[Tuple[int, int]]:
    """Top-k ``(key, estimated_count)`` among the sampled candidates,
    hottest first."""
    cand = candidates(sample, sample_n)
    if not len(cand):
        return []
    est = estimate(counts, cand, salts)
    order = np.argsort(-est, kind="stable")[:k]
    return [(int(cand[i]), int(est[i])) for i in order]
