"""Events and event batches (port of ``repro.core.event``).

An ``EventBatch`` is a struct-of-arrays microbatch with a validity mask
and a fixed capacity.  ``value`` is a pytree (nested dicts) of tensors
with leading dim B.  Every transform is shape-static and runs on the
batch's device with no host sync, so a tick can be enqueued ahead of
the card.

``EventBatch``, and the queue and table dataclasses built on it, are
registered with ``torch.utils._pytree`` so ``tree_map`` walks engine
state the way ``jax.tree.map`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch._device import resolve_device, torch_dtype


def register_dataclass(cls):
    """Register a dataclass of tensors/pytrees as a pytree node (field
    order).  Returns ``cls`` so it can be used as a decorator."""
    names = [f.name for f in fields(cls)]
    pytree.register_pytree_node(
        cls,
        lambda obj: ([getattr(obj, n) for n in names], None),
        lambda children, _ctx: cls(*children),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
    return cls


def tree_map(fn, tree, *rests, is_leaf=None):
    return pytree.tree_map(fn, tree, *rests, is_leaf=is_leaf)


def flatten_sorted(tree, is_leaf=None):
    """Flatten in JAX's pytree order: dict keys sorted, lists and tuples
    in order.  Returns ``(leaves, structure)``; ``structure`` compares
    equal for trees of the same shape and rebuilds them in
    :func:`unflatten_sorted`."""
    leaves = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return None
        if isinstance(t, dict):
            ks = sorted(t)
            return ("dict", tuple(ks), tuple(walk(t[k]) for k in ks))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, len(t), tuple(walk(x) for x in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def unflatten_sorted(structure, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, meta, children = s
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        return tuple(built) if kind == "tuple" else list(built)

    return build(structure)


@register_dataclass
@dataclass
class EventBatch:
    sid: torch.Tensor     # int32 [B] stream id
    ts: torch.Tensor      # int32 [B] timestamp ticks
    key: torch.Tensor     # int32/int64 [B] event key
    value: Any            # pytree, leaves [B, ...]
    valid: torch.Tensor   # bool  [B]

    @property
    def capacity(self) -> int:
        return int(self.key.shape[0])

    @property
    def device(self) -> torch.device:
        return self.key.device

    def count(self) -> torch.Tensor:
        """Number of valid events, as an int32 0-d tensor (no sync)."""
        return self.valid.sum(dtype=torch.int32)

    # ---- constructors ----
    @staticmethod
    def empty(capacity: int, value_spec: Dict[str, Any], key_dtype=torch.int32,
              device=None) -> "EventBatch":
        """value_spec: pytree of (shape_suffix, dtype)."""
        dev = resolve_device(device)
        value = tree_map(
            lambda s: torch.zeros((capacity,) + tuple(s[0]),
                                  dtype=torch_dtype(s[1]), device=dev),
            value_spec, is_leaf=_is_spec_leaf)
        return EventBatch(
            sid=torch.zeros(capacity, dtype=torch.int32, device=dev),
            ts=torch.zeros(capacity, dtype=torch.int32, device=dev),
            key=torch.zeros(capacity, dtype=torch_dtype(key_dtype), device=dev),
            value=value,
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev))

    @staticmethod
    def of(key, value, *, ts=None, sid=None, valid=None, key_dtype=None,
           device=None) -> "EventBatch":
        """Build a batch from arrays, tensors or sequences.  Scalars for
        ``ts`` / ``sid`` / ``valid`` broadcast to the whole batch.
        ``device=None`` keeps the device of a ``key`` tensor, else
        ``cuda``."""
        if device is None and isinstance(key, torch.Tensor):
            dev = key.device
        else:
            dev = resolve_device(device)
        if key_dtype is None:
            # tensors and arrays keep their key width; bare sequences
            # default to int32
            kd = getattr(key, "dtype", None)
            if isinstance(kd, torch.dtype):
                key_dtype = kd if not kd.is_floating_point else torch.int32
            elif kd is not None and np.dtype(kd).kind in "iu":
                key_dtype = torch_dtype(kd)
            else:
                key_dtype = torch.int32
        key = _as_tensor(key, torch_dtype(key_dtype), dev)
        b = key.shape[0]

        def full(v, dt):
            return _as_tensor(v, dt, dev).broadcast_to((b,)).contiguous()

        return EventBatch(
            sid=(torch.zeros(b, dtype=torch.int32, device=dev) if sid is None
                 else full(sid, torch.int32)),
            ts=(torch.arange(b, dtype=torch.int32, device=dev) if ts is None
                else full(ts, torch.int32)),
            key=key,
            value=tree_map(lambda v: _as_tensor(v, None, dev), value),
            valid=(torch.ones(b, dtype=torch.bool, device=dev) if valid is None
                   else full(valid, torch.bool)),
        )

    # ---- transforms (all shape-static) ----
    def with_value(self, value) -> "EventBatch":
        return EventBatch(self.sid, self.ts, self.key, value, self.valid)

    def mask(self, keep) -> "EventBatch":
        return EventBatch(self.sid, self.ts, self.key, self.value,
                          self.valid & keep)

    def take(self, idx) -> "EventBatch":
        return tree_map(lambda a: a[idx], self)

    def pad_to(self, capacity: int) -> "EventBatch":
        b = self.capacity
        if b == capacity:
            return self
        if capacity < b:
            raise ValueError(f"pad_to({capacity}) below capacity {b}")

        def pad(a):
            z = torch.zeros((capacity - b,) + tuple(a.shape[1:]),
                            dtype=a.dtype, device=a.device)
            return torch.cat([a, z])

        return tree_map(pad, self)

    def sort_by_key_ts(self) -> "EventBatch":
        """Deterministic (key, ts) order; invalid rows sink to the end.
        Three stable argsorts give a lexicographic (key, ts) sort without
        widening the key.  The middle pass pushes invalid rows behind
        valid ones *within* the sink key group too, so a genuine event at
        the key dtype's max (the sink value) keeps its valid run
        contiguous — the updater paths write a run's total at its last
        valid row."""
        sink = torch.iinfo(self.key.dtype).max
        # the three passes compose their permutations; the batch is
        # gathered once, at the end
        order = torch.argsort(self.ts, stable=True)
        order = order[torch.argsort((~self.valid[order]).to(torch.uint8),
                                    stable=True)]
        invalid_key = torch.where(self.valid[order], self.key[order], sink)
        out = self.take(order[torch.argsort(invalid_key, stable=True)])
        # rewrite invalid rows' keys to the sink value so the key array is
        # truly sorted (downstream run detection relies on it)
        skey = torch.where(out.valid, out.key, torch.full_like(out.key, sink))
        return EventBatch(out.sid, out.ts, skey, out.value, out.valid)

    # ---- host-side helpers ----
    def to_host(self):
        """Valid events as numpy arrays (one device->host copy)."""
        v = self.valid.cpu().numpy()
        sel = np.nonzero(v)[0]
        host = lambda a: a.cpu().numpy()[sel]
        return {
            "sid": host(self.sid),
            "ts": host(self.ts),
            "key": host(self.key),
            "value": tree_map(host, self.value),
        }


def _as_tensor(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype if dtype is not None
                    else v.dtype)
    arr = np.asarray(v)
    if dtype is None:
        # host values default to 32 bits, as jnp.asarray gives them
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return torch.as_tensor(arr, device=device).to(dtype)


def _is_spec_leaf(x):
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], tuple))


# ---- value-spec utilities (shared by workflow validation) ----

def is_spec_leaf(x) -> bool:
    """A value_spec leaf is ``(shape_suffix_tuple, dtype)``."""
    return _is_spec_leaf(x)


def spec_of(value) -> Any:
    """value pytree with leading batch dim -> value_spec pytree."""
    return tree_map(lambda a: (tuple(a.shape[1:]), a.dtype), value)


def spec_matches(a, b) -> bool:
    """Structural equality of two value_specs: same pytree shape, same
    shape suffixes, same dtypes (numpy/torch dtype aliases normalized)."""
    la, ta = flatten_sorted(a, is_leaf=_is_spec_leaf)
    lb, tb = flatten_sorted(b, is_leaf=_is_spec_leaf)
    if ta != tb:
        return False
    for x, y in zip(la, lb):
        if not (_is_spec_leaf(x) and _is_spec_leaf(y)):
            return False
        if (tuple(x[0]) != tuple(y[0])
                or torch_dtype(x[1]) != torch_dtype(y[1])):
            return False
    return True


def format_spec(spec) -> str:
    """Compact human-readable value_spec (for validation errors)."""
    def leaf(s):
        return f"{str(torch_dtype(s[1])).replace('torch.', '')}{list(s[0])}"
    return str(tree_map(leaf, spec, is_leaf=_is_spec_leaf))


def concat(batches) -> EventBatch:
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *batches)


def compact(batch: EventBatch) -> EventBatch:
    """Move valid events to the front (stable)."""
    order = torch.argsort((~batch.valid).to(torch.uint8), stable=True)
    return batch.take(order)
