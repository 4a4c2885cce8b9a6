"""Slate pytree <-> lane-aligned flat buffer for the fused update path
(port of ``repro.core.packing``).

The ``slate_update`` kernel works on one ``[C, D]`` f32 table; updaters
declare slates as pytrees of mixed-dtype leaves.  Each updater gets a
static *pack spec*: leaves flattened in JAX's pytree order (dict keys
sorted), each contributing ``prod(shape_suffix)`` f32 columns, with D
padded up to a multiple of ``LANE_ALIGN``.  The layout is the JAX
package's, column for column.

When the slate is a single f32 leaf whose width is already aligned,
``pack`` returns a view of the leaf, so the kernel updates the table's
own storage in place and ``unpack`` returns a view back; other layouts
copy (DESIGN.md section 2.3 "Known limitation").

Contract (``AssociativeUpdater.sum_mergeable`` / ``monoid``): combine
and merge are the same elementwise monoid on every leaf and a fresh
slate is all zeros — the monoid's identity.  Integer leaves ride in f32
lanes, exact up to 2**24.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch._device import torch_dtype
from repro_torch.core.event import flatten_sorted, unflatten_sorted

LANE_ALIGN = 8   # the kernel reads rows in 8-column (32-byte) tiles


def _is_spec_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


@dataclass(frozen=True)
class PackSpec:
    """Static layout: one (shape_suffix, dtype, width) per pytree leaf,
    in sorted pytree order, plus the padded row width D."""
    leaves: Tuple[Tuple[Tuple[int, ...], torch.dtype, int], ...]
    treedef: Any
    width: int          # sum of leaf widths (unpadded)
    padded_width: int   # D, multiple of LANE_ALIGN

    @property
    def d(self) -> int:
        return self.padded_width


def pack_spec(slate_spec) -> PackSpec:
    """Build the layout from an updater's ``slate_spec()`` pytree of
    ((shape_suffix), dtype) leaves."""
    leaves, treedef = flatten_sorted(slate_spec, is_leaf=_is_spec_leaf)
    rows = []
    width = 0
    for shape, dtype in leaves:
        dt = torch_dtype(dtype)
        if dt.itemsize > 4:
            raise TypeError(
                f"pack_spec: 64-bit slate leaf {dt} cannot ride the "
                f"fused path's f32 lanes exactly; keep slate values at "
                f"<= 32 bits (only *keys* widen under key_dtype=int64)")
        w = 1
        for s in shape:
            w *= int(s)
        rows.append((tuple(int(s) for s in shape), dt, w))
        width += w
    padded = max(LANE_ALIGN, -(-width // LANE_ALIGN) * LANE_ALIGN)
    return PackSpec(leaves=tuple(rows), treedef=treedef, width=width,
                    padded_width=padded)


def pack(tree, spec: PackSpec, *, pad: bool = True) -> torch.Tensor:
    """[N, ...] pytree -> [N, D] f32.  ``pad`` zero-fills the tail
    columns up to the lane-aligned width the kernel needs.  A single f32
    leaf that needs no padding comes back as a view of itself."""
    leaves, _ = flatten_sorted(tree)
    if len(leaves) != len(spec.leaves):
        raise ValueError(f"pack: {len(leaves)} leaves, spec has "
                         f"{len(spec.leaves)}")
    n = leaves[0].shape[0]
    cols = [l.reshape(n, w).to(torch.float32)
            for l, (_, _, w) in zip(leaves, spec.leaves)]
    if pad and spec.padded_width > spec.width:
        cols.append(torch.zeros((n, spec.padded_width - spec.width),
                                dtype=torch.float32, device=cols[0].device))
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def unpack(buf: torch.Tensor, spec: PackSpec):
    """[N, D] f32 -> [N, ...] pytree with the original leaf dtypes."""
    n = buf.shape[0]
    leaves: List[torch.Tensor] = []
    off = 0
    for shape, dtype, w in spec.leaves:
        col = buf[:, off:off + w].reshape((n,) + shape)
        leaves.append(col.to(dtype))
        off += w
    return unflatten_sorted(spec.treedef, leaves)
