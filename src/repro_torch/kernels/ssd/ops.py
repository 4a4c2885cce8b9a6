"""Dispatching wrapper for the chunked SSD linear recurrence (port of
``repro/kernels/ssd/ops.py``).

``impl``:
  - "auto": the ``ssd_scan`` CUDA kernel for a CUDA ``q`` whose shape the
    kernel's ``supported()`` takes and no ``initial_state`` (the JAX
    package's own rule for its Pallas kernel), else the plain version
  - "cuda": the kernel (raises for CPU tensors, a shape it cannot take,
    or an ``initial_state``)
  - "ref": the plain PyTorch version

``ssd_step``, the decode recurrence, has no kernel in either package.

On DTensors (a mesh) either route runs on each rank's local shards
(``kernels/_local.py``): the batch and head shards the four inputs
share are kept.  A sequence split across ranks is gathered first for
the plain version and raises where the kernel would run: the scan's
carried state would cross ranks (ROADMAP queue 1 item 15d).

The kernel has no backward yet (ROADMAP queue 1 item 22): where the
kernel would run and an input needs a gradient (training zamba2 on the
card), ``ssd`` raises rather than differentiating the plain version in
its place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _local
from repro_torch.kernels.ssd import ref as _ref
from repro_torch.kernels.ssd_scan import kernel as _k

ssd_step = _ref.ssd_step


def _on_shards(q, k, v, log_a, chunk, initial_state, impl):
    from torch.distributed.tensor import Shard
    if impl == "cuda" or (impl == "auto" and q.is_cuda
                          and initial_state is None):
        _local.refuse_split("ssd_scan", q, 1, "sequence")
    pls = _local.common_placements((q, k, v, log_a), ((0, 2),) * 4)
    # states [B,H,N,P]: q's head dim 2 is their dim 1
    fp = tuple(Shard(1) if p == Shard(2) else p for p in pls[2])
    if _local.is_dtensor(initial_state):
        initial_state = _local.to_local(initial_state, fp)
    y, final = ssd(*(_local.to_local(t, pl) for t, pl in
                     zip((q, k, v, log_a), pls)), chunk=chunk,
                   initial_state=initial_state, impl=impl)
    return _local.from_local(y, q, pls[2]), _local.from_local(final, q, fp)


def ssd(q, k, v, log_a, *, chunk: int = 256, initial_state=None,
        impl: str = "auto"):
    if _local.is_dtensor(q):
        return _on_shards(q, k, v, log_a, chunk, initial_state, impl)
    if impl == "auto":
        impl = "cuda" if (q.is_cuda and initial_state is None
                          and _k.supported(q, k, v)) else "ref"
    if impl == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, log_a)):
            raise NotImplementedError(
                "ssd_scan kernel: no backward kernel yet, so the chunked "
                "SSD scan cannot be trained on the card (ROADMAP queue 1 "
                "item 22)")
        if initial_state is not None:
            raise ValueError("ssd_scan kernel: starts from a zero state "
                             "only (initial_state must be None)")
        return _k.ssd_scan(q, k, v, log_a, chunk=chunk)
    if impl != "ref":
        raise ValueError(f"unknown ssd impl {impl!r}")
    return _ref.ssd(q, k, v, log_a, chunk=chunk,
                    initial_state=initial_state)
