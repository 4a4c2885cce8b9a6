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

The kernel has no backward yet (ROADMAP queue 1 item 22): where the
kernel would run and an input needs a gradient (training zamba2 on the
card), ``ssd`` raises rather than differentiating the plain version in
its place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import ref as _ref
from repro_torch.kernels.ssd_scan import kernel as _k

ssd_step = _ref.ssd_step


def ssd(q, k, v, log_a, *, chunk: int = 256, initial_state=None,
        impl: str = "auto"):
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
