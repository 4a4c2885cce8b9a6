"""Parameter initialization helpers (port of ``repro.models.init_utils``).

Every ``init`` in the model stack returns ``(params, specs)``: ``specs``
mirrors ``params`` with the JAX package's *logical* partition tuples
(``("fsdp", "tp")``), kept so the two trees line up leaf for leaf; the
port runs on one card and does not shard.  Draws come from an explicit
``torch.Generator`` on the device the parameters are made on.  The
scales are the JAX package's; the values are not (another generator), so
parity runs through converted weights (``repro_torch.convert``).
:class:`MetaGen` stands in for the generator where only shapes and
dtypes are wanted (``lm.param_specs``): every tensor is then made on the
``meta`` device, with no allocation and no draw.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]


class MetaGen:
    """A generator's stand-in for ``init`` functions that should only give
    shapes and dtypes: its ``device`` is ``meta``."""
    device = torch.device("meta")


def dense(gen: torch.Generator, shape: Sequence[int], spec: Spec, *,
          scale: Optional[float] = None, dtype=torch.float32):
    """Lecun-normal dense weight with its logical partition spec, on the
    generator's device."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    assert len(spec) == len(shape), (spec, shape)
    if isinstance(gen, MetaGen):
        return torch.empty(tuple(shape), dtype=dtype, device="meta"), spec
    w = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=gen.device) * std
    return w, spec


def zeros(shape: Sequence[int], spec: Spec, dtype=torch.float32,
          device=None):
    assert len(spec) == len(shape), (spec, shape)
    return torch.zeros(tuple(shape), dtype=dtype, device=device), spec


def ones(shape: Sequence[int], spec: Spec, dtype=torch.float32,
         device=None):
    assert len(spec) == len(shape), (spec, shape)
    return torch.ones(tuple(shape), dtype=dtype, device=device), spec


def split_tree(pairs: dict):
    """{name: (param, spec)} -> (params_dict, specs_dict)."""
    params = {k: v[0] for k, v in pairs.items()}
    specs = {k: v[1] for k, v in pairs.items()}
    return params, specs


def merge(*dicts_pairs):
    """Merge multiple (params, specs) tuples of dicts."""
    params, specs = {}, {}
    for p, s in dicts_pairs:
        params.update(p)
        specs.update(s)
    return params, specs
