"""Apply-time context threaded through model blocks (port of
``repro.models.context``).

Carries the phase (train/prefill/decode), positions, the decode write
index, the auxiliary memories cross-attention reads (whisper's encoder
output, llama-3.2-vision's image embeddings), the compute dtype, and on a
mesh the sharding-constraint hook (``constrain``, set by the step makers
from ``distributed.sharding.make_constrainer``; the identity without a
mesh), the ``DeviceMesh`` and the logical -> mesh-axis rules, which the
MoE layer reads for its expert-parallel path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


def _identity_constrain(x, _spec):
    return x


@dataclass(frozen=True)
class Ctx:
    phase: str = "train"                        # train | prefill | decode
    positions: Optional[torch.Tensor] = None    # [B, S] absolute positions
    cache_len: int = 0                          # static max cache length
    cur_index: Optional[torch.Tensor] = None    # [B] per-request write index
    enc_memory: Optional[torch.Tensor] = None   # [B, S_enc, D] (whisper)
    image_embeds: Optional[torch.Tensor] = None  # [B, n_img, D] (vlm)
    cdtype: torch.dtype = torch.bfloat16        # compute dtype
    # constrain(x, logical_spec_tuple) -> x
    constrain: Callable = _identity_constrain
    mesh: Optional[Any] = None                  # DeviceMesh
    rules: Optional[Any] = None                 # sharding.rules_for(...)

    @property
    def is_decode(self) -> bool:
        return self.phase == "decode"

    def replace(self, **kw) -> "Ctx":
        return dataclasses.replace(self, **kw)
