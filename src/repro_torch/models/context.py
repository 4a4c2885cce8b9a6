"""Apply-time context threaded through model blocks (port of
``repro.models.context``).

Carries the phase (train/prefill/decode), positions, the decode write
index, the auxiliary memories cross-attention reads (whisper's encoder
output, llama-3.2-vision's image embeddings) and the compute dtype.  The
JAX package also carries a sharding-constraint hook and a mesh (the port
runs on one card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Ctx:
    phase: str = "train"                        # train | prefill | decode
    positions: Optional[torch.Tensor] = None    # [B, S] absolute positions
    cache_len: int = 0                          # static max cache length
    cur_index: Optional[torch.Tensor] = None    # [B] per-request write index
    enc_memory: Optional[torch.Tensor] = None   # [B, S_enc, D] (whisper)
    image_embeds: Optional[torch.Tensor] = None  # [B, n_img, D] (vlm)
    cdtype: torch.dtype = torch.bfloat16        # compute dtype

    @property
    def is_decode(self) -> bool:
        return self.phase == "decode"

    def replace(self, **kw) -> "Ctx":
        return dataclasses.replace(self, **kw)
