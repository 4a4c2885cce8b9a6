"""Architecture registry (port of ``repro.configs.registry``): the ten
assigned architectures by name, at full size and at smoke-test size."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import (ModelConfig, MoEConfig, MLAConfig,
                                       SSMConfig, XLSTMConfig)

from repro_torch.configs import (deepseek_moe_16b, deepseek_v2_lite_16b,
                                 gemma3_1b, gemma_7b, llama_3_2_vision_11b,
                                 qwen1_5_110b, qwen2_0_5b, whisper_tiny,
                                 xlstm_350m, zamba2_1_2b)

_MODULES = (
    llama_3_2_vision_11b, qwen2_0_5b, qwen1_5_110b, gemma3_1b, gemma_7b,
    deepseek_moe_16b, deepseek_v2_lite_16b, zamba2_1_2b, whisper_tiny,
    xlstm_350m,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED: Dict[str, ModelConfig] = {m.CONFIG.name: m.REDUCED for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Smoke-test scale config of the same family (CPU-runnable)."""
    if name not in REDUCED:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REDUCED)}")
    return REDUCED[name]
