"""Assigned-architecture configs (10 archs) + registry access.

The port's own copy of the JAX package's ``configs`` (pure dataclasses,
copied as they are), so the port imports nothing of that package.  The
port's model stack takes every family of them
(:data:`repro_torch.models.transformer.FAMILIES`).
"""
from . import (gemma2_9b, phi3_medium_14b, yi_9b, qwen3_1_7b,
               deepseek_moe_16b, qwen3_moe_30b_a3b, whisper_base,
               mamba2_130m, phi3_vision_4_2b, jamba_v0_1_52b)
from .base import ArchConfig, LayerSpec, get_config, list_archs, shrink

ALL_ARCHS = [
    "gemma2-9b", "phi3-medium-14b", "yi-9b", "qwen3-1.7b",
    "deepseek-moe-16b", "qwen3-moe-30b-a3b", "whisper-base",
    "mamba2-130m", "phi-3-vision-4.2b", "jamba-v0.1-52b",
]

_MODULES = {
    "gemma2-9b": gemma2_9b, "phi3-medium-14b": phi3_medium_14b,
    "yi-9b": yi_9b, "qwen3-1.7b": qwen3_1_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b, "whisper-base": whisper_base,
    "mamba2-130m": mamba2_130m, "phi-3-vision-4.2b": phi3_vision_4_2b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}


def get_reduced(name: str) -> ArchConfig:
    return _MODULES[name].reduced()
