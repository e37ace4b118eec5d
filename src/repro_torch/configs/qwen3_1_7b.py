"""qwen3-1.7b — 28L d2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
QK-norm + GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b", family="dense",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=6144, vocab_size=151936,
        qk_norm=True, act="silu", rope_theta=1_000_000.0,
        tie_embeddings=True)


def reduced() -> ArchConfig:
    return shrink(config())
