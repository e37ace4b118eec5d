"""yi-9b — 48L d4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA. [arXiv:2403.04652; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="yi-9b", family="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=11008, vocab_size=64000,
        act="silu", rope_theta=10_000.0, tie_embeddings=False)


def reduced() -> ArchConfig:
    return shrink(config())
