"""phi-3-vision-4.2b — 32L d3072 32H (kv=32) d_ff=8192 vocab=32064;
phi3-mini backbone + CLIP frontend STUBBED (input_specs provides
precomputed patch embeddings, 576 patches @ 1024-d, projected in).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        vision_patches=576, vision_embed_dim=1024,
        act="silu", rope_theta=10_000.0, tie_embeddings=False)


def reduced() -> ArchConfig:
    return shrink(config())
