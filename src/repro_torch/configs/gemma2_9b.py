"""gemma2-9b — 42L d3584 16H (GQA kv=8) hd256 d_ff=14336 vocab=256000.
Local(4096-window)+global alternating attention, attn softcap 50, final
logit softcap 30, post-block norms, GeGLU. [arXiv:2408.00118; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=14336, vocab_size=256000,
        sliding_window=4096, local_global=True,
        attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, embed_scale=True,
        act="gelu", rope_theta=10_000.0, tie_embeddings=True)


def reduced() -> ArchConfig:
    return shrink(config())
