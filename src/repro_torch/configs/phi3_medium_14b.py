"""phi3-medium-14b — 40L d5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
RoPE + SwiGLU + GQA. [arXiv:2404.14219; unverified]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        head_dim=128, d_ff=17920, vocab_size=100352,
        act="silu", rope_theta=10_000.0, tie_embeddings=False,
        # 40 heads / 10 KV heads don't divide tp=16 -> context-parallel
        # attention (sequence sharded on the model axis)
        attn_sequence_parallel=True)


def reduced() -> ArchConfig:
    return shrink(config())
