"""qwen3-moe-30b-a3b — 48L d2048 32H (GQA kv=4) vocab=151936; 128 experts
top-8, expert d_ff=768, QK-norm. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        n_experts=128, top_k=8, expert_d_ff=768,
        qk_norm=True, act="silu", rope_theta=1_000_000.0,
        tie_embeddings=False)


def reduced() -> ArchConfig:
    return shrink(config())
