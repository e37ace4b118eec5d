"""deepseek-moe-16b — 28L d2048 16H (kv=16) vocab=102400; fine-grained MoE:
2 shared + 64 routed experts, top-6, expert d_ff=1408 (dense layer 0 uses
d_ff=10944). [arXiv:2401.06066; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400,
        n_experts=64, top_k=6, n_shared_experts=2,
        expert_d_ff=1408, shared_d_ff=2816, first_dense=True,
        act="silu", rope_theta=10_000.0, tie_embeddings=False)


def reduced() -> ArchConfig:
    return shrink(config())
