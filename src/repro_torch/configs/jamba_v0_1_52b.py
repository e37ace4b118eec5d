"""jamba-v0.1-52b — 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=65536;
hybrid Mamba+attention 1:7 interleave (attn at offset 4 of each 8-layer
block), MoE 16 experts top-2 on every other layer, no positional
embeddings (Mamba carries position).  We instantiate the Mamba layers with
our Mamba-2/SSD block (d_state=16) — deviation noted in DESIGN.md.
[arXiv:2403.19887; hf]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        n_experts=16, top_k=2, expert_d_ff=14336, moe_every=2,
        attn_period=8, attn_offset=4,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        use_rope=False, act="silu", tie_embeddings=False)


def reduced() -> ArchConfig:
    return shrink(config())
