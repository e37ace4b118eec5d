"""mamba2-130m — 24L d768, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        use_rope=False, tie_embeddings=True, norm_eps=1e-5)


def reduced() -> ArchConfig:
    return shrink(config())
