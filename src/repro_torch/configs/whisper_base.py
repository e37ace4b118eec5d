"""whisper-base — enc-dec, 6+6L d512 8H d_ff=2048 vocab=51865; conv audio
frontend STUBBED per assignment (input_specs provides precomputed frame
embeddings, 1500 frames); absolute positions, non-gated GELU MLP.
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig, register, shrink


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865,
        is_encoder_decoder=True, encoder_layers=6, encoder_seq=1500,
        use_rope=False, abs_pos_embed=True,
        mlp_gated=False, act="gelu", tie_embeddings=True,
        # 8 heads < tp=16 -> context-parallel attention
        attn_sequence_parallel=True)


def reduced() -> ArchConfig:
    return shrink(config())
