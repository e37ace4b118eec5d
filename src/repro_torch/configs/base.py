"""Architecture config system.

Every assigned architecture is an :class:`ArchConfig`; the generic stack in
:mod:`repro_torch.models.transformer` interprets the *block pattern*: a repeating
unit of :class:`LayerSpec` entries (scanned ``n_repeats`` times) plus
optional unscanned prefix layers.  This keeps trace/compile time O(unit)
instead of O(depth) — required for the 80-compile dry-run and the right
call at 1000-node scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block unit."""
    kind: str = "attn"          # "attn" | "ssm"
    window: int = 0             # sliding-window size (attn; 0 = global)
    ffn: str = "dense"          # "dense" | "moe" | "none"
    cross: bool = False         # decoder cross-attention (enc-dec)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // num_heads

    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    local_global: bool = False  # alternate local/global layers (gemma2)
    post_norms: bool = False    # gemma2 post-block norms
    embed_scale: bool = False   # gemma2 √d_model embedding scaling

    # FFN / MoE
    mlp_gated: bool = True
    act: str = "silu"
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    first_dense: bool = False   # deepseek-moe: layer 0 dense
    moe_every: int = 1          # jamba: MoE each Nth layer
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False  # exact dispatch (C=T); decode/smoke paths

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    attn_period: int = 0        # jamba: attn layer every N layers ...
    attn_offset: int = 0        # ... at this offset within the period

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500     # stub audio frontend frame count

    # vlm
    vision_patches: int = 0     # stub CLIP patch count
    vision_embed_dim: int = 0   # stub patch-embedding dim (pre-projection)

    # positions
    use_rope: bool = True
    abs_pos_embed: bool = False  # whisper: absolute position embeddings

    # parallelism policy
    attn_sequence_parallel: bool = False
    # ^ context-parallel attention: replicate attention weights and shard
    #   the sequence on the model axis instead.  Used when the head counts
    #   don't divide the TP degree (phi3: 40H/10KV vs tp=16; whisper: 8H)
    #   — the sequence is the shardable axis, exactly the paper's 1-D
    #   stencil decomposition (DESIGN.md §4).

    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "block_outs"
    # "full"       — recompute the whole unit (3rd collective pass in bwd)
    # "block_outs" — save the post-collective attention/FFN block outputs:
    #                the backward pass never re-runs the TP all-reduces
    #                (≈ -1/3 collective bytes for ~67MB/layer saved)

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        q = self.vocab_pad_to
        return -(-self.vocab_size // q) * q

    def block_pattern(self) -> Tuple[Tuple[LayerSpec, ...],
                                     Tuple[LayerSpec, ...], int]:
        """Returns (prefix_layers, repeat_unit, n_repeats)."""
        if self.family == "ssm":
            return (), (LayerSpec(kind="ssm", ffn="none"),), self.num_layers
        if self.family == "hybrid":
            unit = []
            for i in range(self.attn_period):
                kind = "attn" if i == self.attn_offset else "ssm"
                ffn = ("moe" if self.n_experts and
                       (i % self.moe_every == self.moe_every - 1) else
                       "dense")
                unit.append(LayerSpec(kind=kind, ffn=ffn))
            reps, rem = divmod(self.num_layers, self.attn_period)
            assert rem == 0, "hybrid depth must be a multiple of the period"
            return (), tuple(unit), reps
        if self.n_experts:
            moe_spec = LayerSpec(kind="attn", ffn="moe")
            if self.first_dense:
                return ((LayerSpec(kind="attn", ffn="dense"),),
                        (moe_spec,), self.num_layers - 1)
            return (), (moe_spec,), self.num_layers
        if self.local_global:
            unit = (LayerSpec(kind="attn", window=self.sliding_window),
                    LayerSpec(kind="attn", window=0))
            reps, rem = divmod(self.num_layers, 2)
            assert rem == 0
            return (), unit, reps
        window = self.sliding_window
        return (), (LayerSpec(kind="attn", window=window),), self.num_layers

    def decoder_pattern(self):
        """Enc-dec models: the decoder unit (self-attn + cross + FFN)."""
        assert self.is_encoder_decoder
        return ((), (LayerSpec(kind="attn", cross=True),),
                self.num_layers)

    @property
    def sub_quadratic(self) -> bool:
        """Whether long-context (500k) decode is admissible (DESIGN.md)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.local_global:        # half the layers are sequence stencils
            return True
        return False


def shrink(cfg: ArchConfig) -> ArchConfig:
    """Derive the reduced smoke-test config: same family/pattern/features,
    tiny dimensions.  Exercised by per-arch CPU smoke tests; the full
    config is exercised only via the dry-run (no allocation)."""
    if cfg.family == "hybrid":
        layers = cfg.attn_period
    elif cfg.local_global:
        layers = 4
    elif cfg.first_dense:
        layers = 3
    else:
        layers = 2
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=160 if cfg.d_ff else 0,
        vocab_size=736,
        sliding_window=8 if cfg.sliding_window else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=2 if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        expert_d_ff=64 if cfg.expert_d_ff else 0,
        shared_d_ff=96 if cfg.shared_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=12 if cfg.is_encoder_decoder else cfg.encoder_seq,
        vision_patches=4 if cfg.vision_patches else 0,
        vision_embed_dim=24 if cfg.vision_embed_dim else 0,
        moe_dropless=True,
        dtype="float32",
        remat=False,
    )


def register(cfg_fn):
    """Decorator: register ``<arch>.py``'s config() under its name."""
    cfg = cfg_fn()
    _REGISTRY[cfg.name] = cfg_fn
    return cfg_fn


def get_config(name: str) -> ArchConfig:
    from . import ALL_ARCHS  # ensure modules imported
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    from . import ALL_ARCHS
    return sorted(_REGISTRY)
