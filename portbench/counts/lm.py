"""Model FLOPs of a decoder-only MoE transformer, counted from the shapes
of its configuration file (Hugging Face key names).

``active_params`` counts the weights one token multiplies by: per layer the
four attention projections, the dense MLP (gated: three matrices) on the
first ``first_k_dense_replace`` layers and on the others the router, the
``num_experts_per_tok`` routed experts and the shared experts; then the
output head.  The embedding lookup multiplies nothing and is left out.  A
token's FLOPs are twice that, plus its attention: 4 · heads · head_dim
FLOPs a layer for each key it attends (scores and the weighted sum), keys
from position 0 through its own.  Norms, RoPE, softmax and the router's
sort are left out.  Pads are not counted: a request counts its real prompt
tokens and the decode steps that produced its tokens after the first.
"""


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or
               cfg["hidden_size"] // cfg["num_attention_heads"])


def layer_params(cfg: dict, dense: bool) -> int:
    """Weights one token multiplies by in one layer."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    KH, hd = cfg["num_key_value_heads"], head_dim(cfg)
    attn = D * H * hd * 2 + D * KH * hd * 2          # q, o; k, v
    if dense:
        return attn + 3 * D * cfg["intermediate_size"]
    Fe = cfg["moe_intermediate_size"]
    routed = cfg["num_experts_per_tok"] * 3 * D * Fe
    shared = cfg["n_shared_experts"] * 3 * D * Fe
    return attn + D * cfg["n_routed_experts"] + routed + shared


def active_params(cfg: dict) -> int:
    L, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return (nd * layer_params(cfg, True) + (L - nd) * layer_params(cfg, False)
            + cfg["hidden_size"] * cfg["vocab_size"])


def attention_flops(cfg: dict, first: int, last: int) -> int:
    """Attention FLOPs of the positions ``first .. last - 1`` of one
    sequence, each attending the keys 0 .. its own position (causal)."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    return 4 * cfg["num_attention_heads"] * head_dim(cfg) * keys \
        * cfg["num_hidden_layers"]


def request_flops(cfg: dict, prompt_len: int, generated: int) -> int:
    """Useful FLOPs of one served request: its ``prompt_len`` real prompt
    positions (the prefill; the first token comes from its last row) and
    ``generated - 1`` decode steps."""
    n = prompt_len + max(generated - 1, 0)
    return 2 * active_params(cfg) * n + attention_flops(cfg, 0, n)
