"""Plain reference of a DeepSeekMoE decoder (arXiv:2401.06066), in PyTorch.

Written from the published architecture and the configuration file (Hugging
Face key names), not from the port: it imports nothing of the port or of the
JAX package, and takes only the weights the benchmark drew, by name, and
token ids.  A layer is pre-norm: x + attention(rms(x)), then x + ffn(rms(x)).

* RMS norm: x / sqrt(mean(x²) + eps) times (1 + scale), scale stored as 0.
* Attention: multi-head, rotary positions on q and k (the two halves of
  each head rotated, frequencies theta^(-2i/hd)), causal softmax(q·kᵀ /
  sqrt(hd)), then the output projection.
* The first ``first_k_dense_replace`` layers: a gated MLP, down(silu(x·gate)
  · (x·up)).  The others: a softmax router over ``n_routed_experts``, the
  top ``num_experts_per_tok`` experts each token (weights renormalised to
  sum 1 where ``norm_topk_prob``), each expert a gated MLP of width
  ``moe_intermediate_size``, plus the shared experts, held as one gated MLP
  of ``n_shared_experts`` times that width.
* The head: the final norm, then x · unembed.

Everything runs in float32 with TF32 off, one layer at a time over all the
sequences, each layer's weights cast up from the served bfloat16 when the
layer is reached.  ``quant="fp8"`` is the control: every matrix product's
operands rounded to float8 e4m3 (a scale a row of activations and a scale
an output column of weights) before the float32 product.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def matmul(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    """x (T, K) · w (K, N) in float32, or through float8 operands."""
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0 .. S-1."""
    S, _, hd = x.shape
    freqs = torch.as_tensor(
        (1.0 / theta ** (np.arange(0, hd, 2) / hd)).astype(np.float32),
        device=x.device)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gated_mlp(x, gate, up, down, quant):
    return matmul(F.silu(matmul(x, gate, quant)) * matmul(x, up, quant),
                  down, quant)


def attention(x, w: dict, cfg: dict, quant):
    S, D = x.shape
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H if not cfg.get("head_dim") else cfg["head_dim"]
    q = matmul(x, w["wq"].reshape(D, H * hd), quant).view(S, H, hd)
    k = matmul(x, w["wk"].reshape(D, KH * hd), quant).view(S, KH, hd)
    v = matmul(x, w["wv"].reshape(D, KH * hd), quant).view(S, KH, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))          # (H, S, hd)
    if quant == "fp8":
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -2)
    scores = (q @ k.transpose(1, 2)) / math.sqrt(hd)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    del scores
    if quant == "fp8":
        p = fp8(p, -1)
    o = (p @ v).transpose(0, 1).reshape(S, H * hd)
    return matmul(o, w["wo"].reshape(H * hd, D), quant)


def moe(x, w: dict, cfg: dict, quant):
    """Routed experts (token choice, top k of a softmax) plus the shared
    experts."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ w["router"], dim=-1)      # the router in f32
    top_p, top_i = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = gated_mlp(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e],
                       quant)
        y.index_add_(0, tok, ye * top_p[tok, slot][:, None])
    if cfg["n_shared_experts"]:
        y = y + gated_mlp(x, w["shared.gate"], w["shared.up"],
                          w["shared.down"], quant)
    return y


def layer_weights(weights: dict, i: int) -> dict:
    """Layer ``i``'s weights by short name, in float32."""
    pre = f"layers.{i}."
    out = {}
    for name, t in weights.items():
        if name.startswith(pre):
            short = name[len(pre):]
            for grp in ("attn.", "moe.", "mlp."):
                if short.startswith(grp):
                    short = short[len(grp):]
            out[short] = t.float()
    return out


@torch.no_grad()
def logits_at(cfg: dict, weights: dict, seqs: list, rows: list,
              quant=None) -> list:
    """For each token sequence ``seqs[j]`` (a 1-D int tensor on the
    weights' device), the float32 logits (len(rows[j]), V) at the
    positions ``rows[j]`` of a causal forward over the whole sequence."""
    eps = cfg["rms_norm_eps"]
    with no_tf32():
        xs = [weights["embed"][s].float() for s in seqs]
        for i in range(cfg["num_hidden_layers"]):
            w = layer_weights(weights, i)
            dense = i < cfg["first_k_dense_replace"]
            for j, x in enumerate(xs):
                x = x + attention(rms(x, w["ln1"], eps), w, cfg, quant)
                h = rms(x, w["ln2"], eps)
                if dense:
                    x = x + gated_mlp(h, w["gate"], w["up"], w["down"], quant)
                else:
                    x = x + moe(h, w, cfg, quant)
                xs[j] = x
            del w
        head = weights["unembed"].float()
        out = []
        for x, r in zip(xs, rows):
            h = rms(x[r], weights["final_norm"].float(), eps)
            out.append(matmul(h, head, quant))
        return out
