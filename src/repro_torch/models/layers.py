"""Attention / MLP / norm building blocks (plain functions on tensors).

The port keeps ``repro.models.layers``' names and tensor layouts:
activations are (B, S, d), attention tensors (B, S, H, hd) with GQA
K/V (B, S, KV, hd).  :func:`blockwise_attention` — the reference's
online-softmax scan — is here the call into the hand-written flash
kernel (its plain PyTorch version on CPU tensors).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention_op


def rms_norm(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(q, k, v, *, causal: bool,
                        window: int | None = None):
    """Prefill attention, q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with
    KV | H.  Returns (B, Sq, H, hd), accumulated in float32."""
    return flash_attention_op(q, k, v, causal=causal, window=window)


def self_attention(p: dict, x, cfg, *, positions, causal=True, window=None,
                   compute_dtype=torch.bfloat16):
    """Full self-attention sub-layer (projections + attention)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    q = (xc @ p["wq"].to(compute_dtype)).reshape(b, s, h, hd)
    k = (xc @ p["wk"].to(compute_dtype)).reshape(b, s, kv, hd)
    v = (xc @ p["wv"].to(compute_dtype)).reshape(b, s, kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=causal, window=window)
    return (o.reshape(b, s, h * hd) @ p["wo"].to(compute_dtype)).to(x.dtype)


def mlp(params: dict, x, gated: bool, compute_dtype=torch.bfloat16):
    xc = x.to(compute_dtype)
    if gated:
        g = F.silu(xc @ params["w_gate"].to(compute_dtype))
        u = xc @ params["w_up"].to(compute_dtype)
        return ((g * u) @ params["w_down"].to(compute_dtype)).to(x.dtype)
    u = F.gelu(xc @ params["w_up"].to(compute_dtype), approximate="tanh")
    return (u @ params["w_down"].to(compute_dtype)).to(x.dtype)
