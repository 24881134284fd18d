"""Attention / MLP / norm building blocks (plain functions on tensors).

The port keeps ``repro.models.layers``' names and tensor layouts:
activations are (B, S, d), attention tensors (B, S, H, hd) with GQA
K/V (B, S, KV, hd).  :func:`blockwise_attention` — the reference's
online-softmax scan — is here the call into the hand-written flash
kernel, and :func:`decode_attention` the call into the hand-written decode
kernel (each one's plain PyTorch version on CPU tensors).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import decode_attention_op, flash_attention_op


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


def decode_attention(q, k_cache, v_cache, *, pos, window=None):
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, hd); caches: (B, L, KV, hd); ``pos``: the current absolute
    position, a 0-d int32 tensor on the caches' device.  For ring caches
    L == window and every slot is valid once pos >= L; for full caches
    slots >= pos + 1 are masked.  Returns (B, 1, H, hd) in q's dtype."""
    return decode_attention_op(q, k_cache, v_cache, pos,
                               ring=window is not None)


def qkv_proj(p: dict, x, cfg, positions, compute_dtype=torch.bfloat16):
    """An attention sub-layer's projections: q (B, S, H, hd) and k, v
    (B, S, KV, hd) in the compute dtype, RoPE applied to q and k."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    q = (xc @ p["wq"].to(compute_dtype)).reshape(b, s, h, hd)
    k = (xc @ p["wk"].to(compute_dtype)).reshape(b, s, kv, hd)
    v = (xc @ p["wv"].to(compute_dtype)).reshape(b, s, kv, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attn_out(p: dict, o, dtype, compute_dtype=torch.bfloat16):
    """The output projection of attention heads o (B, S, H, hd) → (B, S, d)
    in ``dtype``."""
    b, s = o.shape[:2]
    return (o.reshape(b, s, -1).to(compute_dtype)
            @ p["wo"].to(compute_dtype)).to(dtype)


def mlp(params: dict, x, gated: bool, compute_dtype=torch.bfloat16):
    xc = x.to(compute_dtype)
    if gated:
        g = F.silu(xc @ params["w_gate"].to(compute_dtype))
        u = xc @ params["w_up"].to(compute_dtype)
        return ((g * u) @ params["w_down"].to(compute_dtype)).to(x.dtype)
    u = F.gelu(xc @ params["w_up"].to(compute_dtype), approximate="tanh")
    return (u @ params["w_down"].to(compute_dtype)).to(x.dtype)
