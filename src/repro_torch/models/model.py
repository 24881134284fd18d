"""Decoder model for the dense attention architectures (the slice of
``repro.models.model`` the offline wave runs).

Parameters are a plain dictionary: ``embed``/``lm_head`` matrices, the
final norm, and ``layers`` — one dictionary per transformer layer (the
reference stacks layers per plan segment for ``lax.scan``; eager PyTorch
has no use for that, and :mod:`repro_torch.convert` unstacks a reference
pytree into this form).  MoE, SSM and cross-attention layers, prefill
caches and decode steps are not ported yet (ROADMAP queue 1, item 11).

Public API:
  init_params(cfg, seed, device)    -> params dict
  forward(cfg, params, tokens, ctx) -> logits (B, S, V) float32
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from .layers import mlp, rms_norm, self_attention

SUPPORTED_KINDS = ("attn", "swa")


def _check_supported(cfg: ArchConfig) -> None:
    for spec in cfg.layer_sequence():
        if spec.kind not in SUPPORTED_KINDS or spec.ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer kind {spec.kind!r} with ffn "
                f"{spec.ffn!r} is not ported to repro_torch yet (ROADMAP "
                "queue 1, item 11)")


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict:
    """Random weights drawn on ``device`` from a seeded
    :class:`torch.Generator`, with the reference's init law (normal × 0.02
    for matrices, ones for norm scales).  The draws differ from the
    reference's ``jax.random`` ones; tests carry the reference's weights
    across with :func:`repro_torch.convert.params_from_jax`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(0.02)
        return w.to(dtype)

    d, hd = cfg.d_model, cfg.head_dim
    ones = lambda: torch.ones(d, device=dev, dtype=dtype)
    params: dict[str, Any] = {"embed": {"w": dense(cfg.vocab_size, d)}}
    layers = []
    for _ in cfg.layer_sequence():
        p = {"norm1": ones(),
             "wq": dense(d, cfg.num_heads * hd),
             "wk": dense(d, cfg.num_kv_heads * hd),
             "wv": dense(d, cfg.num_kv_heads * hd),
             "wo": dense(cfg.num_heads * hd, d)}
        if cfg.gated_mlp:
            p["w_gate"] = dense(d, cfg.d_ff)
        p["w_up"] = dense(d, cfg.d_ff)
        p["w_down"] = dense(cfg.d_ff, d)
        p["norm2"] = ones()
        layers.append(p)
    params["layers"] = layers
    params["final_norm"] = ones()
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense(d, cfg.vocab_size)}
    return params


@dataclasses.dataclass(frozen=True)
class RunCtx:
    cfg: ArchConfig
    compute_dtype: Any = torch.bfloat16

    @property
    def stream(self):
        """Residual stream dtype (the compute dtype, as in the reference's
        default)."""
        return self.compute_dtype


def _apply_ffn(spec: LayerSpec, p, h, ctx: RunCtx):
    hn = rms_norm(h, p["norm2"], ctx.cfg.norm_eps)
    return h + mlp(p, hn, ctx.cfg.gated_mlp, ctx.compute_dtype)


def _apply_elem(spec: LayerSpec, p, h, ctx: RunCtx, positions):
    """One transformer layer: attention (the flash kernel) then the MLP."""
    if spec.kind not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {spec.kind!r} is not ported yet (ROADMAP queue 1, "
            "item 11)")
    cfg = ctx.cfg
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + self_attention(p, hn, cfg, positions=positions, causal=True,
                           window=spec.window,
                           compute_dtype=ctx.compute_dtype)
    return _apply_ffn(spec, p, h, ctx)


def head(cfg: ArchConfig, params, h, ctx: RunCtx):
    """Final norm and LM head: (B, S, d) → float32 logits (B, S, V)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    return (h.to(ctx.compute_dtype) @ w.to(ctx.compute_dtype)).float()


def forward(cfg: ArchConfig, params, tokens, *, ctx: RunCtx | None = None):
    """tokens: (B, S) integer tensor on the params' device → logits
    (B, S, V) float32."""
    ctx = ctx or RunCtx(cfg)
    B, S = tokens.shape
    h = params["embed"]["w"][tokens].to(ctx.stream)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for spec, p in zip(cfg.layer_sequence(), params["layers"]):
        h = _apply_elem(spec, p, h, ctx, positions)
    return head(cfg, params, h, ctx)
