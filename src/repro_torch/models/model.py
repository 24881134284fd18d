"""Decoder model over the attention and Mamba2 layer kinds (the slice of
``repro.models.model`` that the offline wave and token decode run).

Parameters are a plain dictionary: ``embed``/``lm_head`` matrices, the
final norm, and ``layers`` — one dictionary per layer (the reference stacks
layers per plan segment for ``lax.scan``; eager PyTorch has no use for
that, and :mod:`repro_torch.convert` unstacks a reference pytree into this
form).  The decode cache is likewise a per-layer list beside a device
``pos``.  MoE, cross-attention and the xLSTM blocks are not ported yet
(ROADMAP queue 1, item 11).

Public API:
  init_params(cfg, seed, device)                   -> params dict
  forward(cfg, params, tokens, ctx)                -> logits (B, S, V) f32
  init_cache(cfg, batch, cache_len, dtype, device) -> decode cache
  prefill(cfg, params, tokens, cache_len, ...)     -> (logits, cache)
  decode_step(cfg, params, cache, tokens, ctx)     -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from .layers import (attn_out, blockwise_attention, decode_attention, mlp,
                     qkv_proj, rms_norm)
from .ssm import mamba2_init_state, mamba2_mix

#: layer kinds and FFNs of the reference that the port does not run yet
NOT_PORTED = {"moe": "the MoE FFN", "cross": "cross-attention",
              "mlstm": "the mLSTM block", "slstm": "the sLSTM block"}


def _check_supported(cfg: ArchConfig) -> None:
    for spec in cfg.layer_sequence():
        for part in (spec.kind, spec.ffn):
            if part in NOT_PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: {NOT_PORTED[part]} ({part!r}) is not "
                    "ported to repro_torch yet (ROADMAP queue 1, item 11)")


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict:
    """Random weights drawn on ``device`` from a seeded
    :class:`torch.Generator`, with the reference's init law (normal × 0.02
    for matrices, × 0.2 for Mamba2's conv taps, ones for norm scales and
    D, zeros for dt_bias, A_log = log(linspace(1, 16, H)); A_log, dt_bias
    and D float32 whatever ``dtype``).  The draws differ from the
    reference's ``jax.random`` ones; tests carry the reference's weights
    across with :func:`repro_torch.convert.params_from_jax`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(*shape, scale=0.02):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(scale)
        return w.to(dtype)

    d, hd = cfg.d_model, cfg.head_dim
    ones = lambda n=d, dt=dtype: torch.ones(n, device=dev, dtype=dt)
    params: dict[str, Any] = {"embed": {"w": dense(cfg.vocab_size, d)}}
    layers = []
    for spec in cfg.layer_sequence():
        p = {"norm1": ones()}
        if spec.kind == "mamba2":
            di, G, N = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
            H = cfg.ssm_heads
            p["in_proj"] = dense(d, 2 * di + 2 * G * N + H)
            p["conv_w"] = dense(cfg.ssm_conv, di + 2 * G * N, scale=0.2)
            p["dt_bias"] = torch.zeros(H, device=dev)
            p["A_log"] = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
            p["D"] = ones(H, torch.float32)
            p["norm"] = ones(di)
            p["out_proj"] = dense(di, d)
        else:
            p["wq"] = dense(d, cfg.num_heads * hd)
            p["wk"] = dense(d, cfg.num_kv_heads * hd)
            p["wv"] = dense(d, cfg.num_kv_heads * hd)
            p["wo"] = dense(cfg.num_heads * hd, d)
        if spec.ffn == "dense":
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
    ssm_chunk: int = 256

    @property
    def stream(self):
        """Residual stream dtype (the compute dtype, as in the reference's
        default)."""
        return self.compute_dtype


def _apply_ffn(spec: LayerSpec, p, h, ctx: RunCtx):
    if spec.ffn == "none":
        return h
    hn = rms_norm(h, p["norm2"], ctx.cfg.norm_eps)
    return h + mlp(p, hn, ctx.cfg.gated_mlp, ctx.compute_dtype)


def _fill_kv(spec: LayerSpec, cache, k, v):
    """Write a prompt's K/V (B, S, KV, hd) into a layer's zeroed cache, in
    place: the first min(S, L) positions, or for a ring cache shorter than
    the prompt the last L positions placed so that slot == pos % L."""
    L, s = cache["k"].shape[1], k.shape[1]
    if spec.window and s > L:
        start = (s - L) % L
        k, v = (torch.roll(x[:, -L:], start, dims=1) for x in (k, v))
    cache["k"][:, :min(s, L)] = k[:, :L]
    cache["v"][:, :min(s, L)] = v[:, :L]
    return cache


def _layer(spec: LayerSpec, p, h, ctx: RunCtx, positions, cache=None):
    """One layer on hidden states h (B, S, d): the mixer (flash attention
    or the Mamba2 scan), then the FFN.  With a layer's fresh cache
    (prefill) it also fills that cache from this prompt; returns
    ``(h, cache)``."""
    cfg = ctx.cfg
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    if spec.kind == "mamba2":
        out, state = mamba2_mix(p, hn, cfg, compute_dtype=ctx.compute_dtype,
                                chunk=ctx.ssm_chunk, state=cache)
        cache = None if cache is None else state
    else:
        q, k, v = qkv_proj(p, hn, cfg, positions, ctx.compute_dtype)
        o = blockwise_attention(q, k, v, causal=True, window=spec.window)
        out = attn_out(p, o, h.dtype, ctx.compute_dtype)
        if cache is not None:
            cache = _fill_kv(spec, cache, k, v)
    return _apply_ffn(spec, p, h + out, ctx), cache


def _apply_elem(spec: LayerSpec, p, h, ctx: RunCtx, positions):
    """One layer of the forward pass (no cache)."""
    return _layer(spec, p, h, ctx, positions)[0]


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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _elem_cache(spec: LayerSpec, cfg: ArchConfig, batch: int, cache_len: int,
                dtype, device):
    if spec.kind == "mamba2":
        return mamba2_init_state(cfg, batch, device)
    L = min(cache_len, spec.window) if spec.window else cache_len
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed decode cache on ``device``: ``layers``, one entry per layer —
    K/V (B, L, KV, hd) in ``dtype`` for attention (L = the window for a
    sliding-window layer, a ring), float32 conv and SSD states for Mamba2
    — and ``pos``, a 0-d int32 tensor on the device."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return dict(layers=[_elem_cache(spec, cfg, batch, cache_len, dtype, dev)
                        for spec in cfg.layer_sequence()],
                pos=torch.zeros((), dtype=torch.int32, device=dev))


def _decode_elem(spec: LayerSpec, p, cache, h, ctx: RunCtx, pos):
    cfg = ctx.cfg
    hn = rms_norm(h, p["norm1"], cfg.norm_eps)
    if spec.kind == "mamba2":
        out, cache = mamba2_mix(p, hn, cfg, compute_dtype=ctx.compute_dtype,
                                state=cache, step=True)
    else:
        L = cache["k"].shape[1]
        q, k, v = qkv_proj(p, hn, cfg, pos.expand(h.shape[0], 1),
                           ctx.compute_dtype)
        slot = pos % L if spec.window else torch.clamp(pos, max=L - 1)
        slot = slot.long().view(1)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        o = decode_attention(q, cache["k"], cache["v"], pos=pos,
                             window=spec.window)
        out = attn_out(p, o, h.dtype, ctx.compute_dtype)
    return _apply_ffn(spec, p, h + out, ctx), cache


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                ctx: RunCtx | None = None):
    """One token step.  tokens: (B, 1) on the params' device → (logits
    (B, 1, V) float32, cache).

    Unlike the reference, which returns a new cache, each attention layer
    writes its new K/V slot IN PLACE into the given cache (``index_copy_``
    at the device slot ``pos % L`` for a ring, ``min(pos, L - 1)``
    otherwise), so the given and the returned cache share those tensors;
    Mamba2 states and ``pos`` are new tensors.  ``pos`` never leaves the
    device: no step waits for the host."""
    ctx = ctx or RunCtx(cfg)
    resolve_device(params["embed"]["w"].device)
    pos = cache["pos"]
    h = params["embed"]["w"][tokens].to(ctx.stream)
    layers = []
    for spec, p, c in zip(cfg.layer_sequence(), params["layers"],
                          cache["layers"]):
        h, c = _decode_elem(spec, p, c, h, ctx, pos)
        layers.append(c)
    return head(cfg, params, h, ctx), dict(layers=layers, pos=pos + 1)


def prefill(cfg: ArchConfig, params, tokens, *, cache_len: int | None = None,
            cache_dtype=torch.bfloat16, ctx: RunCtx | None = None):
    """Run the prompt tokens (B, S) and build the decode cache, in one
    pass (the reference runs ``forward`` and then a second pass per layer;
    both compute the same function).  The K/V cache is ``cache_dtype`` —
    bfloat16 by default, as the reference's ``init_cache`` — on the
    params' device.  Returns (logits (B, S, V) float32, cache with
    ``pos`` = S)."""
    ctx = ctx or RunCtx(cfg)
    B, S = tokens.shape
    dev = resolve_device(params["embed"]["w"].device)
    cache = init_cache(cfg, B, cache_len or S, dtype=cache_dtype, device=dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    h = params["embed"]["w"][tokens].to(ctx.stream)
    layers = []
    for spec, p, c in zip(cfg.layer_sequence(), params["layers"],
                          cache["layers"]):
        h, c = _layer(spec, p, h, ctx, positions, c)
        layers.append(c)
    return head(cfg, params, h, ctx), dict(
        layers=layers, pos=torch.full((), S, dtype=torch.int32, device=dev))
