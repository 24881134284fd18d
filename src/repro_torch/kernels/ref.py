"""Oracles for the kernels (the allclose targets of the tests and of the
card check), counterparts of ``repro.kernels.ref``.

The attention kernels' plain versions live beside them
(:func:`~repro_torch.kernels.flash_attention.flash_attention_plain`, an
independent full-softmax formulation;
:func:`~repro_torch.kernels.decode_attention.decode_attention_plain`, the
model path's grouped softmax).  The oracles here are independent naive
forms: decode attention with the kv heads broadcast and no rounding of the
probabilities, the GLA scan as its step recurrence.  The sweep's oracle is
the production planner's own grid, as in ``repro.kernels.ref``."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k_cache, v_cache, pos, *, ring=False):
    """(B, 1, H, hd) × (B, L, KV, hd) → (B, 1, H, hd): full softmax in
    float32 over the slots valid at ``pos`` (``slot <= pos``, or ``slot <
    min(pos + 1, L)`` for a ring cache)."""
    h, hd = q.shape[2], q.shape[3]
    L, kv = k_cache.shape[1], k_cache.shape[2]
    k = k_cache.float().repeat_interleave(h // kv, dim=2)
    v = v_cache.float().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(hd)
    slot = torch.arange(L, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    valid = slot < torch.clamp(pos + 1, max=L) if ring else slot <= pos
    s = torch.where(valid, s, -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.to(q.dtype)


def gla_scan_ref(q, k, v, log_decay, state_in=None):
    """Step recurrence S_t = a_t S_{t-1} + k_t v_tᵀ, y_t = q_t S_t, in
    float32.  q, k: (B, L, H, Dk); v: (B, L, H, Dv); log_decay: (B, L, H).
    Returns (y in q's dtype, float32 state)."""
    from repro_torch.models.ssm import gla_reference
    y, S = gla_reference(q, k, v, log_decay, state_in)
    return y.to(q.dtype), S


def jdob_sweep_ref(profile, fleet, edge, t_free=0.0, rho=0.03e9,
                   device=None):
    """Oracle = the batched core's (ñ × f_e) grid."""
    from repro_torch.core.jdob import jdob_energy_grid
    return jdob_energy_grid(profile, fleet, edge, t_free=t_free, rho=rho,
                            device=device)
