"""Recurrent blocks: the Mamba2 (SSD) mixer (the slice of
``repro.models.ssm`` that zamba2-7b runs; mLSTM and sLSTM come with the
xLSTM slice, ROADMAP queue 1, item 11).

Mamba2's SSD is an instance of *gated linear attention*:
S_t = a_t · S_{t-1} + k_t v_tᵀ,  y_t = q_t · S_t, with a per-(step, head)
scalar decay a_t ∈ (0, 1].  :func:`gla_chunked` is the chunkwise-parallel
form used for forward and prefill — here the call into the hand-written
scan kernel (its plain version on CPU tensors); :func:`gla_step` is the
O(1) recurrent form used for decode.

Shapes: q, k (B, L, H, Dk); v (B, L, H, Dv); log_decay (B, L, H) ≤ 0;
state (B, H, Dk, Dv) float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import gla_scan_op
from .layers import rms_norm


def gla_chunked(q, k, v, log_decay, *, chunk: int = 256, state_in=None):
    """Chunked scan from ``state_in`` (zeros when None) → (y, final
    state); L need not be a multiple of ``chunk``."""
    return gla_scan_op(q, k, v, log_decay, chunk=chunk, state_in=state_in)


def gla_step(q, k, v, log_decay, state):
    """One decode step.  q, k: (B, H, Dk); v: (B, H, Dv); log_decay:
    (B, H)."""
    a = torch.exp(log_decay.float())[..., None, None]
    state = state * a + torch.einsum("bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), state)
    return y, state


def gla_reference(q, k, v, log_decay, state_in=None):
    """Step-by-step oracle for tests: float32 (y, final state)."""
    B, L, H, Dk = q.shape
    S = (torch.zeros(B, H, Dk, v.shape[-1], device=q.device)
         if state_in is None else state_in)
    ys = []
    for t in range(L):
        y, S = gla_step(q[:, t], k[:, t], v[:, t], log_decay[:, t], S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``, with no
    linear cut-over (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, L, Ch); w: (K, Ch).  With ``state``
    (B, K-1, Ch) it uses and returns the rolling buffer (decode).  The K
    taps are summed in order from tap 0, as the reference sums them."""
    K = w.shape[0]
    pad = torch.zeros_like(x[:, :K - 1]) if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out, new_state


def mamba2_mix(p, x, cfg, *, compute_dtype=torch.bfloat16, chunk=256,
               state=None, step: bool = False):
    """Mamba2 mixer.  x: (B, L, d) (or (B, 1, d) with ``step=True``).

    p: in_proj (d, 2·di + 2·G·N + H), conv_w (K, di + 2·G·N), dt_bias (H),
       A_log (H), D (H), norm (di), out_proj (di, d).
    state: None or dict(conv=(B, K-1, ch), ssd=(B, H, N, P)).
    Returns (y, new_state)."""
    B, L, d = x.shape
    di, G, N = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    xc = x.to(compute_dtype)
    zxbcdt = xc @ p["in_proj"].to(compute_dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xbc, conv_state = _causal_conv(xbc.float(), p["conv_w"].float(),
                                   None if state is None else state["conv"])
    xbc = F.silu(xbc)
    xs, Bmat, Cmat = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])                     # (B,L,H)
    A = -torch.exp(p["A_log"].float())                            # (H,) < 0
    log_decay = dt * A                                            # (B,L,H)

    v = xs.reshape(B, L, H, P)            # a strided view: the kernel reads it
    rep = H // G
    # jnp.repeat: each group's row repeated for its rep consecutive heads
    Bh = Bmat.reshape(B, L, G, N).repeat_interleave(rep, dim=2)
    Ch = Cmat.reshape(B, L, G, N).repeat_interleave(rep, dim=2)
    k = Bh * dt[..., None]                                        # dt-scaled
    ssd_in = None if state is None else state["ssd"]
    if step:
        y, ssd = gla_step(Ch[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], ssd_in)
        y = y[:, None]
    else:
        y, ssd = gla_chunked(Ch, k, v, log_decay, chunk=chunk,
                             state_in=ssd_in)
    y = y + v.float() * p["D"][:, None]
    y = y.reshape(B, L, di)
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.norm_eps)
    out = y.to(compute_dtype) @ p["out_proj"].to(compute_dtype)
    return out.to(x.dtype), dict(conv=conv_state, ssd=ssd)


def mamba2_init_state(cfg, batch: int, device=None):
    di, G, N = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    ch = di + 2 * G * N
    return dict(conv=torch.zeros(batch, cfg.ssm_conv - 1, ch, device=device),
                ssd=torch.zeros(batch, cfg.ssm_heads, N, cfg.ssm_head_dim,
                                device=device))
