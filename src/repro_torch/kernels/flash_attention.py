"""Prefill flash attention: the hand-written CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:83``
(``flash_attention``).  The kernel is ``csrc/flash_attention.cu`` (see its
header for the design and what bounds it on an H100).

Layout is the reference kernel's: head-folded q ``(B·H, Sq, hd)`` and
k, v ``(B·KV, Sk, hd)`` with ``H = KV·n_rep``; query head ``bh`` reads kv
head ``bh // n_rep``.  On a CUDA tensor :func:`flash_attention` launches
the kernel or raises; on a CPU tensor it runs :func:`flash_attention_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import load_library

_NEG_INF = -1e30
HD_MAX = 128
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, n_rep: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes head-folded 3-d tensors")
    bh, _, hd = q.shape
    if k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if n_rep < 1 or k.shape[0] * n_rep != bh:
        raise ValueError(f"{bh} query heads are not {k.shape[0]} kv heads "
                         f"x n_rep={n_rep}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"{DTYPES} for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          n_rep: int = 1) -> torch.Tensor:
    """Full-softmax attention in float32 over the same layout and masks —
    the kernel's plain version (scores scaled through q, masked scores set
    to -1e30, result cast back to q's dtype)."""
    _check(q, k, v, n_rep)
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=0)
    vf = v.float().repeat_interleave(n_rep, dim=0)
    s = (q.float() * (1.0 / math.sqrt(hd))) @ kf.transpose(1, 2)
    iq = torch.arange(sq, device=q.device)[:, None]
    ik = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= iq >= ik
    if window is not None:
        mask &= iq - ik < window
    s = torch.where(mask, s, _NEG_INF)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def _launch(q, k, v, causal: bool, window: int | None,
            n_rep: int) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if not 1 <= hd <= HD_MAX:
        raise ValueError(f"head_dim {hd} outside the kernel's 1..{HD_MAX}")
    if bh > 65535:
        raise ValueError(f"{bh} head-folded rows exceed the launch grid")
    if window is not None and window < 1:
        raise ValueError(f"window must be ≥ 1, got {window}")
    lib = load_library("flash_attention")
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                bh, sq, sk, hd, n_rep, int(causal),
                -1 if window is None else int(window),
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    n_rep: int = 1) -> torch.Tensor:
    """q: (B·H, Sq, hd); k, v: (B·KV, Sk, hd) with H = KV·n_rep.  Returns
    (B·H, Sq, hd) in q's dtype (float32 or bfloat16).  CUDA tensors go
    through the hand-written kernel (``flash_attention.launches`` counts
    its launches); CPU tensors through :func:`flash_attention_plain`."""
    _check(q, k, v, n_rep)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     n_rep=n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, n_rep)


flash_attention.launches = 0
