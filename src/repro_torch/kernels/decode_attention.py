"""Single-token decode attention over a KV cache: the hand-written CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py:61``
(``decode_attention_kernel``) and stands in for
``src/repro/models/layers.py:161`` (``decode_attention``).  The kernel is
``csrc/decode_attention.cu`` (see its header for the design and what
bounds it on an H100).  It splits each (batch, kv head)'s cache over a
cluster of CTAs; :func:`split_plan` picks the cluster's size and each
CTA's share of the slots here, from L, B·KV and the SM count, never from
``pos``.

Layout is the model's: q ``(B, 1, H, hd)``, caches ``(B, L, KV, hd)`` with
``H = KV·n_rep``, query head ``h`` reading kv head ``h // n_rep``; ``pos``
is the current absolute position, a 0-d int32 tensor on the caches'
device (or a Python int).  Both versions follow the model path: the
normalised probabilities are rounded to the cache's dtype before the
product with V (a no-op for a float32 cache).  On a CUDA tensor
:func:`decode_attention` launches the kernel or raises; on a CPU tensor it
runs :func:`decode_attention_plain`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import load_library

_NEG_INF = -1e30
HD_MAX = 128
REP_MAX = 16
#: CTAs per cluster: the portable cluster size
SPLIT_MAX = 8
#: fewest cache slots worth a CTA of their own
MIN_SHARE = 4
#: a CTA's scores (n_rep x share float32) above this go to a scratch
#: buffer instead of shared memory
SCORE_SMEM_MAX = 64 * 1024
DTYPES = (torch.float32, torch.bfloat16)
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} / caches {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: need (B, 1, H, hd) and two "
                         "(B, L, KV, hd)")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"caches {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (KV must divide H)")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or k.dtype != v.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: q and the "
                        f"caches each one of {DTYPES}, the caches alike")
    if not (q.device == k.device == v.device):
        raise ValueError("q and the caches must be on one device")


def decode_attention_plain(q, k, v, pos):
    """The model path's ``decode_attention`` in PyTorch: grouped scores in
    float32, masked slots at -1e30, softmax, probabilities rounded to the
    cache's dtype, the product with V summed in float32, the result in q's
    dtype.  Slot j of the cache is valid when ``j < min(pos + 1, L)``: on
    0..L-1 that is both the full cache's rule (``j <= pos``) and the ring
    cache's."""
    _check(q, k, v)
    b, _, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, kv, h // kv, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bjkd->bkgj", q5, k.float()) * scale
    pos = torch.as_tensor(pos, device=q.device)
    valid = torch.arange(L, device=q.device) < torch.clamp(pos + 1, max=L)
    s = torch.where(valid, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def split_plan(L: int, bkv: int, n_rep: int, n_sm: int):
    """The kernel's launch geometry for a cache of ``L`` slots, ``bkv`` =
    B·KV (batch, kv head) pairs of ``n_rep`` query heads each, on a card of
    ``n_sm`` SMs: ``(nsplit, share, spill)``.  Each pair gets one cluster
    of ``nsplit`` CTAs (at most :data:`SPLIT_MAX`, and no more CTAs in all
    than the card has SMs while a pair has more than one, so that one wave
    runs them all), CTA ``r`` the slots ``[r·share, (r+1)·share)``, none of
    them empty; ``spill`` says that a CTA's ``n_rep × share`` float32
    scores exceed :data:`SCORE_SMEM_MAX` and go to a scratch buffer.  It
    depends on the shapes and the card only, never on ``pos``."""
    nsplit = max(1, min(SPLIT_MAX, n_sm // bkv, -(-L // MIN_SHARE)))
    share = -(-L // nsplit)
    nsplit = -(-L // share)
    return nsplit, share, 4 * n_rep * share > SCORE_SMEM_MAX


def _launch(q, k, v, pos):
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension is not contiguous")
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError(f"pos must be one int32, got {pos.dtype} "
                        f"{tuple(pos.shape)}")
    b, _, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    if hd > HD_MAX:
        raise ValueError(f"head_dim {hd} above the kernel's {HD_MAX}")
    if n_rep > REP_MAX:
        raise ValueError(f"{n_rep} query heads per kv head, above the "
                         f"kernel's {REP_MAX}")
    lib = load_library("decode_attention")
    fn = getattr(lib, f"decode_attention_{_NAMES[q.dtype]}_"
                      f"{_NAMES[k.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3])
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, share, spill = split_plan(L, b * kv, n_rep, n_sm)
    scratch = (torch.empty(b * kv * nsplit * n_rep * share,
                           dtype=torch.float32, device=q.device)
               if spill else None)
    o = torch.empty(b, 1, h, hd, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                o.data_ptr(), b, kv, L, hd, n_rep, 1.0 / math.sqrt(hd),
                strides, stream, nsplit, share,
                None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return o


def decode_attention(q, k, v, pos):
    """q: (B, 1, H, hd); k, v: (B, L, KV, hd) caches, full or ring (the
    same slots are valid in both); pos: the current absolute position (0-d
    int32 tensor on the caches' device, or an int).  Returns (B, 1, H, hd)
    in q's dtype.  CUDA tensors go through the hand-written kernel
    (``decode_attention.launches`` counts its launches), which reads
    ``pos`` on the card; CPU tensors through
    :func:`decode_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(int(pos), dtype=torch.int32, device=q.device)
    return _launch(q, k, v, pos)


decode_attention.launches = 0
