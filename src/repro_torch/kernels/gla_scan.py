"""Chunked gated-linear-attention scan: the hand-written CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/gla_scan.py:64``
(``gla_scan``) and stands in for ``src/repro/models/ssm.py:22``
(``gla_chunked``), which the Pallas kernel mirrors.  The kernel is
``csrc/gla_scan.cu`` (see its header for the design and what bounds it on
an H100).

Layout is the model's: q, k ``(B, L, H, Dk)``, v ``(B, L, H, Dv)``,
log_decay ``(B, L, H)`` ≤ 0, an optional float32 ``state_in``
``(B, H, Dk, Dv)``.  Returns ``(y, state)``: y ``(B, L, H, Dv)`` in q's
dtype, the final state float32.  Beyond the Pallas kernel and as
``gla_chunked`` does, L need not be a multiple of ``chunk`` and the scan
may start from a state.  On a CUDA tensor :func:`gla_scan` launches the
kernel or raises; on a CPU tensor it runs :func:`gla_scan_plain`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

D_MAX = 64
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, log_decay, state_in, chunk: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q/k/v shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}: need (B, L, H, Dk) twice and "
                         "(B, L, H, Dv)")
    if log_decay.shape != q.shape[:3]:
        raise ValueError(f"log_decay {tuple(log_decay.shape)} is not "
                         f"{tuple(q.shape[:3])}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"{DTYPES} for q, k and v")
    if log_decay.dtype != torch.float32:
        raise TypeError(f"log_decay must be float32, got {log_decay.dtype}")
    ts = [q, k, v, log_decay]
    if state_in is not None:
        b, _, h, dk = q.shape
        if state_in.shape != (b, h, dk, v.shape[3]) \
                or state_in.dtype != torch.float32:
            raise ValueError(f"state_in must be float32 "
                             f"{(b, h, dk, v.shape[3])}, got "
                             f"{state_in.dtype} {tuple(state_in.shape)}")
        ts.append(state_in)
    if any(t.device != q.device for t in ts):
        raise ValueError("gla_scan inputs must be on one device")
    if chunk < 1:
        raise ValueError(f"chunk must be ≥ 1, got {chunk}")


def gla_scan_plain(q, k, v, log_decay, *, chunk: int = 256, state_in=None):
    """``gla_chunked``'s algorithm in PyTorch, chunk by chunk: a ragged L
    padded with identity steps, the intra-chunk products rounded to v's
    dtype before they meet v, the decay chain and the state in float32.
    Returns ``(y in q's dtype, float32 state)``."""
    _check(q, k, v, log_decay, state_in, chunk)
    B, L, H, Dk = q.shape
    Dv = v.shape[-1]
    c = min(chunk, L)
    Lp = -(-L // c) * c
    if Lp != L:
        # identity steps: decay exp(0) = 1 and k = v = 0 leave the state
        # as it is; their y rows are cut off below
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, Lp - L)) for x in (q, k, v))
        log_decay = F.pad(log_decay, (0, 0, 0, Lp - L))
    n = Lp // c
    qr, kr = q.reshape(B, n, c, H, Dk), k.reshape(B, n, c, H, Dk)
    vr = v.reshape(B, n, c, H, Dv)
    cum = log_decay.float().reshape(B, n, c, H).cumsum(2)
    S = (torch.zeros(B, H, Dk, Dv, device=q.device) if state_in is None
         else state_in)
    idx = torch.arange(c, device=q.device)
    tri = idx[:, None] >= idx[None, :]                    # s <= t
    ys = []
    for i in range(n):
        qc, kc, vc, cc = qr[:, i], kr[:, i], vr[:, i], cum[:, i]
        att = torch.einsum("bthd,bshd->bhts", qc.float(), kc.float())
        ct = cc.transpose(1, 2)                           # (B, H, c)
        decay = ct[:, :, :, None] - ct[:, :, None, :]
        att = att * torch.where(tri, torch.exp(decay), 0.0)
        y = torch.einsum("bhts,bshd->bthd", att.to(vc.dtype).float(),
                         vc.float())
        qs = qc.float() * torch.exp(cc)[..., None]
        y = y + torch.einsum("bthd,bhde->bthe", qs, S)
        total = cc[:, -1]                                 # (B, H)
        kw = kc.float() * torch.exp(total[:, None] - cc)[..., None]
        S = (S * torch.exp(total)[..., None, None]
             + torch.einsum("bshd,bshe->bhde", kw, vc.float()))
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, Lp, H, Dv)[:, :L]
    return y.to(q.dtype), S


def _launch(q, k, v, log_decay, state_in, chunk: int):
    for name, t in (("q", q), ("k", k), ("v", v), ("log_decay", log_decay),
                    ("state_in", state_in)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension is not contiguous")
    if state_in is not None and not state_in.is_contiguous():
        raise ValueError("state_in is not contiguous")
    B, L, H, dk = q.shape
    dv = v.shape[3]
    if dk > D_MAX or dv > D_MAX:
        raise ValueError(f"Dk={dk}, Dv={dv}: the kernel holds states up to "
                         f"{D_MAX} x {D_MAX}")
    chunk = min(chunk, L)
    lib = load_library("gla_scan")
    lib.gla_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.gla_scan_smem_bytes.restype = ctypes.c_ulonglong
    smem = lib.gla_scan_smem_bytes(dk, dv, chunk)
    if smem > 200 * 1024:
        raise ValueError(f"chunk {chunk} needs {smem} B of shared memory, "
                         "above the kernel's 200 KiB")
    fn = lib.gla_scan_f32 if q.dtype == torch.float32 else lib.gla_scan_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *log_decay.stride())
    y = torch.empty(B, L, H, dv, dtype=q.dtype, device=q.device)
    state = torch.empty(B, H, dk, dv, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                log_decay.data_ptr(),
                None if state_in is None else state_in.data_ptr(),
                y.data_ptr(), state.data_ptr(), B, H, L, dk, dv, chunk,
                strides, stream)
    if rc != 0:
        raise RuntimeError(f"gla_scan kernel launch failed: CUDA error {rc}")
    gla_scan.launches += 1
    return y, state


def gla_scan(q, k, v, log_decay, *, chunk: int = 256, state_in=None):
    """q, k: (B, L, H, Dk); v: (B, L, H, Dv); log_decay: (B, L, H) float32;
    state_in: None or float32 (B, H, Dk, Dv).  Returns (y (B, L, H, Dv) in
    q's dtype, float32 state (B, H, Dk, Dv)).  CUDA tensors go through the
    hand-written kernel (``gla_scan.launches`` counts its launches); CPU
    tensors through :func:`gla_scan_plain`."""
    _check(q, k, v, log_decay, state_in, chunk)
    if q.device.type == "cpu":
        return gla_scan_plain(q, k, v, log_decay, chunk=chunk,
                              state_in=state_in)
    if q.device.type != "cuda":
        raise ValueError(f"gla_scan runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, log_decay, state_in, chunk)


gla_scan.launches = 0
