"""J-DOB's (partition × edge-frequency) energy grid: the hand-written CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/jdob_sweep.py:64``
(``jdob_sweep_kernel``).  The kernel is ``csrc/jdob_sweep.cu`` (see its
header for the design and what bounds it on an H100).  The host side —
Alg. 1's per-partition user sort and the GHz/s/J scaling — is
:func:`repro_torch.kernels.ops.jdob_sweep_op`; these functions consume its
per-row sorted arrays.

Both versions do the same float32 operations in the same order, sum each
row over users in user order, and contract no multiply-add, so the kernel
and its plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library

_INF = float("inf")


def _check(arrays, scal, f_sweep) -> None:
    NP, M = arrays[0].shape
    for a in arrays:
        if a.shape != (NP, M):
            raise ValueError(f"per-user arrays must all be ({NP}, {M}), "
                             f"got {tuple(a.shape)}")
    if scal.shape != (NP, 8) or f_sweep.dim() != 2 or f_sweep.shape[0] != NP:
        raise ValueError(f"scal {tuple(scal.shape)} / f_sweep "
                         f"{tuple(f_sweep.shape)} do not match {NP} rows")
    ts = (*arrays, scal, f_sweep)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("jdob_sweep takes float32 tensors only")
    if any(t.device != f_sweep.device for t in ts):
        raise ValueError("all jdob_sweep inputs must be on one device")


def jdob_sweep_plain(th, sufft, our, eup, eloc, zeta, ku, fmin, fmax, scal,
                     f_sweep) -> torch.Tensor:
    """The kernel's plain version: (NP, K) energies, +inf infeasible."""
    _check((th, sufft, our, eup, eloc, zeta, ku, fmin, fmax), scal, f_sweep)
    col = lambda i: scal[:, i:i + 1]                     # (NP, 1)
    phi_b, phi_s, psi_b, psi_s = col(0), col(1), col(2), col(3)
    v_nt, u_nt, t_free = col(4)[..., None], col(5)[..., None], col(6)
    f = f_sweep                                          # (NP, K)
    row = lambda a: a[:, None, :]                        # (NP, 1, M)
    memb = row(th) <= f[..., None]                       # (NP, K, M)
    B_o = memb.to(torch.float32).sum(-1)                 # exact counts
    has = B_o > 0
    l_o = torch.where(memb, row(sufft), _INF).amin(-1)
    phi = phi_b + phi_s * B_o
    psi = psi_b + psi_s * B_o
    gpu_ok = f * (l_o - t_free) >= phi                   # Eq. 6
    slack = (l_o[..., None] - row(our)) - (phi / f)[..., None]
    gamma_off = torch.where(
        slack > 0, row(zeta) * v_nt / torch.clamp(slack, min=1e-30),
        _INF)                                            # Eq. 19
    fdev = torch.minimum(torch.maximum(gamma_off, row(fmin)),
                         row(fmax))                      # Eq. 20
    dev_ok = torch.where(memb, gamma_off <= row(fmax) * (1 + 1e-9), True)
    e_user = torch.where(memb, row(ku) * u_nt * (fdev * fdev) + row(eup),
                         row(eloc))                      # Eq. 21
    acc = torch.zeros_like(f)
    for m in range(e_user.shape[-1]):                    # user order
        acc = acc + e_user[..., m]
    energy = acc + torch.where(has, psi * (f * f), 0.0)
    return torch.where(has & gpu_ok & dev_ok.all(-1), energy, _INF)


def _launch(arrays, scal, f_sweep) -> torch.Tensor:
    ts = (*arrays, scal, f_sweep)
    if not all(t.is_cuda for t in ts):
        raise ValueError("jdob_sweep kernel inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("jdob_sweep kernel inputs must be contiguous")
    NP, M = arrays[0].shape
    K = f_sweep.shape[1]
    lib = load_library("jdob_sweep")
    fn = lib.jdob_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((NP, K), dtype=torch.float32, device=f_sweep.device)
    with torch.cuda.device(f_sweep.device):
        stream = torch.cuda.current_stream(f_sweep.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ts), out.data_ptr(), NP, M, K,
                stream)
    if rc != 0:
        raise RuntimeError(f"jdob_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    jdob_sweep_kernel.launches += 1
    return out


def jdob_sweep_kernel(th, sufft, our, eup, eloc, zeta, ku, fmin, fmax, scal,
                      f_sweep) -> torch.Tensor:
    """All (NP, M) inputs sorted per row by the paper's γ ordering; scal:
    (NP, 8) = (φ_b, φ_s, ψ_b, ψ_s, v_ñ, u_ñ, t_free, 0); f_sweep: (NP, K).
    Returns the (NP, K) energy grid (+inf = infeasible).  CUDA tensors go
    through the hand-written kernel (``jdob_sweep_kernel.launches`` counts
    its launches); CPU tensors through :func:`jdob_sweep_plain`."""
    arrays = (th, sufft, our, eup, eloc, zeta, ku, fmin, fmax)
    _check(arrays, scal, f_sweep)
    dev = f_sweep.device.type
    if dev == "cpu":
        return jdob_sweep_plain(*arrays, scal, f_sweep)
    if dev != "cuda":
        raise ValueError(f"jdob_sweep runs on cuda or cpu, not "
                         f"{f_sweep.device}")
    return _launch(arrays, scal, f_sweep)


jdob_sweep_kernel.launches = 0
