"""Public wrappers around the hand-written kernels, in the layouts the
model and the planner use (counterpart of ``repro.kernels.ops``).

Shape plumbing: the model layers use (B, S, H, hd) GQA tensors; the
attention kernel takes head-folded (B·H, S, hd).  The sweep's host side —
Alg. 1's sort and the GHz/s/J scaling — runs in numpy; the (ñ × f_e) grid
runs in :func:`~repro_torch.kernels.jdob_sweep.jdob_sweep_kernel` on the
planner's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from .flash_attention import flash_attention
from .jdob_sweep import jdob_sweep_kernel


def _fold_heads(q, k, v):
    """(B,S,H,hd)/(B,S,KV,hd) -> head-folded (B·H,...)/(B·KV,...).  K/V are
    NOT broadcast — the kernel reads each kv head once per query tile."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    fold = lambda x: x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1],
                                               hd)
    return fold(q), fold(k), fold(v), (b, h, h // kv)


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: int | None = None) -> torch.Tensor:
    """Prefill attention on (B, Sq, H, hd) × (B, Sk, KV, hd) → (B, Sq, H, hd)
    (KV | H): the hand-written kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    qf, kf, vf, (b, h, rep) = _fold_heads(q, k, v)
    o = flash_attention(qf, kf, vf, causal=causal, window=window, n_rep=rep)
    sq, hd = q.shape[1], q.shape[3]
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def sweep_inputs(profile, fleet, edge, t_free=0.0, rho=0.03e9):
    """Host side of the sweep: Alg. 1's per-partition sort and the
    (GHz, s, J) scaling of :mod:`repro_torch.core.jdob`.  Returns the nine
    (N+1, M) per-user rows, the (N+1, 8) scalars and the (N+1, K) sweep
    as float32 numpy arrays, in the argument order of
    :func:`~repro_torch.kernels.jdob_sweep.jdob_sweep_kernel`."""
    from repro_torch.core.jdob import _GHZ, make_f_sweep
    N = profile.N
    M = fleet.M
    v = profile.v() / _GHZ
    u = profile.u()
    phi_b, phi_s = edge.phi_coeffs(profile)
    psi_b, psi_s = edge.psi_coeffs(profile)
    phi_b, phi_s = phi_b / _GHZ, phi_s / _GHZ
    psi_b, psi_s = psi_b * _GHZ ** 2, psi_s * _GHZ ** 2
    fsw = make_f_sweep(edge, rho) / _GHZ
    K = len(fsw)

    f_loc = np.clip(fleet.zeta * v[-1] * _GHZ / fleet.deadline / _GHZ,
                    fleet.f_min / _GHZ, fleet.f_max / _GHZ)
    e_loc = fleet.kappa * _GHZ ** 2 * u[-1] * f_loc ** 2

    th, sufft, our, eup, elo, zet, kus, fmn, fmx = (
        np.zeros((N + 1, M), np.float32) for _ in range(9))
    th[:] = np.inf
    scal = np.zeros((N + 1, 8), np.float32)
    for nt in range(N):
        gamma = profile.O[nt] / fleet.rate + fleet.zeta * v[nt] * _GHZ \
            / fleet.f_max
        order = np.argsort(-gamma, kind="stable")
        g_s = gamma[order]
        T_s = fleet.deadline[order]
        st = np.minimum.accumulate(T_s[::-1])[::-1]
        b_in = M - np.arange(M)
        denom = st - g_s
        phi_i = phi_b[nt] + phi_s[nt] * b_in
        th[nt] = np.where(denom > 0, phi_i / np.where(denom > 0, denom, 1.0),
                          np.inf)
        sufft[nt] = st
        our[nt] = (profile.O[nt] / fleet.rate)[order]
        eup[nt] = (profile.O[nt] / fleet.rate * fleet.p_up)[order]
        elo[nt] = e_loc[order]
        zet[nt] = fleet.zeta[order]
        kus[nt] = (fleet.kappa * _GHZ ** 2)[order]
        fmn[nt] = (fleet.f_min / _GHZ)[order]
        fmx[nt] = (fleet.f_max / _GHZ)[order]
        scal[nt] = [phi_b[nt], phi_s[nt], psi_b[nt], psi_s[nt], v[nt], u[nt],
                    t_free, 0.0]
    f_rows = np.ascontiguousarray(
        np.broadcast_to(fsw.astype(np.float32), (N + 1, K)))
    return (th, sufft, our, eup, elo, zet, kus, fmn, fmx, scal, f_rows)


def jdob_sweep_op(profile, fleet, edge, t_free=0.0, rho=0.03e9,
                  device=None) -> np.ndarray:
    """The paper's (ñ × f_e) energy grid on ``device``: the host does
    Alg. 1's sort (:func:`sweep_inputs`), the kernel Alg. 2's sweep.
    Returns an (N+1, K) float32 grid whose row N is +inf (local branch
    handled in closed form by the caller)."""
    dev = resolve_device(device)
    args = [torch.from_numpy(a).to(dev)
            for a in sweep_inputs(profile, fleet, edge, t_free, rho)]
    grid = jdob_sweep_kernel(*args).cpu().numpy()
    grid[profile.N] = np.inf
    return grid


def jdob_sweep_schedule(profile, fleet, edge, t_free=0.0, rho=0.03e9,
                        device=None):
    """Inner group solver backed by the sweep kernel: the (ñ × f_e) grid
    runs on the device (:func:`jdob_sweep_op`), the host argmin picks the
    winning partition, and that single-ñ problem is re-solved through the
    batched core so the returned
    :class:`~repro_torch.core.jdob.Schedule` carries the core's exact
    energies, offload set and DVFS frequencies.  Signature-compatible with
    :func:`~repro_torch.core.jdob.jdob_schedule`; outside the planner
    family, so :func:`~repro_torch.core.grouping.optimal_grouping` folds
    it through the sequential reference DP.  The grid is float32 with a
    plain row sum (the core folds with ``_pow2_sum``), so on a near-exact
    tie between partitions the two may pick different ñ; the winner's
    energy always comes from the core re-solve."""
    from repro_torch.core.jdob import jdob_schedule
    grid = jdob_sweep_op(profile, fleet, edge, t_free=t_free, rho=rho,
                         device=device)
    per_nt = grid.min(axis=1)
    nt = int(per_nt.argmin())
    if not np.isfinite(per_nt[nt]):
        nt = profile.N          # all-local: the core's closed-form branch
    return jdob_schedule(profile, fleet, edge, t_free=t_free, rho=rho,
                         partitions=[nt], device=device)
