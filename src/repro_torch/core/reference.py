"""Loop-faithful transcription of the paper's Alg. 1 + Alg. 2 (numpy).

This is the test oracle for :func:`repro_torch.core.jdob.jdob_schedule`: it follows
the pseudocode line by line (explicit frequency sweep, pointer-based greedy
batching-set update) with no vectorization tricks.
"""
from __future__ import annotations

import numpy as np

from .cost_models import DeviceFleet, EdgeProfile
from .jdob import Schedule, make_f_sweep
from .task_model import TaskProfile


def _local_opt(profile: TaskProfile, fleet: DeviceFleet):
    vN = profile.v()[-1]
    uN = profile.u()[-1]
    f = np.clip(fleet.zeta * vN / fleet.deadline, fleet.f_min, fleet.f_max)
    return f, fleet.kappa * uN * f ** 2


def jdob_reference(profile: TaskProfile, fleet: DeviceFleet,
                   edge: EdgeProfile, t_free: float = 0.0,
                   rho: float = 0.03e9, sort_key: str = "gamma") -> Schedule:
    M = fleet.M
    N = profile.N
    v, u, O = profile.v(), profile.u(), profile.O
    phi_b, phi_s = edge.phi_coeffs(profile)
    psi_b, psi_s = edge.psi_coeffs(profile)
    f_loc, e_loc = _local_opt(profile, fleet)

    best = dict(E=e_loc.sum(), nt=N, fe=edge.f_max,
                off=np.zeros(M, bool), fdev=f_loc.copy(),
                tend=t_free, eu=e_loc.copy())

    for nt in range(N):                                   # Alg.1 line 3
        gamma = O[nt] / fleet.rate + fleet.zeta * v[nt] / fleet.f_max  # l.4
        if sort_key == "gamma":
            order = np.argsort(-gamma, kind="stable")     # l.5
        else:   # beyond-paper J-DOB+ budget ordering
            order = np.argsort(fleet.deadline - gamma, kind="stable")
        g_s, T_s = gamma[order], fleet.deadline[order]
        suffT = np.minimum.accumulate(T_s[::-1])[::-1]
        th = np.empty(M)
        for i in range(M):                                # l.6 / Eq. 18
            denom = suffT[i] - g_s[i]
            phi = phi_b[nt] + phi_s[nt] * (M - i)
            th[i] = phi / denom if denom > 0 else np.inf

        # ---- Alg. 2 ----
        ok = np.where(th >= 0)[0]
        i_hat = int(ok[0]) if len(ok) else M              # l.2 (0-based)
        # skip +inf thresholds (users infeasible at any f_e)
        while i_hat < M and not np.isfinite(th[i_hat]):
            i_hat += 1
        members = list(order[i_hat:])                     # l.3
        f_e = edge.f_max                                  # l.5
        for f_e in make_f_sweep(edge, rho):               # l.6
            while i_hat < M and f_e < th[i_hat]:          # l.8-11
                members = [m for m in members if m != order[i_hat]]
                i_hat += 1
            if not members:
                break                                     # l.20-21
            B_o = len(members)
            l_o = fleet.deadline[list(members)].min()
            phi = phi_b[nt] + phi_s[nt] * B_o
            psi = psi_b[nt] + psi_s[nt] * B_o
            # l.13 / Eq. 6 (paper's Require min T ≥ t_free assumed; we also
            # guard the l_o ≤ t_free case explicitly)
            if l_o <= t_free or f_e < phi / (l_o - t_free):
                continue
            fdev = f_loc.copy()
            eu = e_loc.copy()
            feasible = True
            t_up_max = -np.inf
            for m in members:                             # Eq. 19-20
                slack = l_o - O[nt] / fleet.rate[m] - phi / f_e
                if slack <= 0:
                    feasible = False
                    break
                gam = fleet.zeta[m] * v[nt] / slack
                if gam > fleet.f_max[m] * (1 + 1e-9):
                    feasible = False
                    break
                fdev[m] = np.clip(gam, fleet.f_min[m], fleet.f_max[m])
                eu[m] = (fleet.kappa[m] * u[nt] * fdev[m] ** 2
                         + O[nt] / fleet.rate[m] * fleet.p_up[m])
                t_up_max = max(t_up_max,
                               fleet.zeta[m] * v[nt] / fdev[m]
                               + O[nt] / fleet.rate[m])
            if not feasible:
                continue
            E = eu.sum() + psi * f_e ** 2                 # Eq. 21
            if E < best["E"]:                             # l.16-18
                off = np.zeros(M, bool)
                off[list(members)] = True
                best = dict(E=E, nt=nt, fe=f_e, off=off, fdev=fdev,
                            tend=max(t_free, t_up_max) + phi / f_e, eu=eu)

    off = best["off"]
    up = float((O[best["nt"]] / fleet.rate * fleet.p_up)[off].sum())
    edge_e = float((psi_b[best["nt"]] + psi_s[best["nt"]] * off.sum())
                   * best["fe"] ** 2) if off.any() else 0.0
    return Schedule(True, float(best["E"]), int(best["nt"]),
                    float(best["fe"]), off, best["fdev"],
                    float(best["tend"]),
                    dict(device=float(best["E"]) - up - edge_e,
                         uplink=up, edge=edge_e), best["eu"])
