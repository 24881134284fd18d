"""Benchmark strategies from the paper's §IV (the slice the offline wave
uses): LC, which the serve entry point prints beside the J-DOB plan, and the
J-DOB restrictions that :func:`~repro_torch.core.planner_service.\
planner_spec` maps onto a batched planner.  IP-SSA is not ported yet
(ROADMAP queue 1, item 12)."""
from __future__ import annotations

import numpy as np

from .cost_models import DeviceFleet, EdgeProfile
from .jdob import BatchedPlanner, Schedule, jdob_schedule
from .task_model import TaskProfile


def local_computing(profile: TaskProfile, fleet: DeviceFleet,
                    edge: EdgeProfile, t_free: float = 0.0,
                    rho: float = 0.03e9) -> Schedule:
    """LC: every device runs the whole model at its optimal DVFS (host
    arithmetic only — there is no device work to place)."""
    vN, uN = profile.v()[-1], profile.u()[-1]
    f = np.clip(fleet.zeta * vN / fleet.deadline, fleet.f_min, fleet.f_max)
    eu = fleet.kappa * uN * f ** 2
    return Schedule(True, float(eu.sum()), profile.N, float(edge.f_max),
                    np.zeros(fleet.M, bool), f, t_free,
                    dict(device=float(eu.sum()), uplink=0.0, edge=0.0), eu)


def jdob_no_edge_dvfs(profile, fleet, edge, t_free=0.0, rho=0.03e9,
                      device=None):
    return jdob_schedule(profile, fleet, edge, t_free, rho, edge_dvfs=False,
                         device=device)


def jdob_binary(profile, fleet, edge, t_free=0.0, rho=0.03e9, device=None):
    return jdob_schedule(profile, fleet, edge, t_free, rho,
                         partitions=[0, profile.N], device=device)


#: the J-DOB+ ordering portfolio (see jdob_plus)
JDOB_PLUS_SORT_KEYS = ("gamma", "budget", "energy")


def jdob_plus(profile, fleet, edge, t_free=0.0, rho=0.03e9, device=None):
    """Beyond-paper portfolio: J-DOB under three user orderings (γ, budget
    T_m − γ_m, local energy), keeping the best per group (ties keep the
    earlier key)."""
    planner = BatchedPlanner(profile, edge, rho=rho,
                             sort_keys=JDOB_PLUS_SORT_KEYS, device=device)
    return planner.plan([fleet], [t_free], pad_users=False)[0]
