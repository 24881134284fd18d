"""Outer module: optimal grouping (OG) of users by deadline similarity [10]
(the prefix DP on the dispatch fold, as the offline wave runs it).

Users sorted by deadline are partitioned into contiguous groups; groups are
served in deadline order, each occupying the edge GPU from the previous
group's ``t_free`` (Eq. 22 threads through).  A dynamic program over prefix
boundaries picks the grouping that minimizes total energy.

* :func:`optimal_grouping` — all contiguous segments ending at DP level j
  are solved by the batched J-DOB core in a few padded passes once
  dp[0..j-1] are final; the shape policy lives in
  :class:`~repro_torch.core.planner_service.PlannerService`.  Bit for bit
  equal to :func:`optimal_grouping_reference`.
* :func:`optimal_grouping_reference` — the sequential DP (one ``inner``
  call per (segment, t_free)), the oracle and the route for ``inner``
  callables outside the J-DOB family (the sweep-kernel inner among them).

The Pareto-frontier DP, incremental planning and the fused device fold are
not ported yet (ROADMAP queue 1, items 7 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .cost_models import DeviceFleet
from .jdob import BatchedPlanner, Schedule, jdob_schedule
from .planner_service import PlannerService
from .timeline import GpuTimeline, TimelineCursor


@dataclasses.dataclass
class GroupedSchedule:
    energy: float
    groups: list[np.ndarray]        # member indices (into the original fleet)
    schedules: list[Schedule]
    t_free_end: float

    @property
    def per_user_energy(self) -> np.ndarray:
        M = sum(len(g) for g in self.groups)
        out = np.zeros(M)
        for g, s in zip(self.groups, self.schedules):
            out[g] = s.per_user_energy
        return out


def _check_modes(dp: str, dp_backend: str) -> None:
    if dp != "prefix":
        raise NotImplementedError(f"grouping DP {dp!r} is not ported to "
                                  "repro_torch yet (ROADMAP queue 1, item 7)")
    if dp_backend != "dispatch":
        raise NotImplementedError(f"dp backend {dp_backend!r} is not ported "
                                  "to repro_torch yet (ROADMAP queue 1, "
                                  "item 10)")


def _run_dp(M: int, cursor: TimelineCursor, solve,
            level_prefetch=None) -> list[tuple[int, int]]:
    """The shared prefix DP: ``dp[j] = (energy, timeline cursor, split i)``
    for users [0, j), folding ``solve(i, j, cursor_i.t_free)`` with
    ascending-``i`` tie-breaks.  ``level_prefetch(j, dp)``, when given,
    runs before level j folds so a batched backend can solve every
    (i, j, tf_i) at once.  Returns the chain of contiguous segments
    covering [0, M).  Both grouping implementations run THIS function."""
    INF = np.inf
    dp = [(0.0, cursor, -1)]
    for j in range(1, M + 1):
        if level_prefetch is not None:
            level_prefetch(j, dp)
        best = (INF, cursor, 0)
        for i in range(j):
            e_i, cur_i, _ = dp[i]
            if not np.isfinite(e_i):
                continue
            s = solve(i, j, cur_i.t_free)
            cand = e_i + s.energy
            if cand < best[0]:
                best = (cand, cur_i.advance(s), i)
        dp.append(best)
    chain: list[tuple[int, int]] = []
    j = M
    while j > 0:
        i = dp[j][2]
        chain.append((i, j))
        j = i
    chain.reverse()
    return chain


def _collect_chain(chain, order, solve, cursor: TimelineCursor,
                   timeline: GpuTimeline | None = None) -> GroupedSchedule:
    """Walk the DP-selected chain threading the timeline cursor exactly
    (Eq. 22).  With a ``timeline``, each offloading group's occupancy is
    committed as a reservation and ``t_free_end`` derives from them."""
    groups, schedules = [], []
    total = 0.0
    for (i, j) in chain:
        s = solve(i, j, cursor.t_free)
        groups.append(order[i:j])
        schedules.append(s)
        total += s.energy
        if timeline is not None and s.offload.any():
            timeline.reserve(-1, cursor.t_free, s.t_free_end,
                             gpu_start=s.gpu_start, f_edge=s.f_edge)
        cursor = cursor.advance(s)
    t_free_end = (timeline.horizon if timeline is not None
                  and timeline.reservations else cursor.t_free)
    return GroupedSchedule(total, groups, schedules, t_free_end)


def optimal_grouping(profile, fleet: DeviceFleet, edge,
                     inner: Callable = jdob_schedule,
                     t_free: float = 0.0, rho: float = 0.03e9,
                     planner: BatchedPlanner | None = None,
                     service: PlannerService | None = None,
                     timeline: GpuTimeline | None = None,
                     dp: str = "prefix", dp_backend: str = "dispatch",
                     device=None) -> GroupedSchedule:
    """OG over the deadline-sorted fleet.  ``inner`` picks the per-group
    solver; the J-DOB family routes through the planner service (its
    ``device`` wins over ``device`` here), other callables fall back to
    :func:`optimal_grouping_reference`.  ``timeline`` plugs the DP into a
    GPU timeline: the start is read from it and the winning chain's
    offloading groups are committed as reservations."""
    _check_modes(dp, dp_backend)
    if timeline is not None:
        t_free = max(t_free, timeline.t_free(0.0))
    if service is None:
        service = PlannerService(profile, edge, rho=rho, device=device)
    elif service.rho != rho:
        raise ValueError("service rho disagrees with rho argument")
    spec = service.spec_for(inner)
    if spec is None:
        return optimal_grouping_reference(profile, fleet, edge, inner,
                                          t_free, rho, timeline=timeline,
                                          device=service.device)
    if planner is None:
        planner = service.planner(**spec)
    else:
        want_parts = spec.get("partitions")
        if not (planner.sort_keys == tuple(spec.get("sort_keys", ("gamma",)))
                and planner.edge_dvfs == spec.get("edge_dvfs", True)
                and planner.partitions == (None if want_parts is None
                                           else tuple(want_parts))
                and planner.rho == rho):
            raise ValueError(
                "prebuilt planner configuration disagrees with inner/rho")

    M = fleet.M
    order = np.argsort(fleet.deadline, kind="stable")
    sorted_fleet = fleet.subset(order)
    sub: dict[tuple[int, int], DeviceFleet] = {}

    def seg(i: int, j: int) -> DeviceFleet:
        if (i, j) not in sub:
            sub[(i, j)] = sorted_fleet.subset(np.arange(i, j))
        return sub[(i, j)]

    buckets = service.level_buckets(M)
    # keyed exactly like the sequential DP's memo: (i, j, round(tf, 9))
    cache: dict[tuple[int, int, float], Schedule] = {}

    def solve_many(pairs: Sequence[tuple[int, int, float]]):
        by_bucket: dict[int, list[tuple[int, int, float]]] = {}
        for (i, j, tf) in pairs:
            by_bucket.setdefault(
                service.bucket_for(j - i, buckets), []).append((i, j, tf))
        # issue every bucket's pass before reading any result back
        pending = []
        for b, part in sorted(by_bucket.items()):
            pending.append((part, planner.plan_async(
                [seg(i, j) for (i, j, _) in part],
                [tf for (_, _, tf) in part], m_pad=b,
                g_pad=service.level_group_pad(buckets, len(part)))))
        for part, plans in pending:
            for (i, j, tf), p in zip(part, plans.get()):
                cache[(i, j, round(tf, 9))] = p

    def solve(i: int, j: int, tf: float) -> Schedule:
        key = (i, j, round(tf, 9))
        if key not in cache:
            solve_many([(i, j, tf)])
        return cache[key]

    def level_prefetch(j: int, states) -> None:
        # level-synchronous batching: dp[0..j-1] are final, so every
        # candidate (i, j, tf_i) of level j is known — solve them in one go
        need = []
        for i in range(j):
            e_i, cur_i, _ = states[i]
            if np.isfinite(e_i) and (i, j, round(cur_i.t_free, 9)) not in cache:
                need.append((i, j, cur_i.t_free))
        if need:
            solve_many(need)

    d0 = planner.stats.dispatches
    chain = _run_dp(M, TimelineCursor(t_free), solve, level_prefetch)
    out = _collect_chain(chain, order, solve, TimelineCursor(t_free),
                         timeline)
    planner.stats.og_plans += 1
    planner.stats.og_dispatches += planner.stats.dispatches - d0
    return out


def optimal_grouping_reference(profile, fleet: DeviceFleet, edge,
                               inner: Callable = jdob_schedule,
                               t_free: float = 0.0, rho: float = 0.03e9,
                               timeline: GpuTimeline | None = None,
                               dp: str = "prefix",
                               dp_backend: str = "dispatch",
                               device=None) -> GroupedSchedule:
    """The sequential DP: one ``inner(profile, fleet, edge, t_free=, rho=,
    device=)`` call per (segment, t_free) with per-prefix threading —
    the oracle and the arbitrary-``inner`` route."""
    _check_modes(dp, dp_backend)
    M = fleet.M
    order = np.argsort(fleet.deadline, kind="stable")
    sorted_fleet = fleet.subset(order)
    cache: dict = {}

    def solve(i: int, j: int, tf: float) -> Schedule:
        key = (i, j, round(tf, 9))
        if key not in cache:
            cache[key] = inner(profile, sorted_fleet.subset(np.arange(i, j)),
                               edge, t_free=tf, rho=rho, device=device)
        return cache[key]

    if timeline is not None:
        t_free = max(t_free, timeline.t_free(0.0))
    chain = _run_dp(M, TimelineCursor(t_free), solve)
    return _collect_chain(chain, order, solve, TimelineCursor(t_free),
                          timeline)


def single_group(profile, fleet, edge, inner=jdob_schedule,
                 t_free: float = 0.0, rho: float = 0.03e9,
                 device=None) -> GroupedSchedule:
    """No grouping: the whole fleet as one group (identical-deadline runs)."""
    s = inner(profile, fleet, edge, t_free=t_free, rho=rho, device=device)
    return GroupedSchedule(s.energy, [np.arange(fleet.M)], [s], s.t_free_end)
