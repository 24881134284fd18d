"""GPU occupancy timeline (the slice of ``repro.core.timeline`` the offline
wave runs).

* :class:`TimelineCursor` — the scalar occupancy view the OG grouping DP
  threads through its prefix states: ``advance(schedule)`` folds one
  group's occupancy exactly the way Eq. 22 does.
* :class:`GpuTimeline` — reservations instead of a scalar horizon, in the
  paper's serialized mode: ``horizon`` is the Eq. 22 booking horizon and
  ``t_free`` the residual a plan starts behind.  ``optimal_grouping``
  reads its start from a timeline and commits the winning chain's
  offloading groups as reservations.

Interleaved occupancy (gap filling, per-flush edge DVFS) belongs to online
serving and is not ported yet (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import math
@dataclasses.dataclass(eq=False)
class Reservation:
    """One batch's slot on the GPU: the queue slot ``start``, the instant
    the accelerator genuinely begins (``gpu_start``, which uploads may
    delay), the Eq. 22 end, and the dispatch frequency ``f_edge``."""

    tenant: int
    start: float
    end: float
    gpu_start: float
    f_edge: float = math.nan


@dataclasses.dataclass
class TimelineCursor:
    """Scalar occupancy view threaded through the OG prefix DP.

    ``t_free`` is the residual occupancy (seconds) the next segment solve
    plans against; :meth:`advance` folds one schedule's occupancy exactly
    as Eq. 22 did (``t_free_end`` is relative to the same origin)."""

    t_free: float

    def advance(self, schedule) -> "TimelineCursor":
        return TimelineCursor(schedule.t_free_end)


class GpuTimeline:
    """Serialized GPU occupancy: reservations whose latest end is the
    scalar Eq. 22 horizon."""

    def __init__(self, mode: str = "serialized"):
        if mode != "serialized":
            raise NotImplementedError(
                f"occupancy mode {mode!r} belongs to online serving, which "
                "is not ported yet (ROADMAP queue 1, item 6)")
        self.mode = mode
        self.reservations: list[Reservation] = []
        self.horizon = 0.0

    def t_free(self, now: float) -> float:
        """Residual occupancy (s) a plan at ``now`` starts behind."""
        return max(self.horizon - now, 0.0)

    def reserve(self, tenant: int, start: float, end: float, *,
                gpu_start: float | None = None,
                f_edge: float = math.nan) -> Reservation:
        """Book one batch's occupancy (the OG grouping DP commits its
        winning chain through this)."""
        r = Reservation(tenant, start, end,
                        start if gpu_start is None else gpu_start, f_edge)
        self.reservations.append(r)
        self.horizon = max(self.horizon, r.end)
        return r
