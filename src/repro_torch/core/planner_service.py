"""PlannerService: one owner for planner construction, shape-bucket policy
and the planners' shape cache (the offline-wave slice of
``repro.core.planner_service``).

* **construction** — :meth:`PlannerService.planner_for` maps an ``inner``
  solver callable (the J-DOB family) to a configured
  :class:`~repro_torch.core.jdob.BatchedPlanner`, memoized per spec, all on
  the service's ``device``.
* **shape buckets** — :meth:`level_buckets` picks the per-length user
  paddings the OG level solver dispatches against.  Padding is
  bit-invariant (see ``_pow2_sum``), so the policy never changes results.
* **caching** — the service's planners share one bounded
  :class:`~repro_torch.core.jdob.ExecutableCache`, with per-planner
  hit/miss/eviction counters aggregated by :meth:`stats`.

Plan-ahead pools, cohort planning and the Pareto/fused DPs are not ported
yet (ROADMAP queue 1, items 7, 9 and 10).
"""
from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.device import resolve_device
from .cost_models import EdgeProfile
from .jdob import BatchedPlanner, ExecutableCache, PlannerStats, _bucket
from .task_model import TaskProfile


def planner_spec(inner: Callable, profile: TaskProfile) -> dict | None:
    """BatchedPlanner constructor kwargs replicating ``inner``, or ``None``
    when ``inner`` is an arbitrary callable the batched core cannot mirror
    (callers then fall back to sequential per-group solves)."""
    from . import baselines
    if inner is baselines.jdob_schedule:
        return dict(sort_keys=("gamma",))
    if inner is baselines.jdob_plus:
        return dict(sort_keys=baselines.JDOB_PLUS_SORT_KEYS)
    if inner is baselines.jdob_no_edge_dvfs:
        return dict(sort_keys=("gamma",), edge_dvfs=False)
    if inner is baselines.jdob_binary:
        return dict(sort_keys=("gamma",), partitions=[0, profile.N])
    return None


class PlannerService:
    """Constructs, configures and caches the planners one (profile, edge,
    rho, device) deployment needs."""

    def __init__(self, profile: TaskProfile, edge: EdgeProfile, *,
                 rho: float = 0.03e9,
                 group_chunk: int = 256, min_user_bucket: int = 4,
                 min_group_bucket: int = 16,
                 max_level_buckets: int = 2, bucket_stride: int = 4,
                 single_bucket_max: int = 64,
                 max_cached_shapes: int = 64, device=None):
        if max_level_buckets < 1 or bucket_stride < 2:
            raise ValueError("need max_level_buckets ≥ 1, bucket_stride ≥ 2")
        self.device = resolve_device(device)
        self.profile = profile
        self.edge = edge
        self.rho = rho
        self.group_chunk = group_chunk
        self.min_user_bucket = min_user_bucket
        self.min_group_bucket = min_group_bucket
        self.max_level_buckets = max_level_buckets
        self.bucket_stride = bucket_stride
        self.single_bucket_max = single_bucket_max
        self.cache = ExecutableCache(max_cached_shapes)
        self._planners: dict[tuple, BatchedPlanner] = {}

    # ---- construction --------------------------------------------------
    def spec_for(self, inner: Callable) -> dict | None:
        return planner_spec(inner, self.profile)

    def planner(self, *, sort_keys: Sequence[str] = ("gamma",),
                edge_dvfs: bool = True,
                partitions: Sequence[int] | None = None) -> BatchedPlanner:
        """The (memoized) planner for an explicit J-DOB restriction."""
        key = (tuple(sort_keys), edge_dvfs,
               None if partitions is None else tuple(partitions))
        if key not in self._planners:
            self._planners[key] = BatchedPlanner(
                self.profile, self.edge, rho=self.rho, sort_keys=sort_keys,
                edge_dvfs=edge_dvfs, partitions=partitions,
                group_chunk=self.group_chunk,
                min_user_bucket=self.min_user_bucket, cache=self.cache,
                device=self.device)
        return self._planners[key]

    def planner_for(self, inner: Callable) -> BatchedPlanner | None:
        """The planner replicating ``inner``, or ``None`` for callables
        outside the J-DOB family (callers fall back to sequential solves)."""
        spec = self.spec_for(inner)
        if spec is None:
            return None
        return self.planner(**spec)

    def plan_fleet(self, fleet, inner: Callable | None = None, *,
                   t_free: float = 0.0, timeline=None):
        """The planning call the serving layer makes: exact
        :func:`~repro_torch.core.grouping.optimal_grouping` (prefix DP,
        dispatch fold) under this service's rho, shape policy, cache and
        device."""
        from .grouping import optimal_grouping
        from .jdob import jdob_schedule
        return optimal_grouping(
            self.profile, fleet, self.edge,
            jdob_schedule if inner is None else inner,
            t_free=t_free, rho=self.rho, service=self, timeline=timeline)

    # ---- shape-bucket policy -------------------------------------------
    @staticmethod
    def _align(n: int, to: int = 8) -> int:
        return max(to, to * ((n + to - 1) // to))

    def level_buckets(self, M: int) -> tuple[int, ...]:
        """Ascending per-length user paddings for a fleet of M users: one
        aligned width for small fleets, up to ``max_level_buckets``
        power-of-two widths ``bucket_stride`` apart for large ones."""
        top = self._align(M, max(8, self.min_user_bucket))
        if top <= self.single_bucket_max:
            return (top,)
        out = [_bucket(M, self.min_user_bucket)]
        b = out[0] // self.bucket_stride
        while len(out) < self.max_level_buckets and b >= self.min_user_bucket:
            out.append(b)
            b //= self.bucket_stride
        return tuple(reversed(out))

    def bucket_for(self, length: int, buckets: Sequence[int]) -> int:
        """Smallest bucket covering ``length`` (buckets ascending)."""
        for b in buckets:
            if length <= b:
                return b
        return buckets[-1]

    def group_pad(self, count: int) -> int | None:
        """Padded group count for a sub-level batch: a ``bucket_stride``-
        spaced series starting at ``min_group_bucket``, capped at
        ``group_chunk``; ``None`` → let the planner chunk."""
        if count > self.group_chunk:
            return None
        pad = self.min_group_bucket
        while pad < count:
            pad *= self.bucket_stride
        return min(pad, self.group_chunk)

    def level_group_pad(self, buckets: Sequence[int], count: int
                        ) -> int | None:
        """Group padding for a level dispatch: single-bucket fleets keep one
        fixed group shape while the level fits it; bucketed fleets pad to
        the :meth:`group_pad` series."""
        if len(buckets) == 1:
            pad = min(buckets[0], self.group_chunk)
            if count <= pad:
                return pad
        return self.group_pad(count)

    # ---- observability -------------------------------------------------
    def stats(self) -> PlannerStats:
        """Aggregate shape-cache counters over this service's planners."""
        total = PlannerStats()
        for p in self._planners.values():
            total = total.merge(p.stats)
        return total
