"""The paper's contribution: J-DOB scheduling for multiuser co-inference
(the offline-wave slice of ``repro.core``)."""
from .task_model import TaskProfile, mobilenet_v2_profile, profile_from_arch
from .cost_models import DeviceFleet, EdgeProfile, make_edge_profile, make_fleet
from .timeline import GpuTimeline, Reservation, TimelineCursor
from .jdob import (BatchedPlanner, ExecutableCache, PendingPlans,
                   PlannerStats, Schedule, jdob_energy_grid,
                   jdob_plan_batched, jdob_schedule, make_f_sweep)
from .reference import jdob_reference
from .baselines import (local_computing, jdob_binary, jdob_no_edge_dvfs,
                        jdob_plus)
from .planner_service import PlannerService, planner_spec
from .grouping import (GroupedSchedule, optimal_grouping,
                       optimal_grouping_reference, single_group)
from .telemetry import note_runtime_event, runtime_events

__all__ = [
    "TaskProfile", "mobilenet_v2_profile", "profile_from_arch",
    "DeviceFleet", "EdgeProfile", "make_edge_profile", "make_fleet",
    "GpuTimeline", "Reservation", "TimelineCursor",
    "BatchedPlanner", "ExecutableCache", "PendingPlans", "PlannerStats",
    "Schedule", "jdob_energy_grid", "jdob_plan_batched", "jdob_schedule",
    "make_f_sweep", "jdob_reference", "local_computing", "jdob_binary",
    "jdob_no_edge_dvfs", "jdob_plus", "PlannerService", "planner_spec",
    "GroupedSchedule", "optimal_grouping", "optimal_grouping_reference",
    "single_group", "note_runtime_event", "runtime_events",
]
