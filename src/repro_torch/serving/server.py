"""Co-inference serving: J-DOB-scheduled multi-user batched execution
(the offline wave of ``repro.serving.server``).

``CoInferenceServer.serve`` is the system the paper describes, end to end:

  1. ``M`` device requests arrive (tokens + per-user deadline).
  2. The outer OG module groups users by deadline; per group the J-DOB
     inner module picks (ñ, M'_o, f_e, {f_m}).
  3. Devices compute blocks 1..ñ on their inputs (executed here on the
     same weights), "upload" the boundary activation, and the edge runs
     blocks ñ+1..N as ONE batch.
  4. Local users run the whole model themselves.

Online serving and the multi-tenant server are not ported yet (ROADMAP
queue 1, items 6 and 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (DeviceFleet, EdgeProfile, PlannerService,
                              Schedule, TaskProfile, jdob_schedule)
from repro_torch.device import resolve_device
from .engine import BlockwiseExecutor


@dataclasses.dataclass
class Request:
    user: int
    tokens: np.ndarray              # (S,) int32
    deadline: float                 # seconds


@dataclasses.dataclass
class ServeReport:
    logits: np.ndarray              # (M, S, V) — last block's output
    schedules: list[Schedule]
    groups: list[np.ndarray]
    energy: float
    per_user_energy: np.ndarray
    batch_sizes: list[int]
    partitions: list[int]
    t_free_end: float


def run_partitioned(executor: BlockwiseExecutor, vocab_size: int,
                    requests: list[Request], sched: Schedule) -> np.ndarray:
    """Execute one planned batch on the model: local users run the whole
    network, offloaded users run blocks 1..ñ "on device", upload the
    boundary activation, and the edge batches the suffix.  J-DOB block
    n ∈ {1..N} is transformer layer n (embedding folded into block 1, LM
    head into block N)."""
    ex = executor
    tokens = ex.tokens(np.stack([r.tokens for r in requests]))
    n_layers = len(ex.layers)
    nt = sched.partition
    h = ex.embed(tokens)
    out = np.zeros((len(requests),) + tuple(h.shape[1:-1]) + (vocab_size,),
                   np.float32)
    off = torch.as_tensor(sched.offload, device=h.device)
    loc = ~off
    if not sched.offload.all():
        hl = ex.run_blocks(h[loc], 0, n_layers)
        out[np.where(~sched.offload)[0]] = ex.head(hl).cpu().numpy()
    if sched.offload.any():
        # device side: blocks 1..nt (capped at n_layers — block N is the
        # head, edge-only here), then the edge batches the suffix
        dev_hi = min(nt, n_layers)
        ho = ex.run_blocks(h[off], 0, dev_hi)
        ho = ex.run_blocks(ho, dev_hi, n_layers)
        out[np.where(sched.offload)[0]] = ex.head(ho).cpu().numpy()
    return out


class CoInferenceServer:
    def __init__(self, cfg: ArchConfig, params, profile: TaskProfile,
                 fleet: DeviceFleet, edge: EdgeProfile,
                 inner: Callable = jdob_schedule, rho: float = 0.03e9,
                 service: PlannerService | None = None, device=None):
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device},"
                             f" the server on {self.device}")
        self.cfg = cfg
        self.executor = BlockwiseExecutor(cfg, params)
        self.profile = profile
        self.fleet = fleet
        self.edge = edge
        self.inner = inner
        self.rho = rho
        # one planner service per server: the OG segment solves of every
        # serve() share its planners and shape cache, on the server's device
        self.service = (service if service is not None
                        else PlannerService(profile, edge, rho=rho,
                                            device=self.device))
        if self.service.device.type != self.device.type:
            raise ValueError("planner service and server disagree on device")
        self.planner = self.service.planner_for(inner)
        n_layers = len(self.executor.layers)
        if profile.N != n_layers:
            raise ValueError(f"profile N={profile.N} vs layers={n_layers}")

    def _run_schedule(self, requests: list[Request], sched: Schedule):
        return run_partitioned(self.executor, self.cfg.vocab_size,
                               requests, sched)

    def serve(self, requests: list[Request],
              t_free: float = 0.0) -> ServeReport:
        """One-shot wave: OG-group, plan and execute every request."""
        fleet = dataclasses.replace(
            self.fleet,
            deadline=np.asarray([r.deadline for r in requests]))
        grouped = self.service.plan_fleet(fleet, self.inner, t_free=t_free)
        S = len(requests[0].tokens)
        logits = np.zeros((len(requests), S, self.cfg.vocab_size),
                          np.float32)
        for g, sched in zip(grouped.groups, grouped.schedules):
            sub = [requests[i] for i in g]
            logits[g] = self._run_schedule(sub, sched)
        return ServeReport(
            logits=logits, schedules=grouped.schedules,
            groups=grouped.groups, energy=grouped.energy,
            per_user_energy=grouped.per_user_energy,
            batch_sizes=[s.batch_size for s in grouped.schedules],
            partitions=[s.partition for s in grouped.schedules],
            t_free_end=grouped.t_free_end)
