"""J-DOB: Joint DVFS, Offloading and Batching (paper Alg. 1 + Alg. 2), in
PyTorch.

The counterpart of ``repro.core.jdob``'s batched core:

* :func:`jdob_plan_batched` — solves **G padded groups at once**.  Each
  group is a user subset of a common width ``M_max`` with a boolean
  activity mask; masked users contribute exactly zero energy, sort behind
  every active user, and never enter the greedy batching set.  The outer
  loop over partition points ñ (Alg. 1 line 3) and the edge-frequency sweep
  (Alg. 2 lines 6-24) are written out as tensor dimensions: one
  (G, ñ, f_e, M) evaluation, then an argmin over each group's (ñ, f_e)
  grid and a gather of the winning cell.
* :class:`BatchedPlanner` — caches the task/edge constants and the
  frequency sweep on the planner's device, pads group widths to
  power-of-two buckets and chunks large batches.
* :func:`jdob_schedule` — the single-group API (a batch of one).

Arithmetic parity with the reference: the reference runs this math in
float32 (JAX x64 is off) and its compiler contracts each ``a * b + c``
whose product feeds only the sum into one fused multiply-add.  This module
reproduces that rounding explicitly with :func:`_fma`, keeps every other
operation in the reference's order, sums users with the same
padding-invariant power-of-two fold, sorts with a stable sort, and
reconstructs the winner on the host in float64, so its schedules match the
reference bit for bit, on the CPU and on the card alike.

Internally everything is scaled to (GHz, seconds, J) so the math is well
conditioned in float32; public inputs/outputs stay SI (Hz).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from .cost_models import DeviceFleet, EdgeProfile
from .task_model import TaskProfile

_GHZ = 1e9
_INF = float("inf")
_F32 = torch.float32

#: per-user entries of the planner's constant dict (batched to (G, M_max))
_USER_KEYS = ("zeta", "ku", "fm_min", "fm_max", "rate", "p_up", "T")
#: neutral padding so masked users never produce inf/nan intermediates
_PAD_VALUES = dict(zeta=0.0, ku=0.0, fm_min=1.0, fm_max=1.0,
                   rate=1.0, p_up=0.0, T=1.0)
SORT_KEYS = ("gamma", "budget", "energy")


@dataclasses.dataclass
class Schedule:
    """One group's co-inference strategy 𝒳 = (M'_o, ñ, {f_m}, f_e)."""

    feasible: bool
    energy: float                 # total J (device + uplink + edge)
    partition: int                # ñ: offload after block ñ (ñ=N ⇒ all local)
    f_edge: float                 # Hz
    offload: np.ndarray           # (M,) bool
    f_device: np.ndarray          # (M,) Hz
    t_free_end: float             # Eq. 22: when the GPU frees up
    terms: dict                   # energy breakdown
    per_user_energy: np.ndarray   # (M,)
    # reservation geometry: the edge run is gpu_busy = φ_ñ(B)/f_e seconds
    # ending at t_free_end, and its energy is edge_psi·f_e² — all zero for
    # an all-local plan
    gpu_busy: float = 0.0         # s the GPU is genuinely occupied
    edge_phi: float = 0.0         # φ_ñ(B): suffix GPU cycles (Hz·s)
    edge_psi: float = 0.0         # ψ_ñ(B): edge energy / f_e² (J/Hz²)

    @property
    def batch_size(self) -> int:
        return int(self.offload.sum())

    @property
    def gpu_start(self) -> float:
        """When the GPU genuinely begins this batch (relative, like
        ``t_free_end``)."""
        return self.t_free_end - self.gpu_busy


def _f32(x, device) -> torch.Tensor:
    """float64 host values → float32 on ``device`` (round to nearest, as
    the reference's float64 → float32 conversion)."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(device=device,
                                                         dtype=_F32)


def _prep_blocks(profile: TaskProfile, edge: EdgeProfile, device) -> dict:
    """Per-block constants shared by every group (scaled to GHz/s/J)."""
    phi_b, phi_s = edge.phi_coeffs(profile)
    psi_b, psi_s = edge.psi_coeffs(profile)
    return dict(
        v=_f32(profile.v() / _GHZ, device),              # Gcycles/ζ
        u=_f32(profile.u(), device),
        o_up=_f32(profile.O, device),                    # bytes
        phi_b=_f32(phi_b / _GHZ, device), phi_s=_f32(phi_s / _GHZ, device),
        psi_b=_f32(psi_b * _GHZ ** 2, device),
        psi_s=_f32(psi_s * _GHZ ** 2, device),
    )


def _pad_fleets(fleets: Sequence[DeviceFleet], m_pad: int, device):
    """Stack per-user constants of G fleets into (G, m_pad) tensors + mask."""
    G = len(fleets)
    out = {k: np.full((G, m_pad), _PAD_VALUES[k], np.float64)
           for k in _USER_KEYS}
    mask = np.zeros((G, m_pad), bool)
    for g, fl in enumerate(fleets):
        m = fl.M
        out["zeta"][g, :m] = fl.zeta
        out["ku"][g, :m] = fl.kappa * _GHZ ** 2
        out["fm_min"][g, :m] = fl.f_min / _GHZ
        out["fm_max"][g, :m] = fl.f_max / _GHZ
        out["rate"][g, :m] = fl.rate
        out["p_up"][g, :m] = fl.p_up
        out["T"][g, :m] = fl.deadline
        mask[g, :m] = True
    return ({k: _f32(v, device) for k, v in out.items()},
            torch.as_tensor(mask).to(device))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it.  The float32 product is exact in float64, so the only extra
    rounding is float64 → float32 of the sum."""
    return (a.double() * b.double() + c.double()).to(_F32)


def _pow2_sum(x):
    """Padding-invariant float sum over the last dim: zero-pad to a power
    of two, then fold halves.  All-zero halves collapse exactly
    (x + 0.0 == x bitwise), so a group solved at any padded width
    M_pad ≥ M produces bit-identical sums to the unpadded solve."""
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], dim=-1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _plan(c, f_sweep, t_free, mask, row_ok, sort_key: str) -> dict:
    """Dense Alg. 1+2 evaluation + argmin + winner gather for G masked
    groups.  Shapes: users (G, M), blocks (NP,), ``f_sweep`` (K,),
    ``t_free`` (G,), ``row_ok`` (NP,) bool of candidate partitions (row
    ñ = N, the all-local strategy, is never one: the host handles it in
    closed form)."""
    G, M = mask.shape
    NP = c["v"].shape[0]
    K = f_sweep.shape[0]
    dev = mask.device
    act = mask
    zeta, ku, fmn, fmx, rate, pup, T = (c[k] for k in _USER_KEYS)
    # ---- per-user all-local optimum (Eq. 20 local branch) ---------------
    f_loc = _clip(zeta * c["v"][-1] / T, fmn, fmx)
    e_loc = torch.where(act, ku * c["u"][-1] * (f_loc * f_loc), 0.0)

    # ---- Alg. 1 lines 4-6 per partition: (G, NP, M) ----------------------
    V = c["v"][None, :, None]
    o_r = c["o_up"][None, :, None] / rate[:, None, :]      # O_ñ / R_m
    zv = zeta[:, None, :] * V
    gamma = o_r + zv / fmx[:, None, :]                     # Eq. 17
    if sort_key == "gamma":
        key = -gamma
    elif sort_key == "budget":
        key = T[:, None, :] - gamma
    elif sort_key == "energy":
        key = (ku * c["u"][-1] * (f_loc * f_loc))[:, None, :].expand(
            G, NP, M)
    else:
        raise ValueError(f"unknown sort key {sort_key!r}")
    actN = act[:, None, :].expand(G, NP, M)
    order = torch.sort(torch.where(actN, key, _INF), dim=-1,
                       stable=True).indices
    g_s = torch.gather(gamma, 2, order)
    T_s = torch.gather(torch.where(act, T, _INF)[:, None, :].expand(G, NP, M),
                       2, order)
    act_s = torch.gather(actN, 2, order)
    # suffix-min of deadlines (l_o for list[i:]) and active suffix counts
    suffT = torch.flip(torch.cummin(torch.flip(T_s, [-1]), dim=-1).values,
                       [-1])
    b_if_in = torch.flip(torch.cumsum(torch.flip(act_s.to(_F32), [-1]),
                                      dim=-1), [-1])
    phi_b = c["phi_b"][None, :, None]
    phi_s = c["phi_s"][None, :, None]
    phi_i = _fma(phi_s, b_if_in, phi_b)
    denom = suffT - g_s
    th = torch.where(act_s & (denom > 0),
                     phi_i / torch.clamp(denom, min=1e-30), _INF)  # Eq. 18

    # ---- Alg. 2 per (ñ, f_e) cell: (G, NP, K[, M]) -----------------------
    fK = f_sweep[None, None, :]
    ok = th[:, :, None, :] <= f_sweep[None, None, :, None]
    j = torch.where(ok.any(-1), ok.to(torch.int32).argmax(-1),
                    torch.full((), M, dtype=torch.int64, device=dev))
    jc = torch.clamp(j, max=M - 1)
    B_o = torch.where(j < M, torch.gather(b_if_in, 2, jc), 0.0)
    has = B_o > 0
    l_o = torch.gather(suffT, 2, jc)                       # Eq. 10
    phi = _fma(phi_s, B_o, phi_b)
    psi = _fma(c["psi_s"][None, :, None], B_o, c["psi_b"][None, :, None])
    gpu_ok = fK * (l_o - t_free[:, None, None]) >= phi     # Eq. 6
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(M, device=dev).expand(G, NP, M))
    off = (rank[:, :, None, :] >= j[..., None]) & act[:, None, None, :]
    # Eq. 19/20: optimal device DVFS
    o_r4 = o_r[:, :, None, :]
    slack = l_o[..., None] - o_r4 - (phi / fK)[..., None]
    zv4 = zv[:, :, None, :]
    gamma_off = torch.where(slack > 0,
                            zv4 / torch.clamp(slack, min=1e-30), _INF)
    fmn4, fmx4 = fmn[:, None, None, :], fmx[:, None, None, :]
    f_dev = torch.where(off, _clip(gamma_off, fmn4, fmx4),
                        f_loc[:, None, None, :])
    dev_ok = torch.where(off, gamma_off <= fmx4 * (1 + 1e-9), True)
    # Eq. 21: total energy
    e_up = o_r4 * pup[:, None, None, :]
    ku_u = ku[:, None, None, :] * c["u"][None, :, None, None]
    e_user = torch.where(off, _fma(ku_u, f_dev * f_dev, e_up),
                         e_loc[:, None, None, :])
    energy = _pow2_sum(e_user) + torch.where(has, psi * (fK * fK), 0.0)
    feas = has & gpu_ok & dev_ok.all(-1)
    # Eq. 22: end of GPU occupation
    t_up = torch.where(off, zv4 / f_dev + o_r4, -_INF)
    t_end = torch.maximum(t_free[:, None, None], t_up.amax(-1)) + phi / fK
    E = torch.where(feas & row_ok[None, :, None], energy, _INF)
    flat = torch.argmin(E.reshape(G, NP * K), dim=1)
    nt_b, fi_b = flat // K, flat % K
    g = torch.arange(G, device=dev)
    return dict(E=E, nt=nt_b, fi=fi_b, energy=E.reshape(G, -1)[g, flat],
                off=off[g, nt_b, fi_b], f_dev=f_dev[g, nt_b, fi_b],
                t_end=t_end[g, nt_b, fi_b], e_user=e_user[g, nt_b, fi_b])


def _row_ok(n_partitions: int, part_mask, device) -> torch.Tensor:
    ok = torch.ones(n_partitions, dtype=torch.bool, device=device)
    ok[n_partitions - 1] = False     # ñ = N: local computing, closed form
    if part_mask is not None:
        ok &= part_mask.to(device)
    return ok


def jdob_plan_batched(c_batch, f_sweep, t_free_batch, mask, part_mask=None,
                      *, n_partitions: int, sort_key: str = "gamma") -> dict:
    """Solve G padded groups in one pass.

    ``c_batch``: dict with per-block constants shaped (N+1,) (shared across
    groups) and per-user constants shaped (G, M_max) (see ``_USER_KEYS``);
    ``f_sweep``: (K,) shared GHz sweep; ``t_free_batch``: (G,) GPU release
    times; ``mask``: (G, M_max) bool — True for real users; ``part_mask``:
    optional (N+1,) bool restricting candidate partitions.  Returns a dict
    of stacked grids/winners: ``E`` (G, N+1, K),
    ``nt``/``fi``/``energy``/``t_end`` (G,), ``off``/``f_dev``/``e_user``
    (G, M_max)."""
    if c_batch["v"].shape[0] != n_partitions:
        raise ValueError("n_partitions disagrees with the block constants")
    return _plan(c_batch, f_sweep, t_free_batch, mask,
                 _row_ok(n_partitions, part_mask, mask.device), sort_key)


def make_f_sweep(edge: EdgeProfile, rho: float = 0.03e9) -> np.ndarray:
    """Alg. 2's frequency sweep grid (descending, includes f_max & f_min)."""
    k = int(np.floor((edge.f_max - edge.f_min) / rho + 1e-9)) + 1
    f = edge.f_max - rho * np.arange(k)
    # Append f_min only when the grid genuinely stops short of it; when the
    # last grid point lands on f_min (up to rounding), snap instead.
    if f[-1] - edge.f_min > 1e-9 * rho:
        f = np.concatenate([f, [edge.f_min]])
    else:
        f[-1] = edge.f_min
    return f


def _bucket(n: int, minimum: int = 4) -> int:
    """Next power of two ≥ n (≥ minimum) — the shape-bucketing unit."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class PlannerStats:
    """Per-planner shape-cache counters + plan-latency histogram.

    ``hits``/``misses``/``evictions`` count this planner's lookups against
    its :class:`ExecutableCache`; ``dispatches`` counts device passes,
    ``groups_planned`` real (unpadded) groups solved.  ``plan_calls``
    counts :meth:`BatchedPlanner.plan` invocations and ``plan_ns`` holds
    their wall-time samples (ns, dispatch through host reconstruction);
    samples whose dispatch missed the shape cache land in ``compile_ns``
    instead, so the steady-state percentiles are not owned by the first
    call of each shape.  Both sample lists are decimated (every other
    sample dropped) past ``LATENCY_CAP`` entries.  ``og_plans`` counts
    top-level grouping plans and ``og_dispatches`` the device passes
    issued inside them.

    :meth:`merge` derives from ``dataclasses.fields`` (override with
    ``metadata={"merge": "max"|"min_counted"}``)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    dispatches: int = 0
    groups_planned: int = 0
    plan_calls: int = 0
    plan_ns_min: int = dataclasses.field(
        default=0, metadata={"merge": "min_counted"})
    plan_ns_max: int = dataclasses.field(default=0, metadata={"merge": "max"})
    plan_ns: list = dataclasses.field(default_factory=list)
    compile_calls: int = 0
    compile_ns_max: int = dataclasses.field(default=0,
                                            metadata={"merge": "max"})
    compile_ns: list = dataclasses.field(default_factory=list)
    og_plans: int = 0
    og_dispatches: int = 0

    LATENCY_CAP = 8192

    @property
    def dispatches_per_plan(self) -> float:
        """Device passes per top-level grouping plan (0.0 before any)."""
        if not self.og_plans:
            return 0.0
        return self.og_dispatches / self.og_plans

    def record_latency(self, ns: int, compiled: bool = False) -> None:
        self.plan_calls += 1
        if compiled:
            self.compile_calls += 1
            self.compile_ns_max = max(self.compile_ns_max, ns)
            self.compile_ns.append(ns)
            if len(self.compile_ns) > self.LATENCY_CAP:
                del self.compile_ns[::2]
            return
        steady = self.plan_calls - self.compile_calls
        self.plan_ns_min = (ns if steady == 1
                            else min(self.plan_ns_min, ns))
        self.plan_ns_max = max(self.plan_ns_max, ns)
        self.plan_ns.append(ns)
        if len(self.plan_ns) > self.LATENCY_CAP:
            del self.plan_ns[::2]

    def plan_latency(self) -> dict:
        """min/p50/p99/max STEADY-STATE plan wall time in ms (zeros when
        never timed), plus the first-call bucket under ``compile``."""
        if self.compile_ns:
            c50 = float(np.percentile(np.asarray(self.compile_ns), 50)) / 1e6
        else:
            c50 = 0.0
        compile_bucket = dict(count=self.compile_calls, p50_ms=c50,
                              max_ms=self.compile_ns_max / 1e6)
        if not self.plan_ns:
            return dict(count=self.plan_calls, min_ms=0.0, p50_ms=0.0,
                        p99_ms=0.0, max_ms=0.0, compile=compile_bucket)
        p50, p99 = np.percentile(np.asarray(self.plan_ns), [50, 99])
        return dict(count=self.plan_calls,
                    min_ms=self.plan_ns_min / 1e6,
                    p50_ms=float(p50) / 1e6, p99_ms=float(p99) / 1e6,
                    max_ms=self.plan_ns_max / 1e6, compile=compile_bucket)

    def merge(self, other: "PlannerStats") -> "PlannerStats":
        """Field-driven merge: sum by default (``+`` also concatenates the
        latency sample lists), ``max`` / ``min_counted`` per metadata."""
        out = PlannerStats()
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            how = f.metadata.get("merge", "sum")
            if how == "sum":
                v = a + b
            elif how == "max":
                v = max(a, b)
            else:                                  # "min_counted"
                sn = self.plan_calls - self.compile_calls
                on = other.plan_calls - other.compile_calls
                if sn and on:
                    v = min(a, b)
                else:
                    v = a if sn else b
            setattr(out, f.name, v)
        return out


class _PlanProgram:
    """One cached batch shape: the pass's static arguments plus the
    constant tensors it needs on the device, so repeated dispatches of a
    shape rebuild nothing."""

    def __init__(self, n_partitions: int, sort_key: str, part_mask, device):
        self.sort_key = sort_key
        self.row_ok = _row_ok(n_partitions, part_mask, device)

    def __call__(self, c, f_sweep, t_free, mask) -> dict:
        return _plan(c, f_sweep, t_free, mask, self.row_ok, self.sort_key)


class ExecutableCache:
    """Bounded LRU of :class:`_PlanProgram` per batch shape.

    The reference caches compiled XLA executables here; PyTorch runs
    eagerly, so an entry holds what a shape can reuse (its static
    arguments and constant device tensors).  The cache keeps the
    reference's hit/miss/eviction accounting on :class:`PlannerStats`."""

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError("max_entries must be ≥ 1")
        self.max_entries = max_entries
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, shape: tuple, n_partitions: int, sort_key: str,
               part_mask, device, stats: PlannerStats | None = None
               ) -> _PlanProgram:
        key = (shape, n_partitions, sort_key,
               None if part_mask is None
               else tuple(part_mask.tolist()), str(device))
        prog = self._entries.get(key)
        if prog is not None:
            self._entries.move_to_end(key)
            if stats is not None:
                stats.hits += 1
            return prog
        if stats is not None:
            stats.misses += 1
        prog = _PlanProgram(n_partitions, sort_key, part_mask, device)
        self._entries[key] = prog
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            if stats is not None:
                stats.evictions += 1
        return prog


class BatchedPlanner:
    """Plans many co-inference groups per device pass.

    Caches the scaled task/edge constants and the frequency sweep on
    ``device``; pads group widths to power-of-two buckets and splits large
    batches into fixed-size chunks.  ``sort_keys`` with more than one
    entry evaluates the beyond-paper J-DOB+ ordering portfolio and keeps,
    per group, the best result (ties prefer the earlier key)."""

    def __init__(self, profile: TaskProfile, edge: EdgeProfile, *,
                 rho: float = 0.03e9, sort_keys: Sequence[str] = ("gamma",),
                 edge_dvfs: bool = True,
                 partitions: Sequence[int] | None = None,
                 group_chunk: int = 256, min_user_bucket: int = 4,
                 cache: ExecutableCache | None = None, device=None):
        for key in sort_keys:
            if key not in SORT_KEYS:
                raise ValueError(f"unknown sort key {key!r}")
        self.device = resolve_device(device)
        self.profile = profile
        self.edge = edge
        self.rho = rho
        self.cache = cache if cache is not None else ExecutableCache()
        self.stats = PlannerStats()
        self.sort_keys = tuple(sort_keys)
        self.edge_dvfs = edge_dvfs
        self.partitions = None if partitions is None else tuple(partitions)
        self.group_chunk = group_chunk
        self.min_user_bucket = min_user_bucket
        self.blocks = _prep_blocks(profile, edge, self.device)
        if edge_dvfs:
            self.f_sweep_np = make_f_sweep(edge, rho)
        else:
            self.f_sweep_np = np.asarray([edge.f_max])
        self.f_sweep = _f32(self.f_sweep_np / _GHZ, self.device)
        if partitions is not None:
            pm = np.zeros(profile.N + 1, bool)
            pm[list(partitions)] = True
            self.part_mask = torch.as_tensor(pm)
        else:
            self.part_mask = None
        self.phi_b, self.phi_s = edge.phi_coeffs(profile)
        self.psi_b, self.psi_s = edge.psi_coeffs(profile)
        self._vN = profile.v()[-1]
        self._uN = profile.u()[-1]

    # ---- device passes -------------------------------------------------
    def _run(self, fleets, t_frees, m_pad: int):
        """One padded batch through the core (per sort key)."""
        users, mask = _pad_fleets(fleets, m_pad, self.device)
        c = {**self.blocks, **users}
        tf = _f32(t_frees, self.device)
        outs = []
        for key in self.sort_keys:
            prog = self.cache.lookup(
                (len(fleets), m_pad, len(self.f_sweep_np)),
                self.profile.N + 1, key, self.part_mask, self.device,
                stats=self.stats)
            self.stats.dispatches += 1
            outs.append(prog(c, self.f_sweep, tf, mask))
        return outs

    def _dispatch(self, fleets: Sequence[DeviceFleet],
                  t_frees: Sequence[float], pad_users: bool,
                  m_pad: int | None, g_pad: int | None) -> list[tuple]:
        """Issue every device pass of a :meth:`plan` call; returns the
        in-flight chunks as ``(start, n_real, outs_on_device)``."""
        G = len(fleets)
        m_max = max(fl.M for fl in fleets)
        if m_pad is not None:
            if m_pad < m_max:
                raise ValueError(f"m_pad={m_pad} below the widest group "
                                 f"({m_max} users)")
        elif pad_users:
            m_pad = _bucket(m_max, self.min_user_bucket)
        else:
            m_pad = m_max
        chunk = self.group_chunk
        if G > chunk:
            starts = range(0, G, chunk)
        elif g_pad is not None:
            if g_pad < G:
                raise ValueError(f"g_pad={g_pad} below the group count {G}")
            starts = [0]
            chunk = g_pad
        else:
            starts = [0]
            chunk = _bucket(G, 1) if pad_users else G
        pad_fleet = fleets[0].subset(np.arange(0))      # zero-user filler
        chunks = []
        for s in starts:
            part = list(fleets[s:s + chunk])
            tfs = list(t_frees[s:s + chunk])
            n_real = len(part)
            while len(part) < chunk:                    # ragged last chunk
                part.append(pad_fleet)
                tfs.append(0.0)
            chunks.append((s, n_real, self._run(part, tfs, m_pad)))
        return chunks

    def _materialize(self, fleets, t_frees, chunks) -> list[Schedule]:
        schedules: list[Schedule] = []
        for s, n_real, outs in chunks:
            # one device→host transfer per output array ("E" stays on the
            # device — reconstruction never reads the full grid)
            outs = [{k: v.cpu().numpy() for k, v in o.items() if k != "E"}
                    for o in outs]
            self.stats.groups_planned += n_real
            for g in range(n_real):
                schedules.append(self._reconstruct(
                    fleets[s + g], float(t_frees[s + g]), outs, g))
        return schedules

    def plan(self, fleets: Sequence[DeviceFleet],
             t_frees: Sequence[float] | None = None,
             pad_users: bool = True, m_pad: int | None = None,
             g_pad: int | None = None) -> list[Schedule]:
        """Solve every group; returns one :class:`Schedule` per fleet.
        ``m_pad``/``g_pad`` pin the padded user width / group count;
        padding never changes results."""
        return self.plan_async(fleets, t_frees, pad_users=pad_users,
                               m_pad=m_pad, g_pad=g_pad).get()

    def plan_async(self, fleets: Sequence[DeviceFleet],
                   t_frees: Sequence[float] | None = None,
                   pad_users: bool = True, m_pad: int | None = None,
                   g_pad: int | None = None) -> "PendingPlans":
        """Like :meth:`plan`, but returns a :class:`PendingPlans` handle
        whose results stay on the device until :meth:`PendingPlans.get`:
        a caller with several independent batches issues them all before
        paying any host transfer."""
        t0 = time.perf_counter_ns()
        G = len(fleets)
        if G == 0:
            return PendingPlans(self, [], [], [], t0)
        if t_frees is None:
            t_frees = [0.0] * G
        m0 = self.stats.misses
        chunks = self._dispatch(fleets, t_frees, pad_users, m_pad, g_pad)
        return PendingPlans(self, list(fleets), list(t_frees), chunks, t0,
                            compiled=self.stats.misses > m0)

    # ---- host-side winner reconstruction ------------------------------
    def _reconstruct(self, fleet: DeviceFleet, t_free: float, outs,
                     g: int) -> Schedule:
        profile, edge = self.profile, self.edge
        # portfolio combine: strict < keeps the earlier sort key on ties
        best = 0
        e_best = float(outs[0]["energy"][g])
        for i in range(1, len(outs)):
            e_i = float(outs[i]["energy"][g])
            if e_i < e_best:
                best, e_best = i, e_i
        out = outs[best]
        # all-local fallback (ñ = N branch of Alg. 1), float64 so it agrees
        # bit for bit with the LC baseline
        f_loc64 = np.clip(fleet.zeta * self._vN / fleet.deadline,
                          fleet.f_min, fleet.f_max)
        e_loc64 = fleet.kappa * self._uN * f_loc64 ** 2
        e_all_local = float(e_loc64.sum())
        if not np.isfinite(e_best) or e_all_local <= e_best:
            return Schedule(True, e_all_local, profile.N, float(edge.f_max),
                            np.zeros(fleet.M, bool), f_loc64, t_free,
                            dict(device=e_all_local, uplink=0.0, edge=0.0),
                            e_loc64)
        M = fleet.M
        nt = int(out["nt"][g])
        fi = int(out["fi"][g])
        off_b = out["off"][g][:M]
        f_dev_b = np.asarray(out["f_dev"][g], np.float64)[:M] * _GHZ
        f_e = float(self.f_sweep_np[fi])
        eu = out["e_user"][g][:M]
        B = int(off_b.sum())
        up = float((profile.O[nt] / fleet.rate * fleet.p_up)[off_b].sum())
        edge_phi = float(self.phi_b[nt] + self.phi_s[nt] * B)
        edge_psi = float(self.psi_b[nt] + self.psi_s[nt] * B)
        edge_e = edge_psi * f_e ** 2
        dev = e_best - up - edge_e
        return Schedule(True, e_best, nt, f_e, off_b, f_dev_b,
                        float(out["t_end"][g]),
                        dict(device=dev, uplink=up, edge=edge_e), eu,
                        gpu_busy=edge_phi / f_e, edge_phi=edge_phi,
                        edge_psi=edge_psi)


class PendingPlans:
    """A dispatched-but-unmaterialized :meth:`BatchedPlanner.plan_async`
    batch: :meth:`get` performs the host transfer + winner reconstruction
    once (memoized) and records the planner's latency sample."""

    def __init__(self, planner: BatchedPlanner, fleets, t_frees, chunks,
                 t0_ns: int, compiled: bool = False):
        self._planner = planner
        self._fleets = fleets
        self._t_frees = t_frees
        self._chunks = chunks
        self._t0_ns = t0_ns
        self._compiled = compiled
        self._result: list[Schedule] | None = None

    def get(self) -> list[Schedule]:
        if self._result is None:
            self._result = self._planner._materialize(
                self._fleets, self._t_frees, self._chunks)
            self._planner.stats.record_latency(
                time.perf_counter_ns() - self._t0_ns,
                compiled=self._compiled)
            self._chunks = None          # free the device buffers
        return self._result


def jdob_schedule(profile: TaskProfile,
                  fleet: DeviceFleet,
                  edge: EdgeProfile,
                  t_free: float = 0.0,
                  rho: float = 0.03e9,
                  partitions: Sequence[int] | None = None,
                  edge_dvfs: bool = True,
                  sort_key: str = "gamma",
                  device=None) -> Schedule:
    """Run J-DOB for one group (a batch of one through the batched core).
    ``partitions`` restricts ñ candidates (``[0, N]`` gives the
    J-DOB-binary baseline); ``edge_dvfs=False`` pins f_e = f_e,max;
    ``sort_key="budget"`` selects the beyond-paper J-DOB+ user ordering."""
    planner = BatchedPlanner(profile, edge, rho=rho, sort_keys=(sort_key,),
                             edge_dvfs=edge_dvfs, partitions=partitions,
                             device=device)
    return planner.plan([fleet], [t_free], pad_users=False)[0]


def jdob_energy_grid(profile: TaskProfile, fleet: DeviceFleet,
                     edge: EdgeProfile, t_free: float = 0.0,
                     rho: float = 0.03e9, device=None) -> np.ndarray:
    """(N+1, k) energy grid — diagnostics + the sweep kernel's oracle."""
    dev = resolve_device(device)
    users, mask = _pad_fleets([fleet], fleet.M, dev)
    out = jdob_plan_batched({**_prep_blocks(profile, edge, dev), **users},
                            _f32(make_f_sweep(edge, rho) / _GHZ, dev),
                            _f32([t_free], dev), mask,
                            n_partitions=profile.N + 1)
    return out["E"][0].cpu().numpy()
