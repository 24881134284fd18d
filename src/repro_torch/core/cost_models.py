"""Device / edge cost models (paper §II-B, §II-C, Table I).

Device m (CPU, DVFS f_m ∈ [f_min, f_max]):
    latency  l_mn = ζ_m g_n A_n / f_m            (Eq. 1)
    energy   e_mn = κ_m q_n A_n f_m²             (Eq. 2)
    uplink   l_u  = O_n / R_m,  e_u = l_u p_u    (Eqs. 3-4)

Edge accelerator (frequency f_e ∈ [f_e,min, f_e,max], batch size b):
    latency  L_n(f_e,b) = d_n(b) A_n / f_e       (Eq. 5)
    energy   E_n(f_e,b) = c_n(b) A_n f_e²
with affine batch profiles  d_n(b) = δ0_n + δ1_n·b  and
c_n(b) = ε0_n + ε1_n·b,  which reproduce the paper's Fig. 3 shape: total
latency/energy increase with b while per-sample cost decreases (the δ0/ε0
startup terms amortize).  The affine form makes every suffix sum
φ_ñ(B) = Σ_{n>ñ} d_n(B)A_n and ψ_ñ(B) = Σ_{n>ñ} c_n(B)A_n affine in B,
which the vectorized J-DOB sweep exploits.

Calibration follows the paper's Table I: α_m (local/edge latency ratio at
max freqs, b=1) and η_m (local/edge power ratio) tie the device constants
ζ_m, κ_m to the edge profile, instead of inventing independent numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .task_model import TaskProfile


@dataclasses.dataclass(frozen=True)
class EdgeProfile:
    """Edge accelerator batch-processing profile (Eq. 5)."""

    f_min: float            # Hz
    f_max: float            # Hz
    delta0: np.ndarray      # (N+1,) cycles/FLOP, startup (batch-indep) term
    delta1: np.ndarray      # (N+1,) cycles/FLOP per batch element
    eps0: np.ndarray        # (N+1,) J/(FLOP·Hz²) startup term
    eps1: np.ndarray        # (N+1,) J/(FLOP·Hz²) per batch element
    name: str = "edge"

    def d(self, n, b):
        return self.delta0[n] + self.delta1[n] * b

    def c(self, n, b):
        return self.eps0[n] + self.eps1[n] * b

    # --- paper notation: φ_ñ(B) and ψ_ñ(B) as suffix sums over blocks > ñ ---
    def phi_coeffs(self, profile: TaskProfile):
        """Returns (base, slope): φ_ñ(B) = base[ñ] + slope[ñ]·B, ñ = 0..N."""
        a0 = self.delta0 * profile.A
        a1 = self.delta1 * profile.A
        # suffix sums over n in [ñ+1, N]
        base = np.concatenate([np.cumsum(a0[::-1])[::-1][1:], [0.0]])
        slope = np.concatenate([np.cumsum(a1[::-1])[::-1][1:], [0.0]])
        return base, slope

    def psi_coeffs(self, profile: TaskProfile):
        e0 = self.eps0 * profile.A
        e1 = self.eps1 * profile.A
        base = np.concatenate([np.cumsum(e0[::-1])[::-1][1:], [0.0]])
        slope = np.concatenate([np.cumsum(e1[::-1])[::-1][1:], [0.0]])
        return base, slope

    def batch_latency(self, profile: TaskProfile, n_from: int, b: int,
                      f_e: float) -> float:
        base, slope = self.phi_coeffs(profile)
        return (base[n_from] + slope[n_from] * b) / f_e

    def batch_energy(self, profile: TaskProfile, n_from: int, b: int,
                     f_e: float) -> float:
        base, slope = self.psi_coeffs(profile)
        return (base[n_from] + slope[n_from] * b) * f_e ** 2


@dataclasses.dataclass(frozen=True)
class DeviceFleet:
    """M mobile devices (arrays of shape (M,)).

    ``rate`` is the uplink rate Eqs. 3-4 price (the static channel; the
    contended and fading channel models are not ported yet).
    """

    zeta: np.ndarray      # cycles per FLOP
    kappa: np.ndarray     # J/(cycle·Hz²)  (effective switched capacitance)
    f_min: np.ndarray     # Hz
    f_max: np.ndarray     # Hz
    rate: np.ndarray      # uplink bytes/s
    p_up: np.ndarray      # uplink W
    deadline: np.ndarray  # T_m^(d), seconds

    @property
    def M(self) -> int:
        return len(self.zeta)

    def subset(self, idx) -> "DeviceFleet":
        arrays = {f.name: getattr(self, f.name)[idx]
                  for f in dataclasses.fields(self)}
        return dataclasses.replace(self, **arrays)

    def local_latency(self, profile: TaskProfile, f=None) -> np.ndarray:
        f = self.f_max if f is None else f
        return self.zeta * profile.v()[-1] / f

    def local_energy(self, profile: TaskProfile, f=None) -> np.ndarray:
        f = self.f_max if f is None else f
        return self.kappa * profile.u()[-1] * f ** 2

    def min_local_latency(self, profile: TaskProfile) -> np.ndarray:
        return self.local_latency(profile)


# ---------------------------------------------------------------------------
# Profile builders
# ---------------------------------------------------------------------------

def make_edge_profile(profile: TaskProfile,
                      f_min: float = 0.2e9,
                      f_max: float = 2.1e9,
                      lat_b1: float = 4.0e-3,
                      batch_startup: float = 8.0,
                      energy_b1: float = 0.35,
                      energy_startup: float = 8.0,
                      name: str = "rtx3090-fit") -> EdgeProfile:
    """Fit an affine batch profile to Fig.-3-shaped curves.

    ``lat_b1``/``energy_b1``: whole-network latency (s) / energy (J) at
    batch 1 and f_e = f_max.  ``batch_startup`` is the δ0/δ1 ratio: the
    batch size at which the amortizable startup cost equals the marginal
    cost (per-sample latency at b→∞ is 1/(1+batch_startup) of b=1 —
    matching the ≈8× per-sample efficiency visible in Fig. 3).
    """
    n_blocks = len(profile.A)
    total = profile.total_flops
    # distribute cycles proportionally to A_n => constant cycles/FLOP factors
    d1 = lat_b1 * f_max / (total * (batch_startup + 1.0))
    delta1 = np.full(n_blocks, d1)
    delta0 = delta1 * batch_startup
    e1 = energy_b1 / (total * f_max ** 2 * (energy_startup + 1.0))
    eps1 = np.full(n_blocks, e1)
    eps0 = eps1 * energy_startup
    return EdgeProfile(f_min, f_max, delta0, delta1, eps0, eps1, name)


def make_fleet(M: int,
               profile: TaskProfile,
               edge: EdgeProfile,
               beta,
               *,
               alpha=1.0,
               eta=0.6,
               snr_db: float = 30.0,
               bandwidth_hz: float = 10e6,
               p_up: float = 1.0,
               f_min: float = 1.5e9,
               f_max: float = 2.6e9,
               seed: int | None = None) -> DeviceFleet:
    """Build the Table-I fleet, calibrated against the edge profile.

    * α: local latency / edge-b1 latency (both at max freq)  → fixes ζ_m.
    * η: local power / edge-b1 power (both at max freq)      → fixes κ_m.
    * β: deadline tightness; T_m = (1 + β_m) · own min-local-latency.

    α, η, β each accept a scalar (the paper's identical-device setting), a
    (lo, hi) range sampled per user, or an (M,) array — heterogeneous
    fleets (slow/efficient phones next to fast/hungry ones) exercise the
    per-user ζ_m/κ_m paths of Eqs. 17-21 that identical devices leave
    degenerate.
    """
    rng = np.random.default_rng(seed)

    def expand(x):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 0:
            return np.full(M, float(x))
        if x.shape == (2,):
            return rng.uniform(x[0], x[1], size=M)
        assert x.shape == (M,)
        return x

    rate = bandwidth_hz * np.log2(1.0 + 10 ** (snr_db / 10.0)) / 8.0  # bytes/s
    edge_lat_b1 = edge.batch_latency(profile, 0, 1, edge.f_max)
    edge_en_b1 = edge.batch_energy(profile, 0, 1, edge.f_max)
    edge_pow_b1 = edge_en_b1 / edge_lat_b1

    alphas = expand(alpha)
    etas = expand(eta)
    betas = expand(beta)
    local_lat = alphas * edge_lat_b1                  # (M,)
    zeta = f_max * local_lat / profile.v()[-1]
    local_pow = etas * edge_pow_b1
    kappa = local_pow * local_lat / (profile.u()[-1] * f_max ** 2)
    deadlines = (1.0 + betas) * local_lat

    ones = np.ones(M)
    return DeviceFleet(zeta=zeta, kappa=kappa,
                       f_min=f_min * ones, f_max=f_max * ones,
                       rate=rate * ones, p_up=p_up * ones,
                       deadline=deadlines)
