"""The port's planner against the reference planner, bit for bit.

The reference runs its planner core in float32 (JAX x64 is off) with
fused multiply-adds, a power-of-two user fold, a stable sort and a
float64 host reconstruction; the port reproduces each, so schedules,
groupings and energies are compared with ``==``.  The one stated
tolerance is the full (ñ × f_e) diagnostic grid, where the reference's
compiler fuses the per-user energy's multiply-add in some lanes of the
grid and not in others: a few non-winning cells differ by at most 2.1e-7
relative (2 ulp, measured), and the test holds them at 5e-7; the winning
cells, and so every schedule, are bitwise equal."""
import numpy as np
import pytest

import repro.core as J
import repro.kernels as JK
import repro_torch.core as T
from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.timeline import GpuTimeline
from repro_torch.kernels import jdob_sweep_schedule

J_PROF = J.mobilenet_v2_profile()
J_EDGE = J.make_edge_profile(J_PROF)
T_PROF = T.mobilenet_v2_profile()
T_EDGE = T.make_edge_profile(T_PROF)
CPU = "cpu"


def fleets(M, beta, seed=0):
    return (J.make_fleet(M, J_PROF, J_EDGE, beta=beta, seed=seed),
            T.make_fleet(M, T_PROF, T_EDGE, beta=beta, seed=seed))


def assert_same_schedule(a, b):
    assert a.energy == b.energy
    assert a.partition == b.partition
    assert a.f_edge == b.f_edge
    assert a.t_free_end == b.t_free_end
    assert a.gpu_busy == b.gpu_busy
    assert a.terms == b.terms
    np.testing.assert_array_equal(a.offload, b.offload)
    np.testing.assert_array_equal(a.per_user_energy, b.per_user_energy)
    np.testing.assert_array_equal(a.f_device, b.f_device)


def assert_same_grouping(a, b):
    assert a.energy == b.energy
    assert a.t_free_end == b.t_free_end
    assert [g.tolist() for g in a.groups] == [g.tolist() for g in b.groups]
    np.testing.assert_array_equal(a.per_user_energy, b.per_user_energy)
    for sa, sb in zip(a.schedules, b.schedules):
        assert_same_schedule(sa, sb)


def test_task_and_fleet_models_are_copies():
    jf, tf = fleets(7, (0.0, 10.0), seed=3)
    for name in ("zeta", "kappa", "f_min", "f_max", "rate", "p_up",
                 "deadline"):
        np.testing.assert_array_equal(getattr(jf, name), getattr(tf, name))
    jg = J.profile_from_arch(J_ARCHS["glm4-9b"], seq=32)
    tg = T.profile_from_arch(T_ARCHS["glm4-9b"], seq=32)
    for name in ("A", "O", "g", "q"):
        np.testing.assert_array_equal(getattr(jg, name), getattr(tg, name))
    np.testing.assert_array_equal(J.make_f_sweep(J_EDGE),
                                  T.make_f_sweep(T_EDGE))


@pytest.mark.parametrize("M,beta,seed,t_free", [
    (1, 2.13, 0, 0.0), (4, 2.13, 1, 0.0), (10, 2.13, 2, 1e-3),
    (20, 2.13, 3, 0.0), (4, 30.25, 1, 0.0), (10, 30.25, 2, 0.0),
    (8, (0.0, 10.0), 4, 2e-3), (12, (2.0, 8.0), 5, 0.0),
])
def test_jdob_schedule_bitwise(M, beta, seed, t_free):
    jf, tf = fleets(M, beta, seed)
    assert_same_schedule(J.jdob_schedule(J_PROF, jf, J_EDGE, t_free=t_free),
                         T.jdob_schedule(T_PROF, tf, T_EDGE, t_free=t_free,
                                         device=CPU))
    r = T.jdob_reference(T_PROF, tf, T_EDGE, t_free=t_free)
    assert_same_schedule(J.jdob_reference(J_PROF, jf, J_EDGE, t_free=t_free),
                         r)


@pytest.mark.parametrize("variant", ["budget", "energy", "plus", "binary",
                                     "no_edge_dvfs"])
def test_jdob_variants_bitwise(variant):
    jf, tf = fleets(7, (0.0, 10.0), seed=2)
    if variant in ("budget", "energy"):
        a = J.jdob_schedule(J_PROF, jf, J_EDGE, sort_key=variant)
        b = T.jdob_schedule(T_PROF, tf, T_EDGE, sort_key=variant, device=CPU)
    else:
        a = getattr(J, f"jdob_{variant}")(J_PROF, jf, J_EDGE)
        b = getattr(T, f"jdob_{variant}")(T_PROF, tf, T_EDGE, device=CPU)
    assert_same_schedule(a, b)


def test_batched_plan_bitwise_and_padding_invariant():
    """G padded groups through one pass == the reference's batched plan ==
    the port's solo solves, at any padded width."""
    sizes, t_frees = [1, 3, 5, 8], [0.0, 1e-3, 0.0, 2e-3]
    pairs = [fleets(m, (0.0, 10.0), seed=m) for m in sizes]
    want = J.BatchedPlanner(J_PROF, J_EDGE).plan([p[0] for p in pairs],
                                                 t_frees)
    planner = T.BatchedPlanner(T_PROF, T_EDGE, device=CPU)
    got = planner.plan([p[1] for p in pairs], t_frees)
    wide = planner.plan([p[1] for p in pairs], t_frees, m_pad=64, g_pad=16)
    for w, g, gw, (_, tf), tfree in zip(want, got, wide, pairs, t_frees):
        assert_same_schedule(w, g)
        assert_same_schedule(g, gw)
        assert_same_schedule(g, T.jdob_schedule(T_PROF, tf, T_EDGE,
                                                t_free=tfree, device=CPU))
    assert planner.stats.misses == 2 and planner.stats.dispatches == 2
    assert planner.stats.groups_planned == 8


@pytest.mark.parametrize("M,beta,seed", [(4, 2.13, 0), (8, (0.0, 10.0), 3),
                                         (12, 30.25, 1), (20, (2.0, 8.0), 5)])
def test_energy_grid_matches_reference(M, beta, seed):
    jf, tf = fleets(M, beta, seed)
    want = J.jdob_energy_grid(J_PROF, jf, J_EDGE)
    got = T.jdob_energy_grid(T_PROF, tf, T_EDGE, device=CPU)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=5e-7,
                               atol=0.0)
    assert np.argmin(got) == np.argmin(want)


@pytest.mark.parametrize("M,beta,seed", [(4, (0.0, 10.0), 0),
                                         (6, (0.0, 10.0), 2),
                                         (8, (0.0, 10.0), 4), (12, 2.13, 7),
                                         (12, (0.0, 10.0), 7)])
def test_optimal_grouping_bitwise(M, beta, seed):
    jf, tf = fleets(M, beta, seed)
    want = J.optimal_grouping(J_PROF, jf, J_EDGE)
    assert_same_grouping(want, T.optimal_grouping(T_PROF, tf, T_EDGE,
                                                  device=CPU))
    assert_same_grouping(want, T.optimal_grouping_reference(
        T_PROF, tf, T_EDGE, device=CPU))


def test_plan_fleet_glm4_bitwise_with_timeline():
    """The slice's own plan: full glm4-9b profile at seq 32, 6 users, via
    the planner service, with the winning chain committed to a timeline."""
    jp = J.profile_from_arch(J_ARCHS["glm4-9b"], seq=32)
    je = J.make_edge_profile(jp)
    tp = T.profile_from_arch(T_ARCHS["glm4-9b"], seq=32)
    te = T.make_edge_profile(tp)
    jf = J.make_fleet(6, jp, je, beta=(2.0, 8.0), seed=0)
    tf = T.make_fleet(6, tp, te, beta=(2.0, 8.0), seed=0)
    want = J.PlannerService(jp, je).plan_fleet(jf)
    tl = GpuTimeline()
    got = T.PlannerService(tp, te, device=CPU).plan_fleet(tf, timeline=tl)
    assert_same_grouping(want, got)
    jtl = J.GpuTimeline()
    J.PlannerService(jp, je).plan_fleet(jf, timeline=jtl)
    assert [(r.start, r.end, r.gpu_start, r.f_edge)
            for r in jtl.reservations] == \
        [(r.start, r.end, r.gpu_start, r.f_edge) for r in tl.reservations]


@pytest.mark.parametrize("M,beta,seed", [(4, (0.0, 10.0), 0)])
def test_optimal_grouping_sweep_inner_bitwise(M, beta, seed):
    """The sweep-kernel inner folds through the sequential DP in both
    packages and lands on the same plan as the core inner."""
    jf, tf = fleets(M, beta, seed)
    want = J.optimal_grouping(J_PROF, jf, J_EDGE,
                              inner=JK.jdob_sweep_schedule)
    got = T.optimal_grouping(T_PROF, tf, T_EDGE, inner=jdob_sweep_schedule,
                             device=CPU)
    assert_same_grouping(want, got)
    core = T.optimal_grouping(T_PROF, tf, T_EDGE, device=CPU)
    assert got.energy == core.energy


@pytest.mark.parametrize("mode", [dict(dp="pareto"),
                                  dict(dp_backend="fused")])
def test_unported_grouping_modes_raise(mode):
    _, tf = fleets(4, 2.13)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.optimal_grouping(T_PROF, tf, T_EDGE, device=CPU, **mode)
