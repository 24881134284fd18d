"""Co-inference serving entry point: the paper's system end to end, offline
wave (the port of ``repro.launch.serve``'s default path).

Builds a model (reduced by default), an M-user fleet with deadlines, runs
the J-DOB scheduler, executes the partitioned/batched plan on the model
and checks the outputs against the monolithic forward:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --users 6

Runs on CUDA; ``--device cpu`` runs the plain PyTorch path on the host.
``--online``, ``--tenants``, ``--planner pareto``, ``--dp-backend fused``,
``--cohort-size``, ``--beam-width``, ``--trace`` and ``--metrics-json``
name paths that are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import (PlannerService, local_computing,
                              make_edge_profile, make_fleet,
                              profile_from_arch)
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import CoInferenceServer, Request

#: options whose paths are not ported yet → the ROADMAP item bringing them
NOT_PORTED = {
    "online": "--online (event-driven serving): ROADMAP queue 1, item 6",
    "tenants": "--tenants (multi-tenant serving): ROADMAP queue 1, item 8",
    "planner": "--planner pareto (Pareto DP): ROADMAP queue 1, item 7",
    "dp_backend": "--dp-backend fused (fused DP): ROADMAP queue 1, item 10",
    "cohort_size": "--cohort-size (cohort planning): ROADMAP queue 1, item 7",
    "beam_width": "--beam-width (Pareto beam): ROADMAP queue 1, item 7",
    "trace": "--trace (telemetry): ROADMAP queue 1, item 9",
    "metrics_json": "--metrics-json (telemetry): ROADMAP queue 1, item 9",
}
_DEFAULTS = dict(online=False, tenants=1, planner="prefix",
                 dp_backend="dispatch", cohort_size=None, beam_width=None,
                 trace=None, metrics_json=None)


def build_offline(cfg, users: int, seq: int, seed: int,
                  beta=(2.0, 8.0), device=None):
    """Everything one offline wave needs: weights drawn on ``device`` from
    ``seed``, the task profile and edge model of ``cfg`` at ``seq`` tokens,
    a ``users``-device fleet, the server, and one request per user.
    Returns ``(server, fleet, profile, edge, requests)``."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    profile = profile_from_arch(cfg, seq=seq)
    edge = make_edge_profile(profile)
    fleet = make_fleet(users, profile, edge, beta=tuple(beta), seed=seed)
    server = CoInferenceServer(cfg, params, profile, fleet, edge,
                               service=PlannerService(profile, edge,
                                                      device=dev),
                               device=dev)
    rng = np.random.default_rng(seed)
    reqs = [Request(user=m,
                    tokens=rng.integers(0, cfg.vocab_size, seq,
                                        dtype=np.int32),
                    deadline=float(fleet.deadline[m]))
            for m in range(users)]
    return server, fleet, profile, edge, reqs


def verify(report_logits, executor, reqs) -> float:
    """max |Δlogit| of the co-inference logits against the monolithic
    forward of the same requests."""
    want = executor.full_forward(
        executor.tokens(np.stack([r.tokens for r in reqs])))
    return float(np.abs(report_logits - want.cpu().numpy()).max())


def _plan_latency_line(service) -> None:
    stats = service.stats()
    lat = stats.plan_latency()
    if lat["count"]:
        print(f"plan latency: {lat['count']} call(s), "
              f"min {lat['min_ms']:.2f} ms / p50 {lat['p50_ms']:.2f} ms / "
              f"p99 {lat['p99_ms']:.2f} ms / max {lat['max_ms']:.2f} ms "
              f"(steady-state)")
        comp = lat["compile"]
        if comp["count"]:
            print(f"  first call per shape: {comp['count']} sample(s), "
                  f"p50 {comp['p50_ms']:.1f} ms / max {comp['max_ms']:.1f} "
                  f"ms (separate bucket)")
    if stats.og_plans:
        print(f"grouping DP: {stats.og_plans} plan(s), "
              f"{stats.dispatches_per_plan:.1f} core pass(es)/plan")


def print_report(server, report, lc, reqs, profile, serve_s) -> None:
    print(f"arch={server.cfg.name}  M={len(reqs)}  N={profile.N} blocks  "
          f"planner=prefix  dp_backend=dispatch  device={server.device}  "
          f"(planned+served in {serve_s:.2f}s via planner service)")
    for g, s in zip(report.groups, report.schedules):
        print(f"  group {[int(i) for i in g]}: partition ñ={s.partition}, "
              f"batch={s.batch_size}, f_e={s.f_edge / 1e9:.2f} GHz, "
              f"energy={s.energy:.4f} J")
    print(f"total energy: {report.energy:.4f} J "
          f"(LC: {lc.energy:.4f} J, saving "
          f"{100 * (1 - report.energy / lc.energy):.1f}%)")


def check_monolithic(report, server, reqs) -> float:
    """The serve path's own correctness check: co-inference logits equal
    the monolithic forward to < 1e-3 (raises otherwise)."""
    err = verify(report.logits, server.executor, reqs)
    print(f"co-inference vs monolithic max |Δlogit| = {err:.2e}")
    if not err < 1e-3:
        raise RuntimeError(f"co-inference logits disagree with the "
                           f"monolithic forward: {err:.3e} ≥ 1e-3")
    return err


def serve_offline(server, fleet, profile, edge, reqs) -> dict:
    """Plan and serve one wave, print the plan next to LC, and check the
    co-inference logits against the monolithic forward."""
    t0 = time.perf_counter()
    report = server.serve(reqs)
    serve_s = time.perf_counter() - t0
    lc = local_computing(profile, fleet, edge)
    print_report(server, report, lc, reqs, profile, serve_s)
    err = check_monolithic(report, server, reqs)
    _plan_latency_line(server.service)
    return dict(energy=report.energy, lc=lc.energy, err=err, report=report)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ARCHS))
    ap.add_argument("--users", type=int, default=6)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--beta", type=float, nargs=2, default=[2.0, 8.0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--online", action="store_true")
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--cohort-size", type=int, default=None)
    ap.add_argument("--planner", default="prefix",
                    choices=["prefix", "pareto"])
    ap.add_argument("--dp-backend", default="dispatch",
                    choices=["dispatch", "fused"])
    ap.add_argument("--beam-width", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--metrics-json", default=None, metavar="PATH")
    # options of the online and multi-tenant paths, accepted with the
    # reference's defaults; the offline wave does not read them
    ap.add_argument("--arrival-seed", type=int, default=None)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--policy", default="slack",
                    choices=["immediate", "window", "slack", "lastcall"])
    ap.add_argument("--window", type=float, default=0.02)
    ap.add_argument("--plan-workers", type=int, default=0)
    ap.add_argument("--plan-depth", type=int, default=1)
    ap.add_argument("--batch-events", action="store_true")
    ap.add_argument("--batch-window", type=float, default=0.0)
    ap.add_argument("--channel-stagger", action="store_true")
    ap.add_argument("--admission", default="admit",
                    choices=["admit", "degrade", "reject"])
    ap.add_argument("--no-preemption", action="store_true")
    ap.add_argument("--occupancy", default="serialized",
                    choices=["serialized", "interleaved"])
    ap.add_argument("--channel", default="static",
                    choices=["static", "shared", "trace"])
    ap.add_argument("--channel-share", default="equal",
                    choices=["equal", "weighted"])
    ap.add_argument("--channel-nominal", action="store_true")
    args = ap.parse_args(argv)
    for name, default in _DEFAULTS.items():
        if getattr(args, name) != default:
            raise NotImplementedError(f"not ported yet: {NOT_PORTED[name]}")
    if args.occupancy != "serialized":
        print("NOTE: --occupancy interleaved applies to --online/--tenants "
              "serving; offline OG serving is serialized-only")
    if args.channel != "static":
        print("NOTE: --channel applies to --online/--tenants serving; "
              "offline OG serving prices the static solo rates")

    cfg = ARCHS[args.arch].reduced()
    server, fleet, profile, edge, reqs = build_offline(
        cfg, args.users, args.seq, args.seed, beta=args.beta,
        device=args.device)
    return serve_offline(server, fleet, profile, edge, reqs)


if __name__ == "__main__":
    main()
