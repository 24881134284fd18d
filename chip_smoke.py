#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which passes its check or ends the script with a non-zero
exit code:

  1. card     — name and power limit (nvidia-smi), torch and CUDA versions;
                TF32 is switched off for matmuls and cuDNN.
  2. build    — both CUDA kernels built from ``src/repro_torch/kernels/csrc``
                (one nvcc per source, started together).
  3. kernels  — each kernel against its plain PyTorch version on the card:
                flash attention over the reference test shapes, two ragged
                shapes and the serving shapes (f32 at 2e-5, bf16 at 3e-2);
                the J-DOB sweep on the mobilenet cases and the glm4-9b
                M=6 grid (bitwise against the plain version; against the
                planner core's grid: same inf pattern, rtol 1e-4, argmin).
  4. planner  — the planner on CUDA against the planner on the CPU for the
                glm4-9b fleet: equal groups/partitions/offload sets/f_e,
                bitwise energies.
  5. serve    — full-width glm4-9b (40 layers, d_model 4096, float32,
                random weights drawn on the card) serves 6 requests through
                the entry points of ``repro_torch.launch.serve``; the flash
                launch count must equal what the plan implies, and the
                co-inference logits must match the monolithic forward to
                < 1e-3.  Then a warm repeat, the plan alone, and one warm
                wave under torch.profiler (the device's busy and idle
                share, the kernels that took the time).  The reduced CLI
                default runs as well.
  6. sweep    — the same wave with the sweep-kernel inner: equal energy,
                groups and logits, and the sweep kernel launched.
  7. times    — per call at the serving shapes, under a CUDA graph and
                eager: each kernel, its plain version, the library call
                where one exists (scaled_dot_product_attention, timed only),
                and the bound from bytes and FLOPs.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEQ, USERS, SEED = 32, 6, 0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


# ---------------------------------------------------------------- 1. card
def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s); TF32 off for matmul and cuDNN")
    return smi


# --------------------------------------------------------------- 2. build
def build() -> None:
    from repro_torch.kernels import build as kb
    t0 = time.perf_counter()
    report = kb.build()
    print(f"built {len(report)} sources in {time.perf_counter() - t0:.1f}s")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ------------------------------------------------------ 3. kernels vs plain
FLASH_SHAPES = [  # (b, sq, sk, h, kv, hd, causal, window)
    (1, 64, 64, 4, 4, 32, True, None),       # the reference test sweep
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 64, 64, 8, 1, 16, True, None),
    (1, 128, 128, 2, 2, 128, True, 32),
    (1, 32, 32, 2, 2, 8, True, None),
    (1, 37, 37, 4, 2, 64, True, None),       # ragged Sq = Sk
    (2, 21, 53, 4, 1, 128, False, None),     # ragged, Sk != Sq, no mask
]
MAIN_FLASH = [(b, SEQ, SEQ, 32, 2, 128, True, None) for b in (2, 4, 6)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _flash_inputs(shape, dtype, seed=0):
    b, sq, sk, h, kv, hd = shape[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n, s: torch.randn(n, s, hd, generator=g, device="cuda"
                                  ).to(dtype)
    return mk(b * h, sq), mk(b * kv, sk), mk(b * kv, sk), h // kv


def check_flash() -> float:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SHAPES + MAIN_FLASH:
            causal, window = shape[6], shape[7]
            q, k, v, rep = _flash_inputs(shape, dtype)
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  n_rep=rep).float()
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, n_rep=rep).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = TOL[dtype]
            ok = bool(((got - want).abs()
                       <= tol + tol * want.abs()).all())
            print(f"flash {str(dtype)[6:]:8s} b={shape[0]} sq={shape[1]} "
                  f"sk={shape[2]} h={shape[3]} kv={shape[4]} hd={shape[5]} "
                  f"causal={causal} window={window}: max|Δ|={err:.3e} "
                  f"(tol {tol})")
            check(ok, f"flash kernel vs plain at {shape} {dtype}")
            if shape in MAIN_FLASH and dtype == torch.float32:
                main_err = max(main_err, err)
    return main_err


def _sweep_cases():
    from repro_torch.configs import ARCHS
    from repro_torch.core import (make_edge_profile, make_fleet,
                                  mobilenet_v2_profile, profile_from_arch)
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    for M, beta, seed, t_free in [(4, 2.13, 0, 0.0), (8, (0.0, 10.0), 3, 1e-3),
                                  (12, 30.25, 1, 0.0), (1, 5.0, 2, 0.0)]:
        yield (f"mobilenet M={M}", prof, make_fleet(M, prof, edge, beta=beta,
                                                    seed=seed), edge, t_free)
    gp = profile_from_arch(ARCHS["glm4-9b"], seq=SEQ)
    ge = make_edge_profile(gp)
    yield (f"glm4-9b M={USERS}", gp,
           make_fleet(USERS, gp, ge, beta=(2.0, 8.0), seed=SEED), ge, 0.0)


def check_sweep() -> tuple[float, tuple]:
    from repro_torch.kernels.jdob_sweep import (jdob_sweep_kernel,
                                                jdob_sweep_plain)
    from repro_torch.kernels.ops import sweep_inputs
    from repro_torch.kernels.ref import jdob_sweep_ref
    worst, main_args = 0.0, None
    for name, prof, fleet, edge, t_free in _sweep_cases():
        args = [torch.from_numpy(a).cuda()
                for a in sweep_inputs(prof, fleet, edge, t_free)]
        got = jdob_sweep_kernel(*args)
        want = jdob_sweep_plain(*args)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(got, want))
        fin = torch.isfinite(want)
        err = (float((got[fin] - want[fin]).abs().max()) if fin.any()
               else 0.0)
        check(bool((torch.isfinite(got) == fin).all()),
              f"sweep inf pattern vs plain ({name})")
        check(bitwise or bool(torch.allclose(got[fin], want[fin],
                                             rtol=1e-4, atol=0.0)),
              f"sweep kernel vs plain ({name})")
        # and against the planner core's own grid (row N is local computing)
        grid = got.cpu().numpy()
        grid[prof.N] = np.inf
        core = jdob_sweep_ref(prof, fleet, edge, t_free=t_free,
                              device="cuda")
        cf = np.isfinite(core)
        check((np.isfinite(grid) == cf).all(), f"sweep vs core inf ({name})")
        if cf.any():
            check(np.allclose(grid[cf], core[cf], rtol=1e-4, atol=0.0),
                  f"sweep vs core grid ({name})")
            check(np.argmin(grid) == np.argmin(core),
                  f"sweep vs core argmin ({name})")
        print(f"sweep {name}: grid {tuple(got.shape)}, {int(fin.sum())} "
              f"feasible cells, max|Δ| vs plain={err:.3e}, "
              f"bitwise={bitwise}; core grid agrees")
        worst = max(worst, err)
        if name.startswith("glm4"):
            main_args = args
    return worst, main_args


# ------------------------------------------------------------- 4. planner
def check_planner() -> None:
    from repro_torch.configs import ARCHS
    from repro_torch.core import (PlannerService, make_edge_profile,
                                  make_fleet, profile_from_arch)
    prof = profile_from_arch(ARCHS["glm4-9b"], seq=SEQ)
    edge = make_edge_profile(prof)
    fleet = make_fleet(USERS, prof, edge, beta=(2.0, 8.0), seed=SEED)
    a = PlannerService(prof, edge, device="cuda").plan_fleet(fleet)
    b = PlannerService(prof, edge, device="cpu").plan_fleet(fleet)
    check([g.tolist() for g in a.groups] == [g.tolist() for g in b.groups],
          "planner groups cuda vs cpu")
    for sa, sb in zip(a.schedules, b.schedules):
        check(sa.partition == sb.partition and sa.f_edge == sb.f_edge
              and sa.energy == sb.energy and sa.t_free_end == sb.t_free_end
              and (sa.offload == sb.offload).all()
              and (sa.per_user_energy == sb.per_user_energy).all()
              and (sa.f_device == sb.f_device).all(),
              "planner schedules cuda vs cpu")
    check(a.energy == b.energy, "planner energy cuda vs cpu")
    print(f"groups {[g.tolist() for g in a.groups]}, partitions "
          f"{[s.partition for s in a.schedules]}, batches "
          f"{[s.batch_size for s in a.schedules]}, f_e "
          f"{[s.f_edge for s in a.schedules]}")
    print(f"energy cuda {a.energy!r} cpu {b.energy!r}: bitwise equal, "
          f"per-user energies and DVFS bitwise equal")


# --------------------------------------------------------------- 5. serve
def _reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.jdob_sweep import jdob_sweep_kernel
    flash_attention.launches = 0
    jdob_sweep_kernel.launches = 0


def _counts() -> tuple[int, int]:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.jdob_sweep import jdob_sweep_kernel
    return flash_attention.launches, jdob_sweep_kernel.launches


def serve_full_width():
    from repro_torch.configs import ARCHS
    from repro_torch.core import local_computing
    from repro_torch.launch.serve import (build_offline, check_monolithic,
                                          main, print_report)
    cfg = ARCHS["glm4-9b"]
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (40, 4096, 32, 2, 128, 13696, 151552), "glm4-9b at full width")
    t0 = time.perf_counter()
    server, fleet, profile, edge, reqs = build_offline(
        cfg, USERS, SEQ, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = (sum(p.numel() for lay in server.executor.params["layers"]
                    for p in lay.values())
                + server.executor.params["embed"]["w"].numel()
                + server.executor.params["lm_head"]["w"].numel()
                + cfg.d_model)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B float32 parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    _reset_counts()
    t0 = time.perf_counter()
    report = server.serve(reqs)                     # the main path
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    flash_n, sweep_n = _counts()
    expected = sum(cfg.num_layers * (int(s.offload.any())
                                     + int(not s.offload.all()))
                   for s in report.schedules)
    print_report(server, report, local_computing(profile, fleet, edge),
                 reqs, profile, serve_s)
    print(f"flash launches {flash_n} (expected {expected}), sweep launches "
          f"{sweep_n}")
    check(flash_n == expected, "flash launch count on the main path")
    check(check_monolithic(report, server, reqs) < 1e-3,
          "co-inference vs monolithic")
    # warm repeats: the whole wave, and the plan alone
    t0 = time.perf_counter()
    again = server.serve(reqs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.service.plan_fleet(fleet)
    plan_s = time.perf_counter() - t0
    rerun_err = float(np.abs(again.logits - report.logits).max())
    check(again.energy == report.energy and rerun_err < 1e-3,
          "a repeated wave gives the same plan and logits")
    print(f"wave: first {serve_s:.3f}s, warm {warm_s:.3f}s (logits max |Δ| "
          f"vs first {rerun_err:.2e}) of which plan "
          f"{plan_s:.3f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; max |logit| "
          f"{float(np.abs(report.logits).max()):.3f}")
    profile_wave(server, reqs)
    print("reduced CLI default (python -m repro_torch.launch.serve):")
    main([])
    return cfg, server, fleet, profile, edge, reqs, report, flash_n


def profile_wave(server, reqs) -> None:
    """One more warm wave under torch.profiler: the device's busy and idle
    share of the wave's wall time and the kernels that took the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device events; device "
              "busy time not measured")
        return
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name: dict[str, list] = {}
    for k in kernels:
        entry = by_name.setdefault(k.name, [0.0, 0])
        entry[0] += k.time_range.elapsed_us()
        entry[1] += 1
    print(f"profile of a warm wave: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%; {len(kernels)} device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:100]}")


def serve_sweep_inner(cfg, server, fleet, profile, edge, reqs, core_report):
    from repro_torch.kernels import jdob_sweep_schedule
    from repro_torch.serving import CoInferenceServer
    sweep_server = CoInferenceServer(cfg, server.executor.params, profile,
                                     fleet, edge, inner=jdob_sweep_schedule,
                                     device="cuda")
    _reset_counts()
    t0 = time.perf_counter()
    report = sweep_server.serve(reqs)               # the main path, sweep
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    flash_n, sweep_n = _counts()
    groups = [g.tolist() for g in report.groups]
    print(f"sweep inner: energy {report.energy!r} vs core "
          f"{core_report.energy!r}, groups {groups}; sweep launches "
          f"{sweep_n}, flash launches {flash_n}; wave {wave_s:.3f}s")
    check(report.energy == core_report.energy, "sweep-inner energy")
    check(groups == [g.tolist() for g in core_report.groups],
          "sweep-inner groups")
    check(sweep_n > 0, "sweep kernel launched on the sweep-inner path")
    err = float(np.abs(report.logits - core_report.logits).max())
    print(f"sweep-inner logits vs core-inner logits max |Δ| = {err:.3e}")
    check(err == 0.0, "sweep-inner logits equal core-inner logits")
    return sweep_n


# --------------------------------------------------------------- 7. times
def time_eager(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def time_graph(fn, per_graph: int = 20, replays: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(replays):
        graph.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / (replays * per_graph)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def times(b: int, sweep_args) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.jdob_sweep import (jdob_sweep_kernel,
                                                jdob_sweep_plain)
    shape = (b, SEQ, SEQ, 32, 2, 128, True, None)
    q, k, v, rep = _flash_inputs(shape, torch.float32, seed=1)
    h, kv, hd = 32, 2, 128
    q4 = q.view(b, h, SEQ, hd)
    k4, v4 = k.view(b, kv, SEQ, hd), v.view(b, kv, SEQ, hd)
    fns = {
        "kernel": lambda: flash_attention(q, k, v, causal=True, n_rep=rep),
        "plain": lambda: flash_attention_plain(q, k, v, causal=True,
                                               n_rep=rep),
        "library": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True),
    }
    lib_err = float((fns["library"]().reshape(q.shape) - fns["kernel"]()
                     ).abs().max())
    flash = {n: (time_graph(f), time_eager(f)) for n, f in fns.items()}
    elems = q.numel() * 2 + k.numel() + v.numel()
    pairs = SEQ * (SEQ + 1) // 2                    # causal (q, k) pairs
    flash_bound = bound_ms(4 * elems, 4.0 * hd * pairs * b * h)
    print(f"flash b={b} h={h} kv={kv} s={SEQ} hd={hd} f32, ms per call "
          f"graph / eager: kernel {flash['kernel'][0]:.5f} / "
          f"{flash['kernel'][1]:.5f}, plain {flash['plain'][0]:.5f} / "
          f"{flash['plain'][1]:.5f}, sdpa {flash['library'][0]:.5f} / "
          f"{flash['library'][1]:.5f} (sdpa |Δ| vs kernel {lib_err:.2e}); "
          f"bound {flash_bound[0]:.6f} ms by {flash_bound[1]}")
    NP, M = sweep_args[0].shape
    K = sweep_args[-1].shape[1]
    sw = {"kernel": lambda: jdob_sweep_kernel(*sweep_args),
          "plain": lambda: jdob_sweep_plain(*sweep_args)}
    sweep = {n: (time_graph(f), time_eager(f)) for n, f in sw.items()}
    n_bytes = 4 * (9 * NP * M + NP * 8 + NP * K + NP * K)
    # per cell: 19 float ops per user (membership, l_o, slack, Eq. 19-21,
    # row sum) + 13 per cell (phi, psi, Eq. 6, phi/f, psi·f², select)
    sweep_bound = bound_ms(n_bytes, NP * K * (19 * M + 13))
    print(f"sweep NP={NP} K={K} M={M}, ms per call graph / eager: kernel "
          f"{sweep['kernel'][0]:.5f} / {sweep['kernel'][1]:.5f}, plain "
          f"{sweep['plain'][0]:.5f} / {sweep['plain'][1]:.5f}; bound "
          f"{sweep_bound[0]:.7f} ms by {sweep_bound[1]}")
    return dict(flash=(flash, flash_bound), sweep=(sweep, sweep_bound))


def main() -> None:
    phase("card")
    smi = card()
    phase("build")
    build()
    phase("kernels vs plain")
    flash_err = check_flash()
    sweep_err, sweep_args = check_sweep()
    phase("planner: cuda vs cpu")
    check_planner()
    phase("serve: full-width glm4-9b, core inner")
    cfg, server, fleet, profile, edge, reqs, report, flash_n = \
        serve_full_width()
    phase("serve: sweep-kernel inner")
    sweep_n = serve_sweep_inner(cfg, server, fleet, profile, edge, reqs,
                                report)
    phase("times")
    # the largest batch the main path handed the flash kernel: an offloaded
    # batch or a group's local users
    b = max(max(s.batch_size, len(s.offload) - s.batch_size)
            for s in report.schedules)
    t = times(b, sweep_args)
    flash, flash_bound = t["flash"]
    sweep, sweep_bound = t["sweep"]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=flash_n, max_abs_err=flash_err,
             ms=flash["kernel"][0], plain_ms=flash["plain"][0],
             bound_ms=flash_bound[0], bound_by=flash_bound[1],
             library_ms=flash["library"][0]),
        dict(name="jdob_sweep", route="cuda",
             source="src/repro_torch/kernels/csrc/jdob_sweep.cu",
             replaces="src/repro/kernels/jdob_sweep.py:64",
             launches=sweep_n, max_abs_err=sweep_err,
             ms=sweep["kernel"][0], plain_ms=sweep["plain"][0],
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1],
             library_ms=None),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
