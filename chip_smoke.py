#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which passes its check or ends the script with a non-zero
exit code:

  1. card     — name and power limit (nvidia-smi), torch and CUDA versions;
                TF32 is switched off for matmuls and cuDNN.
  2. build    — the four CUDA kernels built from
                ``src/repro_torch/kernels/csrc`` (one nvcc per source,
                started together).
  3. kernels  — each kernel against its plain PyTorch version on the card:
                flash attention over the reference test shapes, two ragged
                shapes and the serving shapes (f32 at 2e-5, bf16 at 3e-2);
                the J-DOB sweep on the mobilenet cases and the glm4-9b
                M=6 grid (bitwise against the plain version; against the
                planner core's grid: same inf pattern, rtol 1e-4, argmin);
                the GLA scan over the reference test shapes, a ragged L, a
                starting state, zamba2-7b's serving shape, three 16-step
                chunks, 32-step chunks and a 2048-step scan (y at 2e-5 f32,
                8e-5 for chunks ≥ 64, 3e-2 bf16; state at 1e-4 / 1e-2);
                decode attention over the reference test shapes, glm4-9b's
                and zamba2-7b's decode shapes, a 4096-slot cache full and
                with most of the cluster past pos, a wrapped ring, pos -1
                and a 32768-slot cache whose scores spill to scratch, for
                f32, bf16 and f32 queries over a bf16 cache.
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
  7. decode   — glm4-9b (the same weights) prefills 32 tokens per user
                into a 40-slot cache and decodes 8 more in float32, once on
                a float32 cache and once on the reference's default
                bfloat16 cache: prefill's last logits and every step's
                against the full forward of the 40 tokens (< 5e-3 on the
                float32 cache; on the bfloat16 cache the gap is printed,
                since rounding K/V to bfloat16 alone moves full-width
                logits by more), decode launches = 40 attention layers x 8
                steps on each, warm ms per step and one step under the
                profiler.  Then glm4-9b's weights are freed.
  8. zamba2   — full-width zamba2-7b (81 layers: 68 Mamba2 + 13
                attention, float32, drawn on the card) serves the same 6
                requests: the plan, gla launches = 68 and flash launches =
                13 per (group with offloaded users + group with local
                users), co-inference vs monolithic < 1e-3, a warm wave
                under the profiler, peak memory; the reduced CLI with
                ``--arch zamba2-7b``; then its decode as in phase 7
                (decode launches = 13 x 8).
  9. times    — per call at the serving shapes, under a CUDA graph and
                eager: each kernel, its plain version, the library call
                where one exists (scaled_dot_product_attention, timed only),
                and the bound from bytes and FLOPs; decode attention also
                over a 4096-slot cache of glm4-9b's heads (timed only).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
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


def _close(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    diff = (got.float() - want.float()).abs()
    return (bool((diff <= atol + rtol * want.float().abs()).all()),
            float(diff.max()))


GLA_SHAPES = [  # (b, L, h, dk, dv, chunk, with_state)
    (2, 32, 2, 16, 16, 8, False),            # the reference test sweep
    (1, 64, 4, 8, 24, 16, False),
    (2, 128, 1, 64, 64, 128, False),
    (1, 48, 2, 32, 32, 16, False),
    (2, 37, 3, 64, 64, 16, False),           # ragged L
    (2, 48, 4, 64, 64, 16, True),            # from a non-zero state
    (USERS, 48, 112, 64, 64, 16, False),     # three chunks of the wave's 16
    (2, 70, 3, 64, 64, 32, True),            # 32-step chunks, ragged
    (1, 2048, 8, 64, 64, 256, True),         # a long scan
]
ZAMBA_GLA = (USERS, SEQ, 112, 64, 64, 16, False)   # zamba2-7b's wave, b=6


def _gla_inputs(shape, dtype, seed=0):
    """The Mamba2 mixer's layout: q, k contiguous (B, L, H, N), v a
    strided view of the conv output (B, L, ch) with ch > H·P."""
    b, L, h, dk, dv, _, with_state = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q = rnd(b, L, h, dk).to(dtype)
    k = (rnd(b, L, h, dk) * 0.3).to(dtype)
    v = rnd(b, L, h * dv + 256).to(dtype)[..., :h * dv].view(b, L, h, dv)
    ld = -torch.nn.functional.softplus(rnd(b, L, h))
    s0 = rnd(b, h, dk, dv) * 0.5 if with_state else None
    return q, k, v, ld, s0


def check_gla() -> float:
    from repro_torch.kernels.gla_scan import gla_scan, gla_scan_plain
    main_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GLA_SHAPES + [ZAMBA_GLA]:
            chunk = shape[5]
            q, k, v, ld, s0 = _gla_inputs(shape, dtype)
            y, s = gla_scan(q, k, v, ld, chunk=chunk, state_in=s0)
            y0, s1 = gla_scan_plain(q, k, v, ld, chunk=chunk, state_in=s0)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            atol = 8e-5 if dtype == torch.float32 and chunk >= 64 else tol
            ok_y, err_y = _close(y, y0, atol, tol)
            ok_s, err_s = _close(s, s1, 1e-2 if dtype == torch.bfloat16
                                 else 1e-4, 1e-2)
            print(f"gla {str(dtype)[6:]:8s} b={shape[0]} L={shape[1]} "
                  f"h={shape[2]} dk={shape[3]} dv={shape[4]} chunk={chunk} "
                  f"state_in={shape[6]}: y max|Δ|={err_y:.3e} (tol {atol}),"
                  f" state max|Δ|={err_s:.3e}")
            check(ok_y and ok_s, f"gla kernel vs plain at {shape} {dtype}")
            if shape == ZAMBA_GLA and dtype == torch.float32:
                main_err = err_y
    return main_err


DECODE_SHAPES = [  # (b, L, h, kv, hd, pos)
    (2, 64, 4, 2, 32, 40),                   # the reference test sweep
    (1, 128, 8, 8, 64, 127),
    (2, 32, 4, 1, 16, 100),                  # ring, wrapped
    (1, 64, 2, 2, 128, 10),                  # ring, not yet full
    (2, 64, 4, 4, 16, 0),                    # first token
    (2, 64, 4, 2, 32, -1),                   # no valid slot
    (2, 512, 8, 2, 64, 1300),                # ring, wrapped, split
    (USERS, 4096, 32, 2, 128, 4095),         # a long cache, all valid
    (USERS, 4096, 32, 2, 128, 1000),         # most shares past pos
    (1, 32768, 16, 1, 128, 20000),           # scores spill to scratch
]
# a long cache of glm4-9b's heads, timed beside the 40-slot steps
LONG_DECODE = (USERS, 4096, 32, 2, 128, 4095)
# the decode phases' shapes: 6 users, a 40-slot cache at its last step
GLM_DECODE = (USERS, 40, 32, 2, 128, 39)
ZAMBA_DECODE = (USERS, 40, 32, 32, 112, 39)
DECODE_DTYPES = [(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16)]   # the model's default


def _decode_inputs(shape, q_dtype, c_dtype, seed=0):
    b, L, h, kv, hd, pos = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=g, device="cuda").to(q_dtype)
    k, v = (torch.randn(b, L, kv, hd, generator=g, device="cuda"
                        ).to(c_dtype) for _ in range(2))
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def check_decode() -> float:
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    main_err = 0.0
    for qd, cd in DECODE_DTYPES:
        for shape in DECODE_SHAPES + [GLM_DECODE, ZAMBA_DECODE]:
            q, k, v, pos = _decode_inputs(shape, qd, cd)
            got = decode_attention(q, k, v, pos)
            want = decode_attention_plain(q, k, v, pos)
            torch.cuda.synchronize()
            tol = TOL[torch.bfloat16 if torch.bfloat16 in (qd, cd)
                      else torch.float32]
            ok, err = _close(got, want, tol, tol)
            print(f"decode q {str(qd)[6:]:8s} cache {str(cd)[6:]:8s} "
                  f"b={shape[0]} L={shape[1]} h={shape[2]} kv={shape[3]} "
                  f"hd={shape[4]} pos={shape[5]}: max|Δ|={err:.3e} "
                  f"(tol {tol})")
            check(ok, f"decode kernel vs plain at {shape} {qd}/{cd}")
            if shape in (GLM_DECODE, ZAMBA_DECODE) and (qd, cd) == \
                    DECODE_DTYPES[2]:
                main_err = max(main_err, err)
    return main_err


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
def _wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gla_scan import gla_scan
    from repro_torch.kernels.jdob_sweep import jdob_sweep_kernel
    return dict(flash_attention=flash_attention, jdob_sweep=jdob_sweep_kernel,
                decode_attention=decode_attention, gla_scan=gla_scan)


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


#: the published widths each full-width run is held to (configs/*.py)
FULL_WIDTH = {
    "glm4-9b": dict(num_layers=40, d_model=4096, num_heads=32,
                    num_kv_heads=2, head_dim=128, d_ff=13696,
                    vocab_size=151552),
    "zamba2-7b": dict(num_layers=81, d_model=3584, num_heads=32,
                      num_kv_heads=32, head_dim=112, d_ff=14336,
                      vocab_size=32000, ssm_d_inner=7168, ssm_heads=112,
                      ssm_head_dim=64, ssm_state=64, ssm_n_groups=2),
}


def _kinds(cfg) -> tuple[int, int]:
    """(attention layers, Mamba2 layers)."""
    seq = cfg.layer_sequence()
    return (sum(s.kind in ("attn", "swa") for s in seq),
            sum(s.kind == "mamba2" for s in seq))


def serve_full_width(name: str, cli: list[str]):
    from repro_torch.configs import ARCHS
    from repro_torch.core import local_computing
    from repro_torch.launch.serve import (build_offline, check_monolithic,
                                          main, print_report)
    cfg = ARCHS[name]
    check(all(getattr(cfg, k) == v for k, v in FULL_WIDTH[name].items()),
          f"{name} at full width")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, fleet, profile, edge, reqs = build_offline(
        cfg, USERS, SEQ, SEED, device="cuda")
    torch.cuda.synchronize()
    params = server.executor.params
    n_params = (sum(p.numel() for lay in params["layers"]
                    for p in lay.values())
                + params["embed"]["w"].numel()
                + params["lm_head"]["w"].numel() + cfg.d_model)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f} B float32 parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    _reset_counts()
    t0 = time.perf_counter()
    report = server.serve(reqs)                     # the main path
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n = _counts()
    # each layer runs once per group for its offloaded users and once for
    # its local users
    passes = sum(int(s.offload.any()) + int(not s.offload.all())
                 for s in report.schedules)
    n_attn, n_mamba = _kinds(cfg)
    print_report(server, report, local_computing(profile, fleet, edge),
                 reqs, profile, serve_s)
    print(f"flash launches {n['flash_attention']} (expected "
          f"{n_attn * passes}), gla launches {n['gla_scan']} (expected "
          f"{n_mamba * passes}), sweep launches {n['jdob_sweep']}")
    check(n["flash_attention"] == n_attn * passes,
          "flash launch count on the main path")
    check(n["gla_scan"] == n_mamba * passes,
          "gla launch count on the main path")
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
    profile_run("a warm wave", lambda: server.serve(reqs))
    print(f"reduced CLI (python -m repro_torch.launch.serve {' '.join(cli)}):")
    main(cli)
    return cfg, server, fleet, profile, edge, reqs, report, n


def _prefill_decode(cfg, params, toks, ctx, cache_dtype, steps: int):
    """The decode path once: prefill 32 tokens per user into a 40-slot
    cache of ``cache_dtype``, then ``steps`` decode steps, each path's
    launch counts set to 0 just before it and read just after.  Returns
    the logits per step (prefill's last first) and the decode launches."""
    from repro_torch.models import decode_step, prefill
    n_attn, n_mamba = _kinds(cfg)
    _reset_counts()
    logits, cache = prefill(cfg, params, toks[:, :SEQ], cache_len=SEQ + steps,
                            cache_dtype=cache_dtype, ctx=ctx)
    torch.cuda.synchronize()
    n = _counts()
    check(n["flash_attention"] == n_attn and n["gla_scan"] == n_mamba,
          f"prefill launch counts {n}")
    check(all(c["k"].dtype == cache_dtype for c in cache["layers"]
              if "k" in c), f"prefill's K/V cache is {cache_dtype}")
    outs = [logits[:, -1]]
    _reset_counts()
    for t in range(steps):                          # the main path, decode
        lg, cache = decode_step(cfg, params, cache,
                                toks[:, SEQ + t:SEQ + t + 1], ctx=ctx)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    n = _counts()
    print(f"{str(cache_dtype)[6:]} cache: prefill flash {n_attn} gla "
          f"{n_mamba}; {steps} steps: decode launches "
          f"{n['decode_attention']} (expected {n_attn} x {steps}), flash "
          f"{n['flash_attention']}, gla {n['gla_scan']}; pos "
          f"{int(cache['pos'])}")
    check(n["decode_attention"] == n_attn * steps,
          "decode launch count on the decode path")
    check(n["flash_attention"] == 0 and n["gla_scan"] == 0,
          "a decode step launches no prefill kernel")
    check(int(cache["pos"]) == SEQ + steps, "the cache advanced to 40")
    return outs, n["decode_attention"]


def decode_full_width(cfg, params) -> dict:
    """Prefill + 8 decode steps in float32, held against the full forward
    of the 40 tokens: with a float32 cache to 5e-3 (the reference's
    decode-equivalence bound); with the reference's default bfloat16
    cache, the main path, the gap is measured and printed.  Then warm ms
    per step and one step under the profiler, on the bfloat16 cache."""
    from repro_torch.models import RunCtx, decode_step, forward, prefill
    steps = 8
    ctx = RunCtx(cfg, compute_dtype=torch.float32, ssm_chunk=16)
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (USERS, SEQ + steps))).cuda()
    full = forward(cfg, params, toks, ctx=ctx)
    want = [full[:, SEQ - 1 + t] for t in range(steps + 1)]
    result = {}
    for cache_dtype in (torch.float32, torch.bfloat16):
        outs, launches = _prefill_decode(cfg, params, toks, ctx, cache_dtype,
                                         steps)
        errs = [float((o - w).abs().max()) for o, w in zip(outs, want)]
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              "finite decode logits")
        print(f"{str(cache_dtype)[6:]} cache, logits max |Δ| vs the full "
              f"forward: prefill {errs[0]:.3e}, decode steps "
              f"{', '.join(f'{e:.3e}' for e in errs[1:])}; max |logit| "
              f"{float(full.abs().max()):.3f}")
        result[cache_dtype] = (max(errs), launches)
    check(result[torch.float32][0] < 5e-3,
          "prefill + decode on a float32 cache vs the full forward")
    # warm, on the reference's default cache: a fresh prefill, steps timed
    _, cache = prefill(cfg, params, toks[:, :SEQ], cache_len=SEQ + steps,
                       ctx=ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        _, cache = decode_step(cfg, params, cache,
                               toks[:, SEQ + t:SEQ + t + 1], ctx=ctx)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"warm decode step ({USERS} users, float32 weights, bfloat16 "
          f"cache): {step_ms:.3f} ms")
    profile_run("a warm decode step",
                lambda: decode_step(cfg, params, cache, toks[:, -1:],
                                    ctx=ctx))
    return dict(launches=result[torch.bfloat16][1],
                err_f32=result[torch.float32][0],
                gap_bf16=result[torch.bfloat16][0], step_ms=step_ms)


def profile_run(label: str, run) -> None:
    """``run()`` once more, warm, under torch.profiler: the device's busy
    and idle share of its wall time and the kernels that took the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    print(f"profile of {label}: wall {wall_us / 1e3:.2f} ms, device "
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
    n = _counts()
    flash_n, sweep_n = n["flash_attention"], n["jdob_sweep"]
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


# --------------------------------------------------------------- 9. times
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


def _time_all(fns: dict) -> dict:
    """{name: (ms per call under a CUDA graph, ms per call eager)}."""
    return {n: (time_graph(f), time_eager(f)) for n, f in fns.items()}


def _line(name: str, t: dict, bound) -> str:
    parts = ", ".join(f"{n} {g:.5f} / {e:.5f}" for n, (g, e) in t.items())
    return (f"{name}, ms per call graph / eager: {parts}; bound "
            f"{bound[0]:.7f} ms by {bound[1]}")


def gla_flops(L: int, chunk: int, dk: int, dv: int) -> float:
    """Float ops of one (batch, head) scan: per chunk of n steps the causal
    scores and their product with v (n(n+1)/2 pairs), the inter-chunk term
    and the state update (n·dk·dv each), two ops per multiply-add."""
    ops, c = 0.0, min(chunk, L)
    for c0 in range(0, L, c):
        n = min(c, L - c0)
        ops += 2.0 * (n * (n + 1) // 2) * (dk + dv) + 4.0 * n * dk * dv
    return ops


def times(b: int, sweep_args, b_z: int) -> dict:
    """``b``: the largest batch of glm4-9b's wave; ``b_z``: of zamba2-7b's
    wave (the gla kernel's serving batch)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.gla_scan import gla_scan, gla_scan_plain
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
    flash = _time_all(fns)
    elems = q.numel() * 2 + k.numel() + v.numel()
    pairs = SEQ * (SEQ + 1) // 2                    # causal (q, k) pairs
    flash_bound = bound_ms(4 * elems, 4.0 * hd * pairs * b * h)
    print(_line(f"flash b={b} h={h} kv={kv} s={SEQ} hd={hd} f32", flash,
                flash_bound) + f" (sdpa |Δ| vs kernel {lib_err:.2e})")
    NP, M = sweep_args[0].shape
    K = sweep_args[-1].shape[1]
    sweep = _time_all({"kernel": lambda: jdob_sweep_kernel(*sweep_args),
                       "plain": lambda: jdob_sweep_plain(*sweep_args)})
    n_bytes = 4 * (9 * NP * M + NP * 8 + NP * K + NP * K)
    # per cell: 19 float ops per user (membership, l_o, slack, Eq. 19-21,
    # row sum) + 13 per cell (phi, psi, Eq. 6, phi/f, psi·f², select)
    sweep_bound = bound_ms(n_bytes, NP * K * (19 * M + 13))
    print(_line(f"sweep NP={NP} K={K} M={M}", sweep, sweep_bound))

    # the scan at zamba2-7b's wave shape: 112 heads, 32 steps, N = P = 64
    gshape = (b_z,) + ZAMBA_GLA[1:]
    _, L, gh, dk, dv, chunk, _ = gshape
    gq, gk, gv, gld, _ = _gla_inputs(gshape, torch.float32, seed=1)
    gla = _time_all({
        "kernel": lambda: gla_scan(gq, gk, gv, gld, chunk=chunk),
        "plain": lambda: gla_scan_plain(gq, gk, gv, gld, chunk=chunk)})
    rows = b_z * L * gh
    gla_bound = bound_ms(4 * (rows * (2 * dk + 2 * dv + 1)
                              + b_z * gh * dk * dv),
                         b_z * gh * gla_flops(L, chunk, dk, dv))
    print(_line(f"gla b={b_z} L={L} h={gh} dk={dk} dv={dv} chunk={chunk} "
                "f32", gla, gla_bound) + " (no single PyTorch call "
          "computes it)")

    # decode at each model's last step, and over a long cache: f32 queries
    # over the bf16 cache
    dec = {}
    for label, dshape in (("glm4-9b", GLM_DECODE),
                          ("zamba2-7b", ZAMBA_DECODE),
                          ("glm4-9b heads, long cache", LONG_DECODE)):
        dq, dk_, dv_, pos = _decode_inputs(dshape, torch.float32,
                                           torch.bfloat16, seed=1)
        db, dL, dh, dkv, dhd, dpos = dshape
        n_valid = min(dpos + 1, dL)
        dq16 = dq.to(torch.bfloat16).view(db, dh, 1, dhd)
        kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (dk_, dv_))
        t = _time_all({
            "kernel": lambda: decode_attention(dq, dk_, dv_, pos),
            "plain": lambda: decode_attention_plain(dq, dk_, dv_, pos),
            "library": lambda: F.scaled_dot_product_attention(
                dq16, kt, vt, enable_gqa=True)})
        d_bound = bound_ms(4 * 2 * db * dh * dhd
                           + 2 * 2 * db * n_valid * dkv * dhd,
                           4.0 * db * dh * n_valid * dhd)
        print(_line(f"decode {label} b={db} L={dL} pos={dpos} h={dh} "
                    f"kv={dkv} hd={dhd} f32 q / bf16 cache", t, d_bound)
              + " (library: sdpa on bf16 q, timed only)")
        dec[label] = (t, d_bound)
    return dict(flash=(flash, flash_bound), sweep=(sweep, sweep_bound),
                gla=(gla, gla_bound), decode=dec["glm4-9b"])


def _largest_batch(report) -> int:
    """The largest batch the wave handed a kernel: an offloaded batch or a
    group's local users."""
    return max(max(s.batch_size, len(s.offload) - s.batch_size)
               for s in report.schedules)


def glm4_phases() -> dict:
    phase("serve: full-width glm4-9b, core inner")
    cfg, server, fleet, profile, edge, reqs, report, n = serve_full_width(
        "glm4-9b", [])
    phase("serve: sweep-kernel inner")
    sweep_n = serve_sweep_inner(cfg, server, fleet, profile, edge, reqs,
                                report)
    phase("decode: full-width glm4-9b")
    dec = decode_full_width(cfg, server.executor.params)
    return dict(flash_n=n["flash_attention"], sweep_n=sweep_n,
                b=_largest_batch(report), decode=dec)


def zamba2_phases() -> dict:
    phase("serve: full-width zamba2-7b")
    cfg, server, _, _, _, _, report, n = serve_full_width(
        "zamba2-7b", ["--arch", "zamba2-7b"])
    phase("decode: full-width zamba2-7b")
    dec = decode_full_width(cfg, server.executor.params)
    return dict(flash_n=n["flash_attention"], gla_n=n["gla_scan"],
                b=_largest_batch(report), decode=dec)


def _free() -> None:
    """Give the last model's weights back before the next is drawn."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory after freeing: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")


def _record(name, launches, err, t, bound, library=True) -> dict:
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                replaces=REPLACES[name], launches=launches,
                max_abs_err=err, ms=t["kernel"][0], plain_ms=t["plain"][0],
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=t["library"][0] if library else None)


#: the Pallas TPU kernel each CUDA kernel replaces
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:83",
    "jdob_sweep": "src/repro/kernels/jdob_sweep.py:64",
    "gla_scan": "src/repro/kernels/gla_scan.py:64",
    "decode_attention": "src/repro/kernels/decode_attention.py:61",
}


def main() -> None:
    phase("card")
    smi = card()
    phase("build")
    build()
    phase("kernels vs plain")
    flash_err = check_flash()
    sweep_err, sweep_args = check_sweep()
    gla_err = check_gla()
    decode_err = check_decode()
    phase("planner: cuda vs cpu")
    check_planner()
    glm = glm4_phases()
    _free()
    zam = zamba2_phases()
    _free()
    phase("times")
    t = times(glm["b"], sweep_args, zam["b"])
    flash_n = glm["flash_n"] + zam["flash_n"]
    decode_n = glm["decode"]["launches"] + zam["decode"]["launches"]
    for name, r in (("glm4-9b", glm), ("zamba2-7b", zam)):
        print(f"{name} decode vs full forward: float32 cache "
              f"{r['decode']['err_f32']:.3e} (limit 5e-3), bfloat16 cache "
              f"{r['decode']['gap_bf16']:.3e} (measured)")
    print(f"launches on the main paths: flash {glm['flash_n']} (glm4-9b "
          f"wave) + {zam['flash_n']} (zamba2-7b wave), sweep "
          f"{glm['sweep_n']} (sweep-inner wave), gla {zam['gla_n']} "
          f"(zamba2-7b wave), decode {glm['decode']['launches']} (glm4-9b) "
          f"+ {zam['decode']['launches']} (zamba2-7b); warm decode step "
          f"{glm['decode']['step_ms']:.3f} ms (glm4-9b), "
          f"{zam['decode']['step_ms']:.3f} ms (zamba2-7b)")
    kernels = [
        _record("flash_attention", flash_n, flash_err, *t["flash"]),
        _record("jdob_sweep", glm["sweep_n"], sweep_err, *t["sweep"],
                library=False),
        _record("gla_scan", zam["gla_n"], gla_err, *t["gla"],
                library=False),
        _record("decode_attention", decode_n, decode_err, *t["decode"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
