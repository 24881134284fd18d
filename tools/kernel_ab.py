#!/usr/bin/env python3
"""Time the decode-attention and GLA-scan kernels of one checkout of the
PyTorch/CUDA port on one GPU, at the shapes the main paths give them.

  python3 tools/kernel_ab.py --src src --label new
  python3 tools/kernel_ab.py --src OTHER_CHECKOUT/src --label parent

``--src`` is the directory that holds the ``repro_torch`` package to time.
To compare two checkouts on one card, run this for each in turns (A, B, B,
A) on the same machine, one after the other.  Times are ms per call under
a CUDA graph (20 calls per graph, 20 replays) and eager; the library call
is ``scaled_dot_product_attention`` on a bfloat16 query (timed only).
Prints the card's name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (b, L, h, kv, hd, pos): glm4-9b's and zamba2-7b's last decode step of
#: the card check, and glm4-9b's heads over a long cache
DECODE = {"glm4-9b": (6, 40, 32, 2, 128, 39),
          "zamba2-7b": (6, 40, 32, 32, 112, 39),
          "glm4-9b L=4096": (6, 4096, 32, 2, 128, 4095),
          "glm4-9b L=4096 pos=1000": (6, 4096, 32, 2, 128, 1000)}
#: (b, L, h, dk, dv, chunk): zamba2-7b's wave at its largest batches
GLA = {"zamba2-7b b=4": (4, 32, 112, 64, 64, 16),
       "zamba2-7b b=6": (6, 32, 112, 64, 64, 16)}


def time_graph(torch, fn, per_graph: int = 20, replays: int = 20) -> float:
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


def time_eager(torch, fn, iters: int = 200) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device is visible")
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.gla_scan import gla_scan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = dict(label=args.label, src=args.src, card=smi, decode={}, gla={})
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, (b, L, h, kv, hd, pos) in DECODE.items():
        q = torch.randn(b, 1, h, hd, generator=g, device="cuda")
        k, v = (torch.randn(b, L, kv, hd, generator=g, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        n_valid = min(pos + 1, L)
        q16 = q.to(torch.bfloat16).view(b, h, 1, hd)
        kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (k, v))
        fns = {"kernel": lambda: decode_attention(q, k, v, p),
               "library": lambda: F.scaled_dot_product_attention(
                   q16, kt, vt, enable_gqa=True)}
        out["decode"][name] = {n: (time_graph(torch, f),
                                   time_eager(torch, f))
                               for n, f in fns.items()}
    for name, (b, L, h, dk, dv, chunk) in GLA.items():
        rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
        q, k = rnd(b, L, h, dk), rnd(b, L, h, dk) * 0.3
        v = rnd(b, L, h * dv + 256)[..., :h * dv].view(b, L, h, dv)
        ld = -F.softplus(rnd(b, L, h))
        f = lambda: gla_scan(q, k, v, ld, chunk=chunk)
        out["gla"][name] = {"kernel": (time_graph(torch, f),
                                       time_eager(torch, f))}
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
