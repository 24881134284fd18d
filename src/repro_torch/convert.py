"""Carry the reference's weights across to the port.

The reference (``repro.models.init_params``) stacks each plan segment's
per-layer arrays along a leading ``repeats`` axis for ``lax.scan``; the
port keeps one dictionary per layer.  :func:`params_from_jax` undoes the
stacking exactly as the reference's ``serving/engine.py#flatten_layers``
does, so both packages compute the same function.  The caller converts
the reference pytree to numpy arrays first (this module never imports
JAX)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def params_from_jax(cfg: ArchConfig, params_np: dict, device=None) -> dict:
    """``params_np``: the reference ``init_params(cfg, key)`` pytree with
    every leaf converted to a numpy array.  Returns the port's params
    (see :func:`repro_torch.models.init_params`) on ``device``."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, order="C")).to(dev)
    layers = []
    for seg_params, (pattern, reps) in zip(params_np["segments"], cfg.plan):
        for r in range(reps):
            for _spec, elem in zip(pattern, seg_params):
                layers.append({k: t(v[r]) for k, v in elem.items()})
    out = {"embed": {"w": t(params_np["embed"]["w"])},
           "layers": layers,
           "final_norm": t(params_np["final_norm"])}
    if "lm_head" in params_np:
        out["lm_head"] = {"w": t(params_np["lm_head"]["w"])}
    return out
