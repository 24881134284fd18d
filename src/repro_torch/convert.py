"""Carry the reference's weights and decode caches across to the port.

The reference (``repro.models.init_params`` / ``init_cache``) stacks each
plan segment's per-layer arrays along a leading ``repeats`` axis for
``lax.scan``; the port keeps one dictionary per layer.
:func:`params_from_jax` and :func:`cache_from_jax` undo the stacking
exactly as the reference's ``serving/engine.py#flatten_layers`` does, for
every leaf of a layer (attention, MLP and Mamba2 alike), so both packages
compute the same function from the same state.  The caller converts the
reference pytree to numpy arrays first (this module never imports
JAX)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _tensor(a, dev) -> torch.Tensor:
    """A numpy array on ``dev``; bfloat16 arrays (numpy knows them only
    through an extension dtype) cross as their 16-bit patterns."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _unstack(cfg: ArchConfig, segments, dev) -> list[dict]:
    """Per-segment, per-pattern-element stacked leaves → one dict per
    layer, in layer order."""
    layers = []
    for seg, (pattern, reps) in zip(segments, cfg.plan):
        for r in range(reps):
            for _spec, elem in zip(pattern, seg):
                layers.append({k: _tensor(a[r], dev)
                               for k, a in elem.items()})
    return layers


def params_from_jax(cfg: ArchConfig, params_np: dict, device=None) -> dict:
    """``params_np``: the reference ``init_params(cfg, key)`` pytree with
    every leaf converted to a numpy array.  Returns the port's params
    (see :func:`repro_torch.models.init_params`) on ``device``."""
    dev = resolve_device(device)
    t = lambda a: _tensor(a, dev)
    layers = _unstack(cfg, params_np["segments"], dev)
    out = {"embed": {"w": t(params_np["embed"]["w"])},
           "layers": layers,
           "final_norm": t(params_np["final_norm"])}
    if "lm_head" in params_np:
        out["lm_head"] = {"w": t(params_np["lm_head"]["w"])}
    return out


def cache_from_jax(cfg: ArchConfig, cache_np: dict, device=None) -> dict:
    """``cache_np``: a reference decode cache (``init_cache`` / ``prefill``
    / ``decode_step``) with every leaf converted to a numpy array.
    Returns the port's cache (see :func:`repro_torch.models.init_cache`):
    per-layer K/V in their dtype (bfloat16 included), Mamba2 conv and SSD
    states, and ``pos`` as a 0-d int32 tensor, on ``device``."""
    dev = resolve_device(device)
    return dict(layers=_unstack(cfg, cache_np["segments"], dev),
                pos=_tensor(np.asarray(cache_np["pos"], np.int32), dev))
