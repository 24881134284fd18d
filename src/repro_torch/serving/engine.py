"""Block-partitioned execution engine for co-inference.

A request's DNN pass is split at the J-DOB partition point ñ — the
"device" computes blocks 1..ñ, ships the boundary activation, and the edge
executes blocks ñ+1..N *batched* across users.  This module runs that
split on the real model so the serve path can check that the co-inference
output equals the monolithic forward."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import RunCtx, _apply_elem, head


def flatten_layers(cfg: ArchConfig, params) -> list[tuple[Any, Any]]:
    """The per-layer [(spec, params)] list the executor walks."""
    return list(zip(cfg.layer_sequence(), params["layers"]))


@dataclasses.dataclass
class BlockwiseExecutor:
    """Runs arbitrary block ranges of a model — the engine the paper's
    offloading needs (device prefix / edge suffix).  Computes in float32
    with 16-step SSM scan chunks, as the reference executor does, on the
    device its params live on."""
    cfg: ArchConfig
    params: Any
    ctx: RunCtx = None

    def __post_init__(self):
        self.ctx = self.ctx or RunCtx(self.cfg, compute_dtype=torch.float32,
                                      ssm_chunk=16)
        self.layers = flatten_layers(self.cfg, self.params)
        self.device = self.params["embed"]["w"].device

    def tokens(self, token_rows) -> torch.Tensor:
        """Host token rows (numpy (B, S) integers) on the model's device."""
        return torch.as_tensor(token_rows).to(self.device)

    def embed(self, tokens):
        return self.params["embed"]["w"][tokens].to(self.ctx.stream)

    def run_blocks(self, h, lo: int, hi: int):
        """Apply layers [lo, hi) to hidden states h (B, S, d)."""
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        for spec, p in self.layers[lo:hi]:
            h = _apply_elem(spec, p, h, self.ctx, positions)
        return h

    def head(self, h):
        return head(self.cfg, self.params, h, self.ctx)

    def full_forward(self, tokens):
        return self.head(self.run_blocks(self.embed(tokens), 0,
                                         len(self.layers)))
