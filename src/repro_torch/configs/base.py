"""Architecture configuration system.

Every assigned architecture is an :class:`ArchConfig`.  The model substrate
consumes the config's *layer plan*: a list of ``(pattern, repeats)`` segments
where ``pattern`` is a short list of :class:`LayerSpec`.  The executor scans
over ``repeats`` with per-pattern-element stacked parameters, which keeps the
HLO small for 95-layer models (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

LayerKind = Literal["attn", "swa", "cross", "mamba2", "mlstm", "slstm"]
FfnKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind = "attn"
    ffn: FfnKind = "dense"
    window: int | None = None       # sliding window size for kind="swa"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # layer plan: list of (pattern, repeats); flattened length == num_layers
    plan: tuple[tuple[tuple[LayerSpec, ...], int], ...] = ()

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0

    # SSM (mamba2 / xlstm)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv: int = 4

    # VLM
    num_vision_tokens: int = 0

    gated_mlp: bool = True
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window variant used for long_500k on full-attention archs
    long_context_window: int = 8192

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.plan:
            object.__setattr__(
                self, "plan", (((LayerSpec("attn", "dense"),), self.num_layers),))
        n = sum(len(p) * r for p, r in self.plan)
        assert n == self.num_layers, (self.name, n, self.num_layers)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_sequence(self) -> list[LayerSpec]:
        out: list[LayerSpec] = []
        for pattern, reps in self.plan:
            out.extend(list(pattern) * reps)
        return out

    def with_sliding_window(self, window: int | None = None) -> "ArchConfig":
        """The long-context variant: every full-attention layer becomes
        sliding-window attention with a ring KV cache (DESIGN.md §4)."""
        w = window or self.long_context_window
        new_plan = tuple(
            (tuple(dataclasses.replace(s, kind="swa", window=w)
                   if s.kind == "attn" else s for s in pattern), reps)
            for pattern, reps in self.plan)
        return dataclasses.replace(self, plan=new_plan,
                                   name=self.name + "+swa")

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for s in self.layer_sequence():
            n += 2 * d                                # norms
            if s.kind in ("attn", "swa", "cross"):
                n += d * (self.num_heads * self.head_dim
                          + 2 * self.num_kv_heads * self.head_dim)
                n += self.num_heads * self.head_dim * d
            elif s.kind == "mamba2":
                di = self.ssm_d_inner
                n += d * (2 * di + 2 * self.ssm_n_groups * self.ssm_state
                          + self.ssm_heads)
                n += self.ssm_conv * (di + 2 * self.ssm_n_groups * self.ssm_state)
                n += self.ssm_heads * 2               # A, D
                n += di * d
            elif s.kind == "mlstm":
                di = self.ssm_d_inner
                n += d * 3 * di + d * 2 * self.num_heads + di * d
            elif s.kind == "slstm":
                n += 4 * d * d + d * d
            if s.ffn == "dense":
                n += d * self.d_ff * (3 if self.gated_mlp else 2)
            elif s.ffn == "moe":
                n += self.moe_experts * d              # router
                per = d * self.moe_d_ff * (3 if self.gated_mlp else 2)
                n += (self.moe_experts + self.moe_shared_experts) * per
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if self.moe_experts == 0:
            return self.param_count()
        d = self.d_model
        per = d * self.moe_d_ff * (3 if self.gated_mlp else 2)
        n_moe_layers = sum(1 for s in self.layer_sequence() if s.ffn == "moe")
        inactive = (self.moe_experts - self.moe_top_k) * per * n_moe_layers
        return self.param_count() - inactive

    def reduced(self, layers: int = 2, d_model: int = 256,
                vocab: int = 512, experts: int = 4) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (spec: ≤2 layers,
        d_model ≤ 512, ≤4 experts)."""
        scale = d_model / self.d_model
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads if self.num_kv_heads
                        < self.num_heads else heads))
        # keep one instance of each distinct pattern element
        pattern = self.plan[0][0]
        uniq: list[LayerSpec] = []
        for p, _ in self.plan:
            for s in p:
                if all(u.kind != s.kind or u.ffn != s.ffn for u in uniq):
                    uniq.append(s)
        uniq = uniq[:layers]
        while len(uniq) < layers:
            uniq.append(pattern[0])
        new_plan = ((tuple(dataclasses.replace(s, window=64 if s.kind == "swa"
                                               else s.window) for s in uniq),
                     1),)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=layers,
            d_model=d_model, num_heads=heads, num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=vocab, plan=new_plan,
            moe_experts=min(experts, self.moe_experts) if self.moe_experts else 0,
            moe_top_k=min(2, self.moe_top_k) if self.moe_top_k else 0,
            moe_shared_experts=min(1, self.moe_shared_experts),
            moe_d_ff=max(32, int(self.moe_d_ff * scale)) if self.moe_d_ff else 0,
            ssm_state=min(16, self.ssm_state) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            num_vision_tokens=16 if self.num_vision_tokens else 0,
            long_context_window=64)
