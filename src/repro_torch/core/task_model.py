"""Sub-task sequence model for co-inference (paper §II-A).

A DNN inference task is a sequence of N sub-tasks (blocks). Block n has
computational workload ``A[n]`` (FLOPs, per sample) and boundary output size
``O[n]`` (bytes) which is also the input of block n+1. Index 0 is the
"virtual" input layer: ``A[0] = 0``, ``O[0]`` = raw input size.

Two sources of profiles:
  * :func:`mobilenet_v2_profile` — the paper's own workload (Fig. 2),
    computed exactly from the MobileNetV2 architecture.
  * :func:`profile_from_arch` — any assigned transformer ArchConfig; one
    block per layer (embedding folded into block 1, head into block N),
    which is how J-DOB becomes a first-class scheduler for every model in
    this framework.

Units: FLOPs, bytes, seconds, Hz, Joules.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """Per-sample block sequence: arrays indexed 0..N (0 = virtual input)."""

    name: str
    A: np.ndarray          # (N+1,) FLOPs per block, A[0] == 0
    O: np.ndarray          # (N+1,) boundary activation bytes, O[0] = input
    g: np.ndarray          # (N+1,) device latency block factor (Eq. 1)
    q: np.ndarray          # (N+1,) device energy block factor (Eq. 2)
    block_names: tuple[str, ...] = ()

    def __post_init__(self):
        assert self.A.shape == self.O.shape == self.g.shape == self.q.shape
        assert self.A[0] == 0.0, "virtual input layer must have zero work"

    @property
    def N(self) -> int:
        return len(self.A) - 1

    @property
    def total_flops(self) -> float:
        return float(self.A.sum())

    # Prefix sums used throughout the paper's notation:
    #   v_n = sum_{i<=n} g_i A_i   (device cycles numerator, Eq. 17)
    #   u_n = sum_{i<=n} q_i A_i   (device energy numerator, Eq. 21)
    def v(self) -> np.ndarray:
        return np.cumsum(self.g * self.A)

    def u(self) -> np.ndarray:
        return np.cumsum(self.q * self.A)


def _bottleneck_macs(h: int, c_in: int, c_out: int, t: int, stride: int,
                     reps: int) -> tuple[float, int]:
    """MACs of one MobileNetV2 bottleneck stage; returns (macs, out_res)."""
    macs = 0.0
    for r in range(reps):
        s = stride if r == 0 else 1
        ci = c_in if r == 0 else c_out
        ho = h // s
        exp = t * ci
        if t != 1:
            macs += h * h * ci * exp                 # 1x1 expand
        macs += ho * ho * exp * 9                    # 3x3 depthwise
        macs += ho * ho * exp * c_out                # 1x1 project
        h = ho
    return macs, h


def mobilenet_v2_profile(input_res: int = 224,
                         act_bytes: int = 4) -> TaskProfile:
    """The paper's Fig. 2 partitioning: Conv, B1..B7, Conv, CLS (N = 10).

    Workloads are computed exactly from the MobileNetV2(1.0) architecture
    [Sandler et al., CVPR'18]; boundary sizes match Fig. 2's output shapes.
    """
    # (t expansion, c out, n reps, s stride) per bottleneck stage:
    stages = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    names = ["input", "conv1"] + [f"B{i+1}" for i in range(7)] + ["conv2", "cls"]
    A = [0.0]
    O = [float(input_res * input_res * 3 * act_bytes)]

    h = input_res // 2
    A.append(2.0 * input_res // 2 * input_res // 2 * 32 * 27)  # conv1 3x3x3x32 s2
    A[-1] = 2.0 * h * h * 32 * 27
    O.append(float(h * h * 32 * act_bytes))

    c_in = 32
    for (t, c, n, s) in stages:
        macs, h = _bottleneck_macs(h, c_in, c, t, s, n)
        A.append(2.0 * macs)
        O.append(float(h * h * c * act_bytes))
        c_in = c

    A.append(2.0 * h * h * c_in * 1280)              # conv2 1x1 -> 1280
    O.append(float(h * h * 1280 * act_bytes))
    A.append(2.0 * (1280 * 1000 + h * h * 1280))     # pool + fc
    O.append(float(1000 * act_bytes))

    A = np.asarray(A, dtype=np.float64)
    O = np.asarray(O, dtype=np.float64)
    ones = np.ones_like(A)
    return TaskProfile("mobilenet_v2", A, O, ones, ones, tuple(names))


# ---------------------------------------------------------------------------
# Transformer architectures -> block sequences
# ---------------------------------------------------------------------------

def _attn_flops(d: int, heads: int, kv_heads: int, head_dim: int,
                seq: int, kv_len: int, causal: bool) -> float:
    """Per-sample FLOPs of one attention sub-layer at query length ``seq``."""
    qkv = 2.0 * seq * d * (heads * head_dim + 2 * kv_heads * head_dim)
    out = 2.0 * seq * heads * head_dim * d
    eff_kv = kv_len / 2.0 if (causal and kv_len == seq) else kv_len
    attn = 2.0 * 2.0 * seq * eff_kv * heads * head_dim
    return qkv + out + attn


def _mlp_flops(d: int, d_ff: int, seq: int, gated: bool = True) -> float:
    mults = 3 if gated else 2
    return 2.0 * seq * d * d_ff * mults


def profile_from_arch(cfg, seq: int, mode: str = "prefill",
                      act_bytes: int = 2, window: int | None = None,
                      session_tokens: int = 1) -> TaskProfile:
    """Build the J-DOB block sequence for an assigned architecture.

    ``cfg`` is a :class:`repro_torch.configs.base.ArchConfig`.  One J-DOB block per
    transformer layer.  ``mode``:
      * ``"prefill"`` — each block processes ``seq`` tokens; boundary data is
        the (seq, d_model) activation.
      * ``"decode"``  — each block processes 1 token against a ``seq``-long
        context; boundary data is the single-token activation **plus**, for
        recurrent blocks, the recurrent state that a partition hand-off must
        transfer (the beyond-paper SSM observation in DESIGN.md §4).
    """
    from repro_torch.configs.base import ArchConfig  # local import, no cycle at module load
    assert isinstance(cfg, ArchConfig)
    d = cfg.d_model
    q_len = seq if mode == "prefill" else 1
    kv_len = seq if window is None else min(seq, window)

    A = [0.0]
    tok_bytes = float(q_len * d * act_bytes)
    # the raw input is TOKEN IDS (4 B each, + stubbed vision embeddings for
    # VLMs) — offloading at ñ=0 ships those, not an activation
    in_bytes = float(q_len * 4)
    if cfg.num_vision_tokens:
        in_bytes += float(cfg.num_vision_tokens * d * act_bytes)
    O = [in_bytes]
    state_list = [0.0]
    names = ["input"]
    for spec in cfg.layer_sequence():
        f = 0.0
        state_bytes = 0.0
        if spec.kind in ("attn", "swa", "cross"):
            kvl = kv_len if spec.kind != "swa" else min(kv_len, spec.window or kv_len)
            f += _attn_flops(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             q_len, kvl, causal=True)
            if spec.kind == "cross":
                f += _attn_flops(d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, q_len, cfg.num_vision_tokens,
                                 causal=False)
        elif spec.kind == "mamba2":
            d_in = cfg.ssm_d_inner
            f += 2.0 * q_len * d * (2 * d_in + 2 * cfg.ssm_n_groups * cfg.ssm_state + cfg.ssm_heads)
            f += 2.0 * q_len * d_in * cfg.ssm_state * 2   # SSD state update+readout
            f += 2.0 * q_len * d_in * d                   # out proj
            state_bytes = (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                           + 4 * d_in) * act_bytes        # SSD state + conv window
        elif spec.kind == "mlstm":
            d_in = cfg.ssm_d_inner
            hd = d_in // cfg.num_heads
            f += 2.0 * q_len * d * 3 * d_in + 2.0 * q_len * d_in * d
            f += 2.0 * 2.0 * q_len * cfg.num_heads * hd * hd  # C update + readout
            state_bytes = (cfg.num_heads * (hd * hd + hd + 1)) * act_bytes
        elif spec.kind == "slstm":
            f += 2.0 * q_len * d * 4 * d + 2.0 * q_len * d * d
            state_bytes = 4 * d * act_bytes
        else:
            raise ValueError(spec.kind)

        if spec.ffn == "dense":
            f += _mlp_flops(d, cfg.d_ff, q_len, gated=cfg.gated_mlp)
        elif spec.ffn == "moe":
            active = cfg.moe_top_k + cfg.moe_shared_experts
            f += _mlp_flops(d, cfg.moe_d_ff, q_len, gated=cfg.gated_mlp) * active
            f += 2.0 * q_len * d * cfg.moe_experts    # router
        # boundary data: activation + (decode) recurrent state hand-off
        if mode == "decode" and spec.kind in ("attn", "swa", "cross"):
            # a mid-decode hand-off must migrate this layer's KV cache
            state_bytes = 2 * cfg.num_kv_heads * cfg.head_dim * kv_len * act_bytes
        A.append(f)
        O.append(tok_bytes)
        state_list.append(state_bytes)
        names.append(spec.kind)

    # fold embedding lookup (negligible FLOPs) into block 1 and the LM head
    # into the last block:
    A[-1] += 2.0 * q_len * d * cfg.vocab_size
    O[-1] = float(q_len * cfg.vocab_size * act_bytes) if mode == "prefill" else tok_bytes

    A = np.asarray(A, dtype=np.float64)
    O = np.asarray(O, dtype=np.float64)
    if mode == "decode":
        # offloading after block n hands the session over mid-decode: every
        # offloaded block's recurrent state / KV cache must move once.
        # O[n] += Σ_{i>n} state_bytes_i  (suffix sum; O(1) for SSM blocks —
        # the beyond-paper observation in DESIGN.md §4).  The migration is
        # once per session, amortized over ``session_tokens`` decode steps.
        st = np.asarray(state_list, dtype=np.float64)        # (N+1,)
        suffix = np.concatenate([np.cumsum(st[::-1])[::-1][1:], [0.0]])
        O = O + suffix / max(session_tokens, 1)
    ones = np.ones_like(A)
    return TaskProfile(f"{cfg.name}:{mode}@{seq}", A, O, ones, ones,
                       tuple(names))
