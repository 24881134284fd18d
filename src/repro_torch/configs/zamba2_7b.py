"""zamba2-7b — Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from .base import ArchConfig, LayerSpec

_M = LayerSpec("mamba2", "none")
_A = LayerSpec("attn", "dense")

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    # 81L: 13 super-blocks of (5 mamba2 + 1 shared attn) + 3 trailing mamba2
    # ≈ Zamba2's shared-attention-every-6 interleave
    plan=(((_M, _M, _M, _M, _M, _A), 13), ((_M,), 3)),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=2,
)
