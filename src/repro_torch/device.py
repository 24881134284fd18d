"""Device resolution shared by every entry point of the port.

The port's entry points run on the card: ``device=None`` means CUDA, and a
machine without a GPU raises instead of quietly computing on the host.
Callers that want the host (the CPU tests) pass ``device="cpu"``."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is visible); anything else
    is taken as the caller's explicit choice and validated the same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
