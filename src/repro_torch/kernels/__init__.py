"""Hand-written CUDA kernels for Hopper (sm_90a), replacing the reference's
Pallas TPU kernels on this slice's path.

Each kernel: a source under ``csrc/`` built by :mod:`.build` into a
ctypes-loaded library, a wrapper beside its plain PyTorch version
(``flash_attention.py``, ``jdob_sweep.py``) with a launch counter, and a
layout-level entry point in ``ops.py``.  A CUDA tensor goes through the
kernel or raises; a CPU tensor takes the plain version."""
from .ops import flash_attention_op, jdob_sweep_op, jdob_sweep_schedule

__all__ = ["flash_attention_op", "jdob_sweep_op", "jdob_sweep_schedule"]
