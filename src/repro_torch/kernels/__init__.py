"""Hand-written CUDA kernels for Hopper (sm_90a), replacing the reference's
Pallas TPU kernels on this slice's path.

Each kernel: a source under ``csrc/`` built by :mod:`.build` into a
ctypes-loaded library, a wrapper beside its plain PyTorch version
(``flash_attention.py``, ``jdob_sweep.py``, ``decode_attention.py``,
``gla_scan.py``) with a launch counter, and a layout-level entry point in
``ops.py``.  A CUDA tensor goes through the kernel or raises; a CPU
tensor takes the plain version."""
from .ops import (decode_attention_op, flash_attention_op, gla_scan_op,
                  jdob_sweep_op, jdob_sweep_schedule)

__all__ = ["decode_attention_op", "flash_attention_op", "gla_scan_op",
           "jdob_sweep_op", "jdob_sweep_schedule"]
