"""PyTorch/CUDA port of the J-DOB co-inference system.

A second package beside the JAX reference ``repro``: same layout and
module names, PyTorch idiom inside, hand-written CUDA kernels for the
reference's Pallas kernels.  It imports ``torch`` and numpy, never JAX and
nothing of ``repro``.  Entry points take an explicit ``device`` and run on
CUDA unless the caller passes ``device="cpu"``."""
