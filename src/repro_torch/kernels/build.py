"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``) and is
loaded through ``ctypes`` — no PyTorch headers, so a build takes seconds.
Libraries land in ``kernels/_build/`` under a name keyed on a hash of the
source and the flags, so a clean checkout builds them at first use and an
edited source rebuilds.  A build that fails raises: there is no fallback
to a plain version for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.core.telemetry import note_runtime_event

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
#: per-source extra flags: the sweep must not contract multiply-adds, so
#: it stays bitwise equal to its plain version
EXTRA_FLAGS = {"jdob_sweep": ["-fmad=false"]}
KERNELS = ("flash_attention", "jdob_sweep", "decode_attention", "gla_scan")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    seconds its build took (0.0 when it was already built) and the
    compiler's output (``-Xptxas -v`` register and spill report)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    report = {}
    for name, job in started.items():
        if job is None:
            report[name] = dict(seconds=0.0, log="")
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        secs = time.perf_counter() - t0
        report[name] = dict(seconds=secs, log=log)
        note_runtime_event(f"kernels.build.{name}",
                           f"built {out.name} in {secs:.1f}s",
                           category="build")
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
