"""The port's import rule and device rule.

``repro_torch`` imports torch and numpy, never JAX and nothing of the JAX
package ``repro``.  Its entry points run on CUDA unless the caller passes
``device="cpu"``; without a GPU they raise.  A kernel wrapper takes its
plain version only for CPU tensors: anything else launches the kernel or
raises, and a failed build raises too."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import ARCHS
from repro_torch.core import (PlannerService, jdob_schedule,
                              make_edge_profile, make_fleet,
                              mobilenet_v2_profile)
from repro_torch.device import resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import jdob_sweep_op
from repro_torch.kernels.flash_attention import _launch as flash_launch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.jdob_sweep import _launch as sweep_launch
from repro_torch.kernels.jdob_sweep import jdob_sweep_kernel
from repro_torch.kernels.ops import sweep_inputs
from repro_torch.launch.serve import build_offline
from repro_torch.models import init_params

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25          # every module of the package was loaded


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*.py")
                                if "_build" not in p.parts) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_reference(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a GPU, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    fleet = make_fleet(3, prof, edge, beta=2.13, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_offline(ARCHS["glm4-9b"].reduced(), 2, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(ARCHS["glm4-9b"].reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlannerService(prof, edge)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jdob_schedule(prof, fleet, edge)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jdob_sweep_op(prof, fleet, edge)
    assert jdob_schedule(prof, fleet, edge, device="cpu").feasible


def test_flash_wrapper_raises_instead_of_computing():
    q = torch.zeros(4, 8, 16)
    kv = torch.zeros(2, 8, 16)
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"), n_rep=2)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        flash_launch(q, kv, kv, True, None, 2)
    with pytest.raises(TypeError):
        flash_attention(q.double(), kv.double(), kv.double(), n_rep=2)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, kv, kv, n_rep=3)
    assert flash_attention.launches == launches


def test_sweep_wrapper_raises_instead_of_computing():
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    args = [torch.from_numpy(a) for a in sweep_inputs(
        prof, make_fleet(4, prof, edge, beta=2.13, seed=0), edge)]
    launches = jdob_sweep_kernel.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        jdob_sweep_kernel(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sweep_launch(tuple(args[:9]), args[9], args[10])
    with pytest.raises(TypeError, match="float32"):
        jdob_sweep_kernel(*(a.double() for a in args))
    assert jdob_sweep_kernel.launches == launches


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kbuild.build(("jdob_sweep",))
    assert not list(tmp_path.iterdir())     # nothing half-built is left
