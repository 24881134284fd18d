"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``gpu``: they skip where no CUDA device is visible.  The
file imports neither JAX nor the reference package, so it runs on a GPU
machine that has only the port's dependencies:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import (make_edge_profile, make_fleet,
                              mobilenet_v2_profile)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.jdob_sweep import (jdob_sweep_kernel,
                                            jdob_sweep_plain)
from repro_torch.kernels.ops import sweep_inputs

#: the reference kernel tests' tolerances (tests/kernels/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SWEEP_CASES = [(4, 2.13, 0, 0.0), (8, (0.0, 10.0), 3, 1e-3),
               (12, 30.25, 1, 0.0), (1, 5.0, 2, 0.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for (bh, kvh, sq, sk, hd, causal, window) in [
                (128, 8, 32, 32, 128, True, None),
                (8, 4, 37, 37, 64, True, 16),
                (8, 2, 21, 53, 128, False, None)]:
            mk = lambda n, s: torch.randn(n, s, hd, generator=g,
                                          device=cuda).to(dtype)
            q, k, v = mk(bh, sq), mk(kvh, sk), mk(kvh, sk)
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  n_rep=bh // kvh).float()
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window,
                                         n_rep=bh // kvh).float()
            tol = TOL[str(dtype)[6:]]
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_sweep_kernel_bitwise_plain_on_card(cuda):
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    for M, beta, seed, t_free in SWEEP_CASES:
        args = [torch.from_numpy(a).to(cuda) for a in sweep_inputs(
            prof, make_fleet(M, prof, edge, beta=beta, seed=seed), edge,
            t_free)]
        assert torch.equal(jdob_sweep_kernel(*args),
                           jdob_sweep_plain(*args))
