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
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.gla_scan import gla_scan, gla_scan_plain
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
def test_gla_kernel_matches_plain_on_card(cuda):
    """f32 at 2e-5 (8e-5 for chunks ≥ 64) and bf16 at 3e-2, states at
    1e-4 / 1e-2: the reference kernel tests' tolerances.  Ragged L, a
    starting state, Dk != Dv, a strided v (the Mamba2 mixer's view),
    chunks of 8 to 32 steps (the short-chunk kernel) and of 128 (the tiled
    one), and rows too short for 16-byte loads."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for (b, L, h, dk, dv, chunk, with_state) in [
                (2, 32, 2, 16, 16, 8, False), (1, 64, 4, 8, 24, 16, False),
                (2, 37, 3, 64, 64, 16, True), (1, 300, 2, 64, 32, 128, True),
                (6, 48, 112, 64, 64, 16, False),   # three serving chunks
                (2, 70, 3, 64, 64, 32, True),      # 32-step chunks
                (1, 50, 2, 64, 48, 24, False),     # a chunk of 24
                (1, 20, 2, 6, 10, 8, True)]:       # rows of 6 and 10
            rnd = lambda *s, scale=1.0: (torch.randn(
                *s, generator=g, device=cuda) * scale)
            q = rnd(b, L, h, dk).to(dtype)
            k = rnd(b, L, h, dk, scale=0.3).to(dtype)
            v = rnd(b, L, 2 * h, dv).to(dtype)[:, :, ::2]
            ld = -torch.nn.functional.softplus(rnd(b, L, h))
            s0 = rnd(b, h, dk, dv, scale=0.5) if with_state else None
            y, s = gla_scan(q, k, v, ld, chunk=chunk, state_in=s0)
            y0, s_want = gla_scan_plain(q, k, v, ld, chunk=chunk,
                                        state_in=s0)
            tol = TOL[str(dtype)[6:]]
            atol = tol if dtype == torch.bfloat16 or chunk < 64 else 8e-5
            torch.testing.assert_close(y.float(), y0.float(), atol=atol,
                                       rtol=tol)
            torch.testing.assert_close(
                s, s_want, rtol=1e-2,
                atol=1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
def test_decode_kernel_matches_plain_on_card(cuda):
    """The reference's decode sweep shapes plus glm4-9b's (16 query heads
    per kv head, hd 128) and zamba2-7b's (hd 112), each dtype pairing of
    q and cache, pos read from the card; long caches split over a cluster
    (most shares past the valid slots at pos 1000; a ring that wrapped;
    scores spilled to scratch at 32768 slots), no valid slot (pos -1) and
    rows too short for 16-byte loads (hd 12); f32 caches at 2e-5, bf16 at
    3e-2."""
    g = torch.Generator(device=cuda).manual_seed(1)
    shapes = [(2, 64, 4, 2, 32, 40), (1, 128, 8, 8, 64, 127),
              (2, 32, 4, 1, 16, 100), (1, 64, 2, 2, 128, 10),
              (2, 64, 4, 4, 16, 0), (6, 40, 32, 2, 128, 35),
              (6, 40, 32, 32, 112, 39), (1, 77, 16, 1, 64, 50),
              (6, 4096, 32, 2, 128, 4095), (6, 4096, 32, 2, 128, 1000),
              (2, 512, 8, 2, 64, 1300), (2, 64, 4, 2, 32, -1),
              (1, 32768, 16, 1, 128, 20000), (1, 30, 6, 2, 12, 20)]
    for qd, cd in [(torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32)]:
        for (b, L, h, kv, hd, pos) in shapes:
            q = torch.randn(b, 1, h, hd, generator=g, device=cuda).to(qd)
            k, v = (torch.randn(b, L, kv, hd, generator=g, device=cuda
                                ).to(cd) for _ in range(2))
            p = torch.tensor(pos, dtype=torch.int32, device=cuda)
            got = decode_attention(q, k, v, p).float()
            want = decode_attention_plain(q, k, v, p).float()
            tol = TOL["bfloat16" if torch.bfloat16 in (qd, cd)
                      else "float32"]
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
