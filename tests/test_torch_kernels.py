"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
reference's kernels run in interpret mode, as tests/kernels/ runs them.
Inputs come from numpy with a fixed seed and go to both packages.  The
CUDA kernels themselves are held against their plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels import flash_attention_op as ref_flash_op
from repro.kernels import jdob_sweep_op as ref_sweep_op
from repro_torch.core import (make_edge_profile, make_fleet,
                              mobilenet_v2_profile)
from repro_torch.kernels import flash_attention_op, jdob_sweep_op
from repro_torch.kernels.jdob_sweep import (jdob_sweep_kernel,
                                            jdob_sweep_plain)
from repro_torch.kernels.ops import sweep_inputs
from repro_torch.kernels.ref import jdob_sweep_ref

#: the reference kernel tests' tolerances (tests/kernels/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_SHAPES = [  # b, sq, sk, h, kv, hd, block_q, block_k, window
    (1, 64, 64, 4, 4, 32, 16, 16, None),
    (2, 128, 128, 4, 2, 64, 32, 64, None),       # GQA
    (2, 64, 64, 8, 1, 16, 64, 32, None),         # MQA
    (1, 128, 128, 2, 2, 128, 32, 32, 32),        # sliding window
    (1, 32, 32, 2, 2, 8, 32, 32, None),          # single block
]
SWEEP_CASES = [(4, 2.13, 0, 0.0), (8, (0.0, 10.0), 3, 1e-3),
               (12, 30.25, 1, 0.0), (1, 5.0, 2, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,bq,bk,window", FLASH_SHAPES)
def test_flash_plain_matches_reference_kernel(dtype, b, sq, sk, h, kv, hd,
                                              bq, bk, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, kv, hd), dtype=np.float32)
    jd = getattr(jnp, dtype)
    want = ref_flash_op(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                        jnp.asarray(v).astype(jd), window=window,
                        block_q=bq, block_k=bk, interpret=True)
    td = getattr(torch, dtype)
    got = flash_attention_op(torch.from_numpy(q).to(td),
                             torch.from_numpy(k).to(td),
                             torch.from_numpy(v).to(td), window=window)
    assert got.dtype == td and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("M,beta,seed,t_free", SWEEP_CASES)
def test_sweep_plain_matches_reference_kernel(M, beta, seed, t_free):
    """Same inf pattern, finite cells within rtol 1e-4 and the same argmin
    as the reference's Pallas sweep; and the port's sweep agrees with the
    port's own planner grid the same way."""
    jp = jcore.mobilenet_v2_profile()
    je = jcore.make_edge_profile(jp)
    want = ref_sweep_op(jp, jcore.make_fleet(M, jp, je, beta=beta,
                                             seed=seed), je, t_free=t_free,
                        interpret=True)
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    fleet = make_fleet(M, prof, edge, beta=beta, seed=seed)
    got = jdob_sweep_op(prof, fleet, edge, t_free=t_free, device="cpu")
    core = jdob_sweep_ref(prof, fleet, edge, t_free=t_free, device="cpu")
    for other in (want, core):
        finite = np.isfinite(other)
        assert (np.isfinite(got) == finite).all()
        if finite.any():
            np.testing.assert_allclose(got[finite], other[finite],
                                       rtol=1e-4)
            assert np.argmin(got) == np.argmin(other)


def test_sweep_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes through the plain version and counts no launch."""
    prof = mobilenet_v2_profile()
    edge = make_edge_profile(prof)
    args = [torch.from_numpy(a) for a in sweep_inputs(
        prof, make_fleet(12, prof, edge, beta=30.25, seed=1), edge)]
    launches = jdob_sweep_kernel.launches
    grid = jdob_sweep_plain(*args)
    assert grid.shape == (prof.N + 1, args[-1].shape[1])
    assert torch.isfinite(grid).any()
    assert torch.equal(jdob_sweep_kernel(*args), grid)
    assert jdob_sweep_kernel.launches == launches
