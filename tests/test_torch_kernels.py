"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
reference's kernels run in interpret mode, as tests/kernels/ runs them.
Inputs come from numpy with a fixed seed and go to both packages.  The
CUDA kernels themselves are held against their plain versions by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on the card."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels import decode_attention_op as ref_decode_op
from repro.kernels import flash_attention_op as ref_flash_op
from repro.kernels import gla_scan_op as ref_gla_op
from repro.kernels import jdob_sweep_op as ref_sweep_op
from repro_torch.core import (make_edge_profile, make_fleet,
                              mobilenet_v2_profile)
from repro_torch.kernels import (decode_attention_op, flash_attention_op,
                                 gla_scan_op, jdob_sweep_op)
from repro_torch.kernels.decode_attention import (SCORE_SMEM_MAX, SPLIT_MAX,
                                                  decode_attention,
                                                  decode_attention_plain,
                                                  split_plan)
from repro_torch.kernels.gla_scan import gla_scan
from repro_torch.kernels.jdob_sweep import (jdob_sweep_kernel,
                                            jdob_sweep_plain)
from repro_torch.kernels.ops import sweep_inputs
from repro_torch.kernels.ref import (decode_attention_ref, gla_scan_ref,
                                     jdob_sweep_ref)

#: the reference kernel tests' tolerances (tests/kernels/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_SHAPES = [  # b, sq, sk, h, kv, hd, block_q, block_k, window
    (1, 64, 64, 4, 4, 32, 16, 16, None),
    (2, 128, 128, 4, 2, 64, 32, 64, None),       # GQA
    (2, 64, 64, 8, 1, 16, 64, 32, None),         # MQA
    (1, 128, 128, 2, 2, 128, 32, 32, 32),        # sliding window
    (1, 32, 32, 2, 2, 8, 32, 32, None),          # single block
]
DECODE_SHAPES = [  # b, L, h, kv, hd, block_k, pos, ring
    (2, 64, 4, 2, 32, 16, 40, False),
    (1, 128, 8, 8, 64, 64, 127, False),
    (2, 32, 4, 1, 16, 32, 100, True),            # ring cache, wrapped
    (1, 64, 2, 2, 128, 16, 10, True),            # ring cache, not yet full
    (2, 64, 4, 4, 16, 64, 0, False),             # first token
]
GLA_SHAPES = [  # b, L, h, dk, dv, chunk
    (2, 32, 2, 16, 16, 8),
    (1, 64, 4, 8, 24, 16),                       # Dk != Dv (mLSTM normalizer)
    (2, 128, 1, 64, 64, 128),                    # one chunk
    (1, 48, 2, 32, 32, 16),
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


def _np_rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale
            ).astype(np.float32)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,h,kv,hd,bk,pos,ring", DECODE_SHAPES)
def test_decode_plain_matches_reference_kernel(dtype, b, L, h, kv, hd, bk,
                                               pos, ring):
    """The plain version against the reference's Pallas decode kernel (and
    the port's own oracle) at the reference test's tolerances.  The plain
    version rounds the probabilities to the cache's dtype, as the model
    path does and the Pallas kernel does not: bf16 differs by at most a
    bf16 rounding of each probability, inside 3e-2."""
    rng = np.random.default_rng(1)
    q, k, v = (_np_rand(rng, s) for s in ((b, 1, h, hd), (b, L, kv, hd),
                                          (b, L, kv, hd)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_decode_op(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                         jnp.asarray(pos), ring=ring, block_k=bk,
                         interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    launches = decode_attention.launches
    tpos = torch.tensor(pos, dtype=torch.int32)
    got = decode_attention_op(tq, tk, tv, tpos, ring=ring)
    assert got.dtype == td and got.shape == (b, 1, h, hd)
    assert decode_attention.launches == launches    # CPU: no kernel launch
    _close(got, want, TOL[dtype], TOL[dtype])
    oracle = decode_attention_ref(tq, tk, tv, pos, ring=ring)
    torch.testing.assert_close(got.float(), oracle.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _split_decode(q, k, v, pos: int, nsplit: int):
    """The CUDA decode kernel's algorithm in PyTorch: the cache cut into
    ``nsplit`` contiguous shares; per share the scores and their max m and
    sum l per head (-inf and 0 for a share with no visited slot); the
    shares' (m, l) merged in rank order; each share's probabilities
    rounded to the cache's dtype with the merged (m, l) and multiplied by
    its V; the partial outputs summed in rank order."""
    b, _, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    share = -(-L // nsplit)
    n_valid = 0 if pos < 0 else min(pos + 1, L)
    k_end = n_valid if n_valid > 0 else L
    scores, ms, ls = [], [], []
    for r in range(nsplit):
        lo, hi = r * share, min((r + 1) * share, k_end)
        if lo >= hi:
            scores.append(None)
            ms.append(torch.full(qg.shape[:3], -math.inf))
            ls.append(torch.zeros(qg.shape[:3]))
            continue
        s = torch.einsum("bkgd,bjkd->bkgj", qg, k[:, lo:hi].float()) \
            / math.sqrt(hd)
        if n_valid == 0:
            s = torch.full_like(s, -1e30)
        m = s.amax(-1)
        scores.append(s)
        ms.append(m)
        ls.append(torch.exp(s - m[..., None]).sum(-1))
    m_all = torch.stack(ms).amax(0)
    l_all = torch.zeros_like(m_all)
    for m, l in zip(ms, ls):
        l_all = l_all + l * torch.exp(m - m_all)
    o = torch.zeros(*qg.shape)
    for r, s in enumerate(scores):
        if s is None:
            continue
        p = torch.exp(s - m_all[..., None]) / l_all[..., None]
        vr = v[:, r * share:r * share + s.shape[-1]].float()
        o = o + torch.einsum("bkgj,bjkd->bkgd", p.to(v.dtype).float(), vr)
    return o.reshape(b, 1, h, hd).to(q.dtype)


#: pos on a (2, 24, 8 over 2 kv heads, hd 16) cache: no valid slot, the
#: first, a middle one (8 shares: the last five past it), the last, and a
#: ring cache that has wrapped
SPLIT_POS = [(-1, False), (0, False), (9, False), (23, False), (61, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,ring", SPLIT_POS)
def test_decode_split_matches_plain_and_reference_kernel(dtype, pos, ring):
    """The CUDA kernel's split of the cache over 1, 3 and 8 CTAs, emulated
    in PyTorch, against the plain version (the model path's single
    softmax) and the reference's Pallas kernel in interpret mode: f32 at
    2e-5, bf16 at 3e-2."""
    b, L, h, kv, hd = 2, 24, 8, 2, 16
    rng = np.random.default_rng(3)
    q, k, v = (_np_rand(rng, s) for s in ((b, 1, h, hd), (b, L, kv, hd),
                                          (b, L, kv, hd)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_decode_op(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                         jnp.asarray(pos), ring=ring, block_k=8,
                         interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    plain = decode_attention_plain(tq, tk, tv, torch.tensor(pos))
    for nsplit in (1, 3, 8):
        got = _split_decode(tq, tk, tv, pos, nsplit)
        assert got.dtype == td and got.shape == (b, 1, h, hd)
        torch.testing.assert_close(got.float(), plain.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        _close(got, want, TOL[dtype], TOL[dtype])


@pytest.mark.parametrize("bkv,n_rep", [(12, 16), (192, 1), (1, 16), (40, 4),
                                       (2, 3)])
def test_decode_split_plan_covers_every_cache_length(bkv, n_rep):
    """The decode kernel's launch geometry for every L up to 65536: at
    most 8 CTAs per cluster and no empty one, every slot in a share, no
    more CTAs than SMs once a cache is split, scores spilled exactly when
    a share's do not fit in shared memory.  It takes no ``pos``."""
    assert "pos" not in inspect.signature(split_plan).parameters
    n_sm = 132
    for L in range(1, 65537):
        nsplit, share, spill = split_plan(L, bkv, n_rep, n_sm)
        assert 1 <= nsplit <= SPLIT_MAX
        assert (nsplit - 1) * share < L <= nsplit * share
        assert nsplit == 1 or bkv * nsplit <= n_sm
        assert spill == (4 * n_rep * share > SCORE_SMEM_MAX)
    assert split_plan(40, 12, 16, n_sm) == (8, 5, False)      # glm4-9b
    assert split_plan(40, 192, 1, n_sm) == (1, 40, False)     # zamba2-7b
    assert split_plan(4096, 12, 16, n_sm) == (8, 512, False)
    assert split_plan(32768, 1, 16, n_sm) == (8, 4096, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,h,dk,dv,chunk", GLA_SHAPES)
def test_gla_plain_matches_reference_kernel(dtype, b, L, h, dk, dv, chunk):
    """The plain version against the reference's Pallas scan kernel, with
    the reference test's tolerances: f32 2e-5 (8e-5 for chunks ≥ 64, where
    the float32 accumulation error grows with the chunk's width), bf16
    3e-2; the state at 1e-4 (f32) / 1e-2 (bf16).  And against the
    port's step-recurrence oracle."""
    rng = np.random.default_rng(2)
    q = _np_rand(rng, (b, L, h, dk))
    k = _np_rand(rng, (b, L, h, dk), 0.3)
    v = _np_rand(rng, (b, L, h, dv))
    ld = -np.logaddexp(rng.standard_normal((b, L, h)), 0).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_want, s_want = ref_gla_op(*(jnp.asarray(x).astype(jd)
                                  for x in (q, k, v)), jnp.asarray(ld),
                                chunk=chunk, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    launches = gla_scan.launches
    y, s = gla_scan_op(tq, tk, tv, torch.from_numpy(ld), chunk=chunk)
    assert y.dtype == td and y.shape == (b, L, h, dv)
    assert s.dtype == torch.float32 and s.shape == (b, h, dk, dv)
    assert gla_scan.launches == launches            # CPU: no kernel launch
    atol = TOL[dtype] if dtype == "bfloat16" or chunk < 64 else 8e-5
    s_atol = 1e-2 if dtype == "bfloat16" else 1e-4
    _close(y, y_want, atol, TOL[dtype])
    _close(s, s_want, s_atol, 1e-2)
    y_ref, s_ref = gla_scan_ref(tq, tk, tv, torch.from_numpy(ld))
    torch.testing.assert_close(y.float(), y_ref.float(), atol=atol,
                               rtol=TOL[dtype])
    torch.testing.assert_close(s, s_ref, atol=s_atol, rtol=1e-2)


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
