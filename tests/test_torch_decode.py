"""The port's prefill and decode against the reference's, step by step.

For the reduced glm4-9b (GQA, full cache), zamba2-7b (Mamba2 + attention)
and glm4-9b with an 8-token sliding window (ring cache): the reference's
``init_params`` weights are carried across with ``params_from_jax``, both
packages prefill 16 tokens into a 20-slot cache (bfloat16, the
reference's default) and decode 4 more in float32, as
``tests/models/test_decode_equivalence.py`` does.  Tolerances:

* port vs reference: prefill logits at 1e-4, the model tests' float32
  bound (the two packages sum matmuls in other orders); decode logits at
  1e-3, because a value that the step rounds to bfloat16 (a cached K/V
  element, a probability) can land on the other side of a rounding tie
  in the two packages and then differs by one bfloat16 step, 2^-8 of
  itself (measured: up to 2.7e-4 on the reduced glm4-9b);
* port decode vs the port's own full forward: 5e-3, the bound of the
  reference's decode-equivalence test (the cache holds K/V in bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import RunCtx as JCtx
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import RunCtx, decode_step, forward, prefill

S, T, BATCH = 16, 4, 2
CASES = {"glm4-9b": lambda a: a["glm4-9b"].reduced(),
         "zamba2-7b": lambda a: a["zamba2-7b"].reduced(),
         "glm4-9b+swa8": lambda a: a["glm4-9b"].reduced()
         .with_sliding_window(8)}


def _setup(case):
    jcfg, tcfg = CASES[case](J_ARCHS), CASES[case](T_ARCHS)
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             (BATCH, S + T), dtype=np.int32)
    jctx = JCtx(jcfg, compute_dtype=jnp.float32, ssm_chunk=8, kv_chunk=8)
    tctx = RunCtx(tcfg, compute_dtype=torch.float32, ssm_chunk=8)
    return jcfg, tcfg, jparams, tparams, toks, jctx, tctx


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_match_reference(case):
    jcfg, tcfg, jparams, tparams, toks, jctx, tctx = _setup(case)
    tt = torch.from_numpy(toks)
    full = forward(tcfg, tparams, tt, ctx=tctx).numpy()
    jl, jcache = j_prefill(jcfg, jparams, toks[:, :S], cache_len=S + T,
                           ctx=jctx)
    tl, tcache = prefill(tcfg, tparams, tt[:, :S], cache_len=S + T,
                         ctx=tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert np.abs(tl[:, -1].numpy() - full[:, S - 1]).max() < 5e-3
    if "swa" in case:                 # the ring cache is window-sized
        assert tcache["layers"][0]["k"].shape[1] == 8
    for t in range(T):
        step = toks[:, S + t:S + t + 1]
        jl, jcache = j_decode(jcfg, jparams, jcache, step, ctx=jctx)
        tl, tcache = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(step), ctx=tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0, err_msg=f"step {t}")
        assert np.abs(tl[:, 0].numpy() - full[:, S + t]).max() < 5e-3, t
    assert int(tcache["pos"]) == S + T


@pytest.mark.parametrize("case", ["zamba2-7b", "glm4-9b+swa8"])
def test_decode_from_converted_reference_cache(case):
    """``cache_from_jax`` carries the reference's prefill cache across
    (bfloat16 K/V bit for bit, Mamba2 states, ``pos``); one decode step of
    each package from that same cache gives the same logits."""
    jcfg, tcfg, jparams, tparams, toks, jctx, tctx = _setup(case)
    _, jcache = j_prefill(jcfg, jparams, toks[:, :S], cache_len=S + T,
                          ctx=jctx)
    tcache = cache_from_jax(tcfg, jax.tree.map(np.asarray, jcache),
                            device="cpu")
    _, own = prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]),
                     cache_len=S + T, ctx=tctx)
    assert tcache["pos"].dtype == torch.int32 and int(tcache["pos"]) == S
    for got, mine in zip(tcache["layers"], own["layers"]):
        assert got.keys() == mine.keys()
        for name in got:
            assert got[name].dtype == mine[name].dtype
            torch.testing.assert_close(got[name].float(), mine[name].float(),
                                       atol=1e-2, rtol=1e-2)
    step = toks[:, S:S + 1]
    jl, _ = j_decode(jcfg, jparams, jcache, step, ctx=jctx)
    tl, _ = decode_step(tcfg, tparams, tcache, torch.from_numpy(step),
                        ctx=tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)


def test_float32_cache_decode_matches_forward():
    """With ``cache_dtype=float32`` nothing is rounded to bfloat16, so
    prefill + decode reproduce the full forward to the float32 bound of
    the model tests (1e-4), not the bfloat16 cache's 5e-3."""
    _, tcfg, _, tparams, toks, _, tctx = _setup("zamba2-7b")
    tt = torch.from_numpy(toks)
    full = forward(tcfg, tparams, tt, ctx=tctx).numpy()
    _, cache = prefill(tcfg, tparams, tt[:, :S], cache_len=S + T,
                       cache_dtype=torch.float32, ctx=tctx)
    assert all(c["k"].dtype == torch.float32 for c in cache["layers"]
               if "k" in c)
    for t in range(T):
        lg, cache = decode_step(tcfg, tparams, cache, tt[:, S + t:S + t + 1],
                                ctx=tctx)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S + t],
                                   atol=1e-4, rtol=0)
