"""The port's Mamba2 pieces against the reference's ``repro.models.ssm``.

The same numpy inputs (fixed seeds) go through both packages; the port
runs its plain PyTorch path on the CPU.  Everything is float32, so the
tolerances are those of float32 sums taken in other orders: 2e-5 for the
scan against ``gla_chunked`` (the reference kernel tests' bound); 1e-4 for
the mixer's outputs and states, which are of order 1 and come out of
256-wide projections of inputs up to 40 (the model tests' logit bound).
The conv and softplus are elementwise and held bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.kernels.gla_scan import gla_scan_plain
from repro_torch.models import ssm as tssm


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _gla_inputs(seed, b, L, h, dk, dv):
    rng = np.random.default_rng(seed)
    q, k = _rand(rng, (b, L, h, dk)), _rand(rng, (b, L, h, dk), 0.3)
    v = _rand(rng, (b, L, h, dv))
    ld = -np.logaddexp(rng.standard_normal((b, L, h)), 0).astype(np.float32)
    s0 = _rand(rng, (b, h, dk, dv), 0.5)
    return q, k, v, ld, s0


@pytest.mark.parametrize("b,L,h,dk,dv,chunk,with_state", [
    (2, 37, 3, 16, 16, 16, False),         # ragged: 2 chunks + 5 steps
    (1, 37, 2, 8, 24, 16, True),           # ragged, Dk != Dv, from a state
    (2, 32, 4, 16, 32, 16, True),          # the reduced zamba2's scan
    (1, 5, 2, 16, 16, 256, True),          # shorter than one chunk
])
def test_gla_chunked_matches_reference(b, L, h, dk, dv, chunk, with_state):
    """The port's ``gla_chunked`` (the scan kernel's entry point) against
    the reference's, including what the Pallas kernel cannot take: L not
    a multiple of the chunk, and a non-zero initial state."""
    q, k, v, ld, s0 = _gla_inputs(3, b, L, h, dk, dv)
    s_in = s0 if with_state else None
    y_want, s_want = jssm.gla_chunked(q, k, v, ld, chunk=chunk,
                                      state_in=s_in)
    t = torch.from_numpy
    y, s = tssm.gla_chunked(t(q), t(k), t(v), t(ld), chunk=chunk,
                            state_in=None if s_in is None else t(s_in))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), atol=2e-5,
                               rtol=2e-5)
    # the step recurrence agrees too, and the plain scan is what ran
    y_ref, s_ref = tssm.gla_reference(t(q), t(k), t(v), t(ld),
                                      None if s_in is None else t(s_in))
    torch.testing.assert_close(y, y_ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(s, s_ref, atol=2e-5, rtol=2e-5)
    y_plain, _ = gla_scan_plain(t(q), t(k), t(v), t(ld), chunk=chunk,
                                state_in=None if s_in is None else t(s_in))
    assert torch.equal(y, y_plain)


def _mamba_params(cfg, rng):
    d, di = cfg.d_model, cfg.ssm_d_inner
    G, N, H = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    return {"in_proj": _rand(rng, (d, 2 * di + 2 * G * N + H), 0.05),
            "conv_w": _rand(rng, (cfg.ssm_conv, di + 2 * G * N), 0.2),
            "dt_bias": _rand(rng, (H,), 0.5),
            "A_log": np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
            "D": np.ones(H, np.float32) + _rand(rng, (H,), 0.1),
            "norm": np.ones(di, np.float32) + _rand(rng, (di,), 0.1),
            "out_proj": _rand(rng, (di, d), 0.05)}


def _close_state(got, want):
    for name in ("conv", "ssd"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("L,chunk", [(24, 8), (21, 16)])
def test_mamba2_mix_matches_reference(L, chunk):
    """The mixer over a sequence from a non-zero state, then one step, on
    the reduced zamba2-7b's widths (grouped B/C repeated over heads,
    softplus with no cut-over, conv taps summed from tap 0)."""
    jcfg = J_ARCHS["zamba2-7b"].reduced()
    tcfg = T_ARCHS["zamba2-7b"].reduced()
    rng = np.random.default_rng(4)
    p = _mamba_params(tcfg, rng)
    # large dt pre-activations reach softplus's linear range (x > 20)
    x = _rand(rng, (2, L + 1, tcfg.d_model))
    x[:, :, 0] *= 40.0
    st = tssm.mamba2_init_state(tcfg, 2)
    st = {n: _rand(rng, tuple(a.shape), 0.3) for n, a in st.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    t_st = {n: torch.from_numpy(a) for n, a in st.items()}
    y_want, s_want = jssm.mamba2_mix(p, x[:, :L], jcfg,
                                     compute_dtype=jnp.float32, chunk=chunk,
                                     state=st)
    y, s = tssm.mamba2_mix(tp, torch.from_numpy(x[:, :L]), tcfg,
                           compute_dtype=torch.float32, chunk=chunk,
                           state=t_st)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4,
                               rtol=1e-4)
    _close_state(s, s_want)
    y1_want, s1_want = jssm.mamba2_mix(p, x[:, L:], jcfg,
                                       compute_dtype=jnp.float32,
                                       state=s_want, step=True)
    y1, s1 = tssm.mamba2_mix(tp, torch.from_numpy(x[:, L:]), tcfg,
                             compute_dtype=torch.float32, state=s,
                             step=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y1_want), atol=1e-4,
                               rtol=1e-4)
    _close_state(s1, s1_want)


def test_softplus_and_conv_match_reference():
    """The two traps of the port: softplus keeps log(1 + eˣ) above 20 (no
    linear cut-over), and the conv sums its taps from tap 0, in order."""
    import jax
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(
        tssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(x)))
    rng = np.random.default_rng(5)
    xc, w = _rand(rng, (2, 9, 12)), _rand(rng, (4, 12), 0.2)
    state = _rand(rng, (2, 3, 12))
    for s in (None, state):
        want, want_state = jssm._causal_conv(xc, w, s)
        got, got_state = tssm._causal_conv(
            torch.from_numpy(xc), torch.from_numpy(w),
            None if s is None else torch.from_numpy(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_state.numpy(),
                                      np.asarray(want_state))
