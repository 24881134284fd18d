"""The port's offline wave against the reference's, on the reduced glm4-9b.

The reference's ``init_params`` weights are carried across with
``repro_torch.convert.params_from_jax`` so both packages compute the same
function; the port runs its plain PyTorch path on the CPU.  Logits are
held at atol 1e-4 in float32 (measured max |Δ| ≈ 1e-6: the two packages
sum matmuls in different orders); plans are compared exactly."""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import ARCHS as J_ARCHS
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models.layers import blockwise_attention as j_attention
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.layers import rope as j_rope
from repro.serving import CoInferenceServer as JServer
from repro.serving import Request as JRequest
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import forward as t_forward
from repro_torch.models import init_params as t_init
from repro_torch.models.layers import blockwise_attention, rms_norm, rope
from repro_torch.serving import CoInferenceServer, Request

CPU = "cpu"
USERS, SEQ, SEED = 6, 32, 0


@pytest.fixture(scope="module")
def wave():
    """Both packages' offline wave on the reduced glm4-9b, same weights,
    fleet and tokens as ``serve.py``'s defaults."""
    jcfg = J_ARCHS["glm4-9b"].reduced()
    tcfg = T_ARCHS["glm4-9b"].reduced()
    jparams = j_init(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device=CPU)
    jp = J.profile_from_arch(jcfg, seq=SEQ)
    je = J.make_edge_profile(jp)
    jf = J.make_fleet(USERS, jp, je, beta=(2.0, 8.0), seed=SEED)
    tp = T.profile_from_arch(tcfg, seq=SEQ)
    te = T.make_edge_profile(tp)
    tf = T.make_fleet(USERS, tp, te, beta=(2.0, 8.0), seed=SEED)
    rng = np.random.default_rng(SEED)
    toks = [rng.integers(0, tcfg.vocab_size, SEQ, dtype=np.int32)
            for _ in range(USERS)]
    jreport = JServer(jcfg, jparams, jp, jf, je).serve(
        [JRequest(m, toks[m], float(jf.deadline[m])) for m in range(USERS)])
    tserver = CoInferenceServer(tcfg, tparams, tp, tf, te, device=CPU)
    treqs = [Request(m, toks[m], float(tf.deadline[m]))
             for m in range(USERS)]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jreport=jreport, treport=tserver.serve(treqs),
                tserver=tserver, treqs=treqs, toks=toks)


def test_serve_plan_matches_reference(wave):
    a, b = wave["jreport"], wave["treport"]
    assert a.energy == b.energy
    assert a.batch_sizes == b.batch_sizes
    assert a.partitions == b.partitions
    assert a.t_free_end == b.t_free_end
    assert [g.tolist() for g in a.groups] == [g.tolist() for g in b.groups]
    np.testing.assert_array_equal(a.per_user_energy, b.per_user_energy)


def test_serve_logits_match_reference(wave):
    got, want = wave["treport"].logits, wave["jreport"].logits
    assert got.shape == want.shape == (USERS, SEQ, wave["tcfg"].vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_coinference_equals_monolithic(wave):
    err = tserve.verify(wave["treport"].logits, wave["tserver"].executor,
                        wave["treqs"])
    assert err < 1e-3


def test_forward_matches_reference(wave):
    toks = np.stack(wave["toks"][:2])
    want, _ = j_forward(wave["jcfg"], wave["jparams"], toks)
    got = t_forward(wave["tcfg"], wave["tparams"], torch.as_tensor(toks))
    # the reference's default RunCtx computes in bfloat16, so does the port
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_layers_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_rms_norm(x, scale)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6).numpy(),
        np.asarray(j_rope(x, pos, 1e6)), atol=1e-5, rtol=1e-5)
    for window in (None, 5):
        np.testing.assert_allclose(
            blockwise_attention(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                window=window).numpy(),
            np.asarray(j_attention(x, k, v, causal=True, window=window,
                                   chunk=8)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("flags", [[], ["--rate", "5", "--occupancy",
                                         "interleaved", "--channel", "shared"]],
                         ids=["default", "online-only-flags"])
def test_cli_default_serves_on_cpu(flags):
    """The default offline wave; options that only the online and tenancy
    paths read are accepted and leave the offline wave as it is."""
    out = tserve.main(["--device", "cpu", *flags])
    assert out["err"] < 1e-3 and out["energy"] < out["lc"]


def test_init_params_is_seeded():
    cfg = T_ARCHS["glm4-9b"].reduced()
    a, b = t_init(cfg, seed=3, device=CPU), t_init(cfg, seed=3, device=CPU)
    c = t_init(cfg, seed=4, device=CPU)
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    assert not torch.equal(a["layers"][1]["wq"], c["layers"][1]["wq"])
    assert len(a["layers"]) == cfg.num_layers
    assert a["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size)
    assert float(a["embed"]["w"].std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("flag", [["--online"], ["--tenants", "2"],
                                  ["--planner", "pareto"],
                                  ["--dp-backend", "fused"],
                                  ["--cohort-size", "4"],
                                  ["--beam-width", "auto"],
                                  ["--trace", "t.json"],
                                  ["--metrics-json", "m.json"]])
def test_cli_unported_options_name_their_roadmap_item(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        tserve.main(["--device", "cpu", *flag])
