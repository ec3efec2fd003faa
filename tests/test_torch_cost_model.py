"""The port's cost model and path solver == the reference's (DESIGN.md §15).

Held exactly, on the same nets, modes and batches as the reference's
tests/test_cost_model.py: ``model_cost`` of the port == the port's live
ledger == the reference's ledger, byte for byte (online and offline); the
solver's path labels and ``engine`` stamps == the reference's under no
deployment and under ``local`` / ``lan`` / ``wan`` (the reference's
compute figure passed in); the attention closed forms == the reference's
values; the kernel requests == the launches a meta run makes.  The
CifarNet cells live in test_torch_cost_model_cifar.py.
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import cost_model as jcost
from repro.core import secure_model as jsm
from repro.core.linear import set_fused_rounds as j_set_fused
from repro_torch.core import cost_model, linear, prf, secure_model
from repro_torch.core.ring import RING32
from repro_torch.nn import bnn

torch.set_num_threads(1)

MODES = [
    {"weights": "shared", "binary_linear": "auto"},
    {"weights": "shared", "binary_linear": "generic"},
    {"weights": "shared", "binary_linear": "off"},
    {"weights": "public"},
]
MODE_IDS = ["auto", "generic", "off", "public"]
# the reference's nominal compute figure, for solver parity
REF_INT8_OPS = 394e12


@functools.lru_cache(maxsize=None)
def _np_params(net):
    return {k: v.numpy() for k, v in bnn.init_bnn(0, net).items()}


def _kw(i):
    return dict(MODES[i])


@functools.lru_cache(maxsize=None)
def port_model(net, mode):
    params = {k: torch.from_numpy(v) for k, v in _np_params(net).items()}
    return secure_model.compile_secure(params, net, prf.PRNGKey(1), RING32,
                                       device="cpu", **_kw(mode))


@functools.lru_cache(maxsize=None)
def ref_model(net, mode):
    return jsm.compile_secure(_np_params(net), net, jax.random.PRNGKey(1),
                              JRING, **_kw(mode))


def _totals(led):
    return (led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes)


def assert_exact(net, mode, shape):
    """Predicted == port ledger == reference ledger, byte for byte."""
    pm, jm = port_model(net, mode), ref_model(net, mode)
    led = secure_model.secure_infer_cost(pm, shape)
    jled = jsm.secure_infer_cost(jm, shape)
    rep = cost_model.model_cost(pm, shape)
    pred = (rep.rounds, rep.nbytes, rep.pre_rounds, rep.pre_nbytes)
    assert pred == _totals(led) == _totals(jled), (net, mode, shape)
    assert {k: list(v) for k, v in led.by_tag.items()} == \
        {k: list(v) for k, v in jled.by_tag.items()}
    jrep = jcost.model_cost(jm, shape)
    assert [(e.name, str(e.path), e.cost.as_dict()) for e in rep.entries] \
        == [(e.name, str(e.path), e.cost.as_dict()) for e in jrep.entries]
    return rep


def _labels(model):
    return [(op["path"], op.get("engine")) for op in model.ops
            if op["op"] in ("conv", "sepconv", "fc")]


def _restamped(model, annotate, dep):
    """Labels and engines after re-solving a shallow copy of ``model``."""
    m = dataclasses.replace(model, ops=[dict(op) for op in model.ops])
    annotate(m, deployment=dep)
    return _labels(m)


def assert_labels_match(net, mode):
    """The solver's labels and engines == the reference's, under no
    deployment and each registry deployment at batch 1 and 32."""
    pm, jm = port_model(net, mode), ref_model(net, mode)
    assert _labels(pm) == _labels(jm)
    for name in ("local", "lan", "wan"):
        for batch in (1, 32):
            pdep = dataclasses.replace(
                cost_model.DEPLOYMENTS[name],
                compute_int8_ops=REF_INT8_OPS).with_batch(batch)
            jdep = jcost.DEPLOYMENTS[name].with_batch(batch)
            assert _restamped(pm, cost_model.annotate_model, pdep) == \
                _restamped(jm, jcost.annotate_model, jdep), (name, batch)


@pytest.mark.parametrize("mode", range(4), ids=MODE_IDS)
@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
def test_ledger_fidelity(net, mode):
    assert_exact(net, mode, (1,) + bnn.INPUT_SHAPES[net])


def test_ledger_fidelity_batch_scaling():
    shape = bnn.INPUT_SHAPES["MnistNet1"]
    rep1 = assert_exact("MnistNet1", 0, (1,) + shape)
    rep4 = assert_exact("MnistNet1", 0, (4,) + shape)
    assert rep4.nbytes == 4 * rep1.nbytes and rep4.rounds == rep1.rounds
    assert_exact("MnistNet1", 0, (32,) + shape)


@pytest.mark.parametrize("mode", [0, 3], ids=["auto", "public"])
def test_ledger_fidelity_unfused(mode):
    linear.set_fused_rounds(False)
    j_set_fused(False)
    try:
        assert_exact("MnistNet3-sep", mode,
                     (1,) + bnn.INPUT_SHAPES["MnistNet3-sep"])
    finally:
        linear.set_fused_rounds(True)
        j_set_fused(True)


@pytest.mark.parametrize("mode", range(4), ids=MODE_IDS)
@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
def test_solver_labels_match_reference(net, mode):
    assert_labels_match(net, mode)


def test_deployment_registry():
    assert set(cost_model.DEPLOYMENTS) == {"local", "lan", "wan"}
    assert cost_model.resolve_deployment(None) is None
    assert cost_model.resolve_deployment("WAN") is cost_model.WAN
    assert cost_model.resolve_deployment(cost_model.LAN) is cost_model.LAN
    b = cost_model.LAN.with_batch(32)
    assert b.batch == 32 and b.network is cost_model.LAN.network
    with pytest.raises(ValueError, match="lan, local, wan"):
        cost_model.resolve_deployment("mars")
    # the card's dense int8 peak, not the reference's nominal TPU figure
    assert cost_model.LAN.compute_int8_ops == cost_model.H100_INT8_OPS \
        == 1.979e15
    assert jcost.LAN.compute_int8_ops == REF_INT8_OPS


def test_cost_time_weighting():
    c = cost_model.Cost(rounds=6, nbytes=10_000, flops=10**9)
    assert c.time(cost_model.WAN) > c.time(cost_model.LAN)
    assert c.time(cost_model.LOCAL) == pytest.approx(
        10**9 / cost_model.LOCAL.compute_int8_ops)
    jc = jcost.Cost(rounds=6, nbytes=10_000, flops=10**9)
    for name in ("local", "lan", "wan"):
        dep = dataclasses.replace(cost_model.DEPLOYMENTS[name],
                                  compute_int8_ops=REF_INT8_OPS)
        assert c.time(dep) == jc.time(jcost.DEPLOYMENTS[name])


def test_compile_with_deployment_keeps_labels_and_ledger():
    """``compile_secure(deployment=...)`` stamps the same labels as the
    default compile, its prediction rides on the model and equals the
    live ledger at the deployment's batch."""
    params = {k: torch.from_numpy(v)
              for k, v in _np_params("MnistNet1").items()}
    legacy = _labels(port_model("MnistNet1", 0))
    shape = bnn.INPUT_SHAPES["MnistNet1"]
    for name in ("local", "lan", "wan"):
        dep = cost_model.DEPLOYMENTS[name].with_batch(8)
        m = secure_model.compile_secure(params, "MnistNet1", prf.PRNGKey(1),
                                        RING32, device="cpu", deployment=dep)
        assert m.deployment == name and _labels(m) == legacy
        rep = m.predicted
        assert isinstance(rep, cost_model.CostReport)
        led = secure_model.secure_infer_cost(m, (8,) + shape)
        assert (rep.rounds, rep.nbytes, rep.pre_rounds, rep.pre_nbytes) \
            == _totals(led)
        for op in m.ops:
            if op["op"] in ("conv", "sepconv", "fc"):
                assert op["cost"]["path"] == str(op["path"])
                assert "alternatives" in op["cost"]


def test_engine_override_steers_executor():
    """A per-op ``engine`` stamp overrides the model-wide routing: the
    generic Alg-2 route replaces the bin-shared reshare (same totals,
    other tags), as in the reference."""
    m = port_model("MnistNet1", 0)
    m = dataclasses.replace(m, ops=[dict(op) for op in m.ops])
    idx = next(i for i, op in enumerate(m.ops)
               if op["op"] == "fc" and op["path"] == "bin-shared")
    shape = (1,) + bnn.INPUT_SHAPES["MnistNet1"]
    led = secure_model.secure_infer_cost(m, shape)
    assert f"l{idx}.fc.bin" in led.by_tag
    m.ops[idx]["engine"] = False
    led2 = secure_model.secure_infer_cost(m, shape)
    assert f"l{idx}.fc" in led2.by_tag and f"l{idx}.fc.bin" not in led2.by_tag
    assert _totals(led2) == _totals(led)


def _launches(model, shape):
    """(family, m, k, n, n_limbs, channels) of every wrapper call of a
    meta run, in call order."""
    import repro_torch.kernels.ops as kops
    calls = []
    wrappers = {"rss_matmul": "rss_matmul_parts",
                "grouped_rss_matmul": "grouped_rss_matmul_parts",
                "bin_rss_matmul": "bin_rss_matmul_parts",
                "bin_grouped_matmul": "bin_grouped_matmul_parts"}
    saved = {f: getattr(kops, fn) for f, fn in wrappers.items()}

    def recorder(family):
        def rec(x, w, *a, **kw):
            grouped = "grouped" in family
            m, k = (x.shape[2], x.shape[3]) if grouped else x.shape[1:]
            calls.append((family, m, k, w.n,
                          w.n_limbs if family.startswith("bin_") else 4,
                          x.shape[1] if grouped else None))
            return saved[family](x, w, *a, **kw)
        return rec

    for f, fn in wrappers.items():
        setattr(kops, fn, recorder(f))
    try:
        secure_model.secure_infer_cost(model, shape)
    finally:
        for f, fn in wrappers.items():
            setattr(kops, fn, saved[f])
    return calls


@pytest.mark.parametrize("mode", range(4), ids=MODE_IDS)
@pytest.mark.parametrize("net,batch", [("MnistNet1", 1), ("MnistNet1", 8),
                                       ("MnistNet3-sep", 2)])
def test_kernel_requests_are_the_launches(net, batch, mode):
    """Every launch the port makes, at every size (the reference drops
    those with a dimension < 8: its dispatchers send them to XLA)."""
    m = port_model(net, mode)
    shape = (batch,) + bnn.INPUT_SHAPES[net]
    reqs = cost_model.model_cost(m, shape).kernel_requests()
    assert reqs == _launches(m, shape)


def test_kernel_requests_shapes():
    m = port_model("MnistNet1", 0)
    reqs = cost_model.model_cost(
        m, (8,) + bnn.INPUT_SHAPES["MnistNet1"]).kernel_requests()
    assert reqs == [("rss_matmul", 8, 784, 128, 4, None),
                    ("rss_matmul", 8, 128, 128, 4, None),
                    ("rss_matmul", 8, 128, 10, 4, None)]
    jreqs = jcost.model_cost(ref_model("MnistNet1", 0),
                             (8,) + bnn.INPUT_SHAPES["MnistNet1"])
    assert reqs == jreqs.kernel_requests()


def test_report_properties():
    rep = cost_model.model_cost(port_model("MnistNet3-sep", 3),
                                (1,) + bnn.INPUT_SHAPES["MnistNet3-sep"])
    assert rep.total.rounds == sum(e.cost.rounds for e in rep.entries)
    assert rep.total.nbytes == sum(e.cost.nbytes for e in rep.entries)
    assert rep.entries[-1].name == "output" and rep.pre_nbytes > 0
    assert rep.flops == sum(e.cost.flops for e in rep.entries
                            if e.name.startswith("l"))
    d = cost_model.LAN
    assert rep.time(d) == pytest.approx(
        d.network.time(rep.rounds, rep.nbytes) + rep.flops
        / d.compute_int8_ops)
    assert rep.within_offline_budget(cost_model.LAN.with_batch(1)) is None
    tight = cost_model.DeploymentDescriptor("t", cost_model.LAN.network,
                                            offline_budget_mb=1e-9)
    assert rep.within_offline_budget(tight) is False


# ---------------------------------------------------------------------------
# The attention closed forms (DESIGN.md §16) == the reference's values on
# the grid of its tests (tests/test_cost_model.py:214-260)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("customized", [True, False],
                         ids=["custom", "softmax"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "paper"])
@pytest.mark.parametrize("seq", [8, 16, 32])
def test_lm_block_cost_equals_reference(seq, fused, customized):
    args = (seq, seq, 32, 2, 64)
    kw = dict(fused=fused, customized=customized)
    assert cost_model.lm_block_cost(*args, **kw).as_dict() == \
        jcost.lm_block_cost(*args, **kw).as_dict()
    for q, kv in ((1, seq), (seq, 2 * seq)):
        for static in (False, True):
            assert cost_model.lm_block_cost(
                q, kv, 32, 2, 64, static_norm=static, **kw).as_dict() == \
                jcost.lm_block_cost(q, kv, 32, 2, 64, static_norm=static,
                                    **kw).as_dict()


@pytest.mark.parametrize("static_norm", [False, True],
                         ids=["rmsnorm", "staticnorm"])
@pytest.mark.parametrize("customized", [True, False],
                         ids=["custom", "softmax"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "paper"])
def test_lm_step_cost_equals_reference(fused, customized, static_norm):
    kw = dict(fused=fused, customized=customized, static_norm=static_norm)
    for bucket in (8, 16, 32):
        assert cost_model.lm_step_cost(bucket, 32, 2, 64, 2, 32,
                                       **kw).as_dict() == \
            jcost.lm_step_cost(bucket, 32, 2, 64, 2, 32, **kw).as_dict()


# ---------------------------------------------------------------------------
# lm_step_cost == the port's own live ledger of one secure_decode_step, over
# the reference's grid (tests/test_cost_model.py:229-258, with the bucket
# swept as its block test sweeps seq), and the published comm a token
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_lm():
    from repro_torch.core import secure_transformer as st
    lm, _ = st.share_lm_params(prf.PRNGKey(0), 32, 32, 2, 64, 2, RING32,
                               device="cpu")
    return lm


def _port_step_ledger(bucket, customized, static_norm):
    from repro_torch.core import comm
    from repro_torch.core import secure_transformer as st
    return comm.estimate_cost(
        lambda m, c: st.secure_decode_step(
            m, c, 0, 0, prf.split(prf.PRNGKey(7), 3), customized,
            static_norm), _port_lm(),
        st.init_kv_cache(2, 2, 16, bucket, RING32, device="cpu"))


@pytest.mark.parametrize("static_norm", [False, True],
                         ids=["rmsnorm", "staticnorm"])
@pytest.mark.parametrize("customized", [True, False],
                         ids=["custom", "softmax"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "paper"])
@pytest.mark.parametrize("seq", [8, 16, 32])
def test_lm_step_cost_equals_port_ledger(seq, fused, customized,
                                         static_norm):
    linear.set_fused_rounds(fused)
    try:
        led = _port_step_ledger(seq, customized, static_norm)
    finally:
        linear.set_fused_rounds(True)
    pred = cost_model.lm_step_cost(seq, 32, 2, 64, 2, 32, fused=fused,
                                   customized=customized,
                                   static_norm=static_norm)
    assert (pred.rounds, pred.nbytes) == (led.rounds, led.nbytes), \
        (seq, fused, customized, static_norm, pred, led.summary())


def test_lm_comm_per_token_equals_published():
    """BENCH_secure_e2e.json's secure.lm.comm rows, at
    benchmarks/secure_lm.py's configuration (d 32, 2 heads, d_ff 64, 2
    blocks, vocab 32, bucket 16, the default RMSNorm path)."""
    import json
    from pathlib import Path
    bench = json.loads((Path(__file__).resolve().parent.parent
                        / "BENCH_secure_e2e.json").read_text())
    for tag, customized in (("custom", True), ("softmax", False)):
        led = _port_step_ledger(16, customized, False)
        assert led.nbytes / 1e3 == \
            bench[f"secure.lm.comm.{tag}.kb_per_token"], tag
    assert (bench["secure.lm.comm.custom.kb_per_token"],
            bench["secure.lm.comm.softmax.kb_per_token"]) == (39.276, 52.572)


def test_primitive_closed_forms_equal_reference():
    """Every closed form of the attention table, both round structures
    and both ring widths, with the defaults taken from the process
    toggle in each package."""
    for fused in (True, False):
        for nb in (4, 8):
            for fn, args in (("trunc_cost", (37,)), ("reveal_cost", (37,)),
                             ("mul_trunc_cost", (37,)),
                             ("relu_cost", (37,)),
                             ("relu_attention_cost", (37,)),
                             ("exp_cost", (37,)),
                             ("reciprocal_cost", (37,)),
                             ("rsqrt_cost", (37,)),
                             ("rmsnorm_cost", (96, 32)),
                             ("max_lastdim_cost", (3, 7)),
                             ("softmax_cost", (3, 7))):
                kw = {"nb": nb}
                if fn not in ("trunc_cost", "reveal_cost"):
                    kw["fused"] = fused
                assert getattr(cost_model, fn)(*args, **kw).as_dict() == \
                    getattr(jcost, fn)(*args, **kw).as_dict(), (fn, fused)


def test_lm_cost_scaling():
    kw = dict(d=32, heads=2, d_ff=64, n_blocks=2, vocab=32)
    r8 = cost_model.lm_step_cost(8, **kw, customized=True)
    r32 = cost_model.lm_step_cost(32, **kw, customized=True)
    assert r8.rounds == r32.rounds and r32.nbytes > r8.nbytes
    s8 = cost_model.lm_step_cost(8, **kw, customized=False)
    s32 = cost_model.lm_step_cost(32, **kw, customized=False)
    assert s32.rounds > s8.rounds
    assert r8.rounds < s8.rounds and r8.nbytes < s8.nbytes
