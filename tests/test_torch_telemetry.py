"""The port's observability layer (DESIGN.md §17) held to the reference's
contracts (tests/test_telemetry.py): disabled mode is a no-op, ``tracing``
restores state on an exception, emitted traces pass the Chrome
trace-event schema (the ported validator and the reference's accept each
other's traces), the party-lane fan-out, the metrics and their Prometheus
text, attribution bytes summing exactly to the ledger with rows equal to
the reference's ``attribution`` on the same model and ledger, and logits
bit-identical with telemetry on.  The port fires its listeners and
movement hooks on every query (the reference at trace time), which the
per-query cases pin; the CUDA-event spans are held on the card in
test_torch_cuda.py."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import cost_model as jcost
from repro.core import secure_model as jsm
from repro.core import telemetry as jtelemetry
from repro_torch.core import comm, cost_model, prf, telemetry
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, share
from repro_torch.core.secure_model import (compile_secure, secure_infer,
                                           secure_infer_cost)
from repro_torch.launch import serve_secure
from repro_torch.nn.bnn import INPUT_SHAPES, init_bnn

torch.set_num_threads(1)
REF_INT8_OPS = 394e12   # the reference's nominal compute figure


def _model(net, **kw):
    return compile_secure(init_bnn(0, net), net, prf.PRNGKey(1), RING32,
                          device="cpu", **kw)


# ---------------------------------------------------------------------------
# Disabled-mode cost contract
# ---------------------------------------------------------------------------

def test_disabled_mode_is_noop():
    assert telemetry.tracer() is None and telemetry.metrics() is None
    assert not telemetry.enabled()
    # module-level span returns the SHARED null context: no allocation
    a, b = telemetry.span("x"), telemetry.span("y", cat="compile")
    assert a is b is telemetry._NULL
    with a as s:
        assert s is None
    # metric hooks are silent no-ops
    telemetry.inc("c")
    telemetry.gauge("g", 1.0)
    telemetry.observe("h", 0.5)
    telemetry.movement("complete", "local")


def test_tracing_none_is_noop():
    with telemetry.tracing(None) as t:
        assert t is None and telemetry.tracer() is None
    with telemetry.collecting(None) as r:
        assert r is None and telemetry.metrics() is None


def test_tracing_restores_on_exception():
    t = telemetry.Tracer()
    with pytest.raises(RuntimeError, match="escape"):
        with telemetry.tracing(t):
            assert telemetry.tracer() is t
            assert t.on_comm in comm._LISTENERS
            raise RuntimeError("escape")
    assert telemetry.tracer() is None
    assert t.on_comm not in comm._LISTENERS


# ---------------------------------------------------------------------------
# Tracer: spans, comm correlation, Chrome trace schema
# ---------------------------------------------------------------------------

def test_emitted_trace_is_schema_valid(tmp_path):
    t = telemetry.Tracer(parties=3)
    with telemetry.tracing(t):
        with telemetry.span("compile", cat="compile"):
            comm.record("l0.fc", 1, 128)
            comm.record("sign1.msb", 2, 64, preprocess=True)
        with telemetry.span("query[0]", cat="online", lane="parties"):
            with telemetry.span("inner", cat="online"):
                pass
        t.instant("abort", cat="verify", party=2)
    path = tmp_path / "trace.json"
    t.write(str(path))
    trace = json.loads(path.read_text())
    telemetry.validate_chrome_trace(trace)   # must not raise
    ev = trace["traceEvents"]
    names = {e["name"] for e in ev}
    assert {"process_name", "thread_name", "compile", "query[0]",
            "l0.fc", "pre:sign1.msb", "abort"} <= names
    # the compile span carries the correlated comm totals
    compile_ev = next(e for e in ev if e["name"] == "compile")
    assert compile_ev["args"]["rounds"] == 1
    assert compile_ev["args"]["wire_bytes"] == 128
    assert compile_ev["args"]["pre_rounds"] == 2
    assert compile_ev["args"]["pre_wire_bytes"] == 64
    assert compile_ev["args"]["comm_ops"] == 2


def test_party_lane_fanout():
    t = telemetry.Tracer(parties=3)
    with t.span("q", cat="online", lane="parties"):
        pass
    with t.span("host", cat="setup"):
        pass
    ev = t.chrome_trace()["traceEvents"]
    lanes = {e["args"]["name"]: e["tid"] for e in ev
             if e["name"] == "thread_name"}
    assert {"main", "party0", "party1", "party2"} <= set(lanes)
    q_tids = sorted(e["tid"] for e in ev if e["name"] == "q")
    # one complete event per party lane, same measured interval
    assert q_tids == sorted(lanes[f"party{p}"] for p in range(3))
    (host,) = [e for e in ev if e["name"] == "host"]
    assert host["tid"] == lanes["main"]


def test_comm_instants_attribute_to_innermost_open_span():
    t = telemetry.Tracer()
    with telemetry.tracing(t):
        with telemetry.span("outer", cat="online"):
            with telemetry.span("inner", cat="online"):
                comm.record("x", 1, 10)
    inner = next(s for s in t.spans if s.name == "inner")
    outer = next(s for s in t.spans if s.name == "outer")
    assert inner.args.get("wire_bytes") == 10
    assert "wire_bytes" not in outer.args


def test_phase_seconds_counts_nested_same_category_once():
    fake = iter([0.0,                     # tracer t0
                 1.0, 2.0, 3.0,          # outer open, inner open/close
                 4.0, 5.0, 6.0]).__next__   # sub open/close, outer close
    t = telemetry.Tracer(clock=fake)
    with t.span("outer", cat="online"):        # 1.0 .. 6.0
        with t.span("inner", cat="online"):    # 2.0 .. 3.0 (nested: skip)
            pass
        with t.span("sub", cat="verify"):      # 4.0 .. 5.0
            pass
    ph = t.phase_seconds()
    assert ph["online"] == pytest.approx(5.0)   # outer only, inner nested
    assert ph["verify"] == pytest.approx(1.0)   # different category counts


@pytest.mark.parametrize("mutate, err", [
    (lambda tr: tr.pop("traceEvents"), "traceEvents"),
    (lambda tr: tr["traceEvents"].append({"ph": "X", "name": "x",
                                          "pid": 0, "tid": 0, "ts": 1.0}),
     "dur"),
    (lambda tr: tr["traceEvents"].append({"ph": "Q", "name": "x",
                                          "pid": 0, "tid": 0, "ts": 0}),
     "phase"),
    (lambda tr: tr["traceEvents"].append({"ph": "i", "pid": 0, "tid": 0,
                                          "ts": 0}), "name"),
    (lambda tr: tr["traceEvents"].append({"ph": "i", "name": "x",
                                          "pid": "0", "tid": 0, "ts": 0}),
     "pid"),
    (lambda tr: tr["traceEvents"].append({"ph": "i", "name": "x", "pid": 0,
                                          "tid": 0, "ts": -5}), "ts"),
])
def test_validator_rejects_malformed(mutate, err):
    t = telemetry.Tracer()
    with t.span("ok"):
        pass
    trace = t.chrome_trace()
    mutate(trace)
    with pytest.raises(ValueError, match=err):
        telemetry.validate_chrome_trace(trace)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_metrics_counters_gauges_histograms():
    r = telemetry.MetricsRegistry()
    r.inc("comm_bytes_total", 100, tag="l0.fc")
    r.inc("comm_bytes_total", 50, tag="l0.fc")
    r.inc("comm_bytes_total", 7, tag="sign1.msb")
    r.gauge("pool_supply", 5)
    r.gauge("pool_supply", 3)             # gauges overwrite
    for v in range(1, 101):
        r.observe("query_latency_seconds", v / 100.0)
    d = r.as_dict()
    assert d["counters"]['comm_bytes_total{tag="l0.fc"}'] == 150
    assert d["gauges"]["pool_supply"] == 3
    h = d["histograms"]["query_latency_seconds"]
    assert h["count"] == 100 and h["min"] == 0.01 and h["max"] == 1.0
    assert h["p50"] == pytest.approx(0.505, abs=1e-9)
    assert h["p95"] == pytest.approx(0.9505, abs=1e-9)
    assert h["p99"] == pytest.approx(0.9901, abs=1e-9)


def test_prometheus_text_format():
    r = telemetry.MetricsRegistry()
    r.inc("comm_rounds_total", 6, tag="l0.fc", phase="online")
    r.observe("query_latency_seconds", 0.25)
    txt = r.prometheus()
    assert "# TYPE cbnn_comm_rounds_total counter" in txt
    # labels render sorted and quoted
    assert 'cbnn_comm_rounds_total{phase="online",tag="l0.fc"} 6.0' in txt
    assert "# TYPE cbnn_query_latency_seconds summary" in txt
    assert 'cbnn_query_latency_seconds{quantile="0.5"} 0.25' in txt
    assert "cbnn_query_latency_seconds_count 1" in txt
    assert txt.endswith("\n")


def test_metrics_write_files(tmp_path):
    r = telemetry.MetricsRegistry()
    r.inc("c", 1)
    r.write_json(str(tmp_path / "m.json"))
    r.write_prom(str(tmp_path / "m.prom"))
    assert json.loads((tmp_path / "m.json").read_text())["counters"]["c"] == 1
    assert "cbnn_c 1.0" in (tmp_path / "m.prom").read_text()


def test_record_ledger_scales_by_queries_and_labels_paths():
    model = _model("MnistNet1")
    led = secure_infer_cost(model, (2,) + INPUT_SHAPES["MnistNet1"])
    r = telemetry.MetricsRegistry()
    r.record_ledger(led, model, queries=3)
    d = r.as_dict()["counters"]
    total_b = sum(v for k, v in d.items()
                  if k.startswith("comm_bytes_total")
                  and 'phase="online"' in k)
    assert total_b == 3 * led.nbytes
    total_pre = sum(v for k, v in d.items()
                    if k.startswith("comm_bytes_total")
                    and 'phase="offline"' in k)
    assert total_pre == 3 * led.pre_nbytes
    # §11 path labels ride along on the layer tags
    assert any('path=' in k for k in d)


def test_movement_counters_fire_per_query():
    """The eager port counts every movement op as it runs: two queries
    count twice what one does (the reference counts once per trace)."""
    model = _model("MnistNet1")
    counts = []
    for queries in (1, 2):
        reg = telemetry.MetricsRegistry()
        with telemetry.collecting(reg):
            for _ in range(queries):
                secure_infer_cost(model, (1,) + INPUT_SHAPES["MnistNet1"])
        counts.append(reg.as_dict()["counters"])
    for kind in ("complete", "open_rss", "open_parts"):
        k = f'transport_ops_total{{backend="local",kind="{kind}"}}'
        assert counts[0].get(k, 0) > 0 and counts[1][k] == 2 * counts[0][k]


# ---------------------------------------------------------------------------
# Attribution: measured == ledger, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
def test_attribution_measured_matches_ledger_exactly(net):
    model = _model(net)
    shape = (2,) + INPUT_SHAPES[net]
    led = secure_infer_cost(model, shape)
    pred = cost_model.model_cost(model, shape)
    rep = telemetry.attribution(pred, led, online_s=0.5)
    # per-row measured wire bytes sum to the live ledger totals EXACTLY
    assert sum(r.meas_bytes for r in rep.rows) == led.nbytes
    assert sum(r.meas_rounds for r in rep.rows) == led.rounds
    assert sum(r.pre_bytes for r in rep.rows) == led.pre_nbytes
    # every ledger tag is attributed to exactly one row
    attributed = [t for r in rep.rows for t in r.tags]
    assert sorted(attributed) == sorted(led.by_tag)
    # prediction agrees per-row (the §15 fidelity contract, row-resolved)
    assert rep.exact
    for r in rep.rows:
        assert (r.pred_rounds, r.pred_bytes) == (r.meas_rounds,
                                                 r.meas_bytes), r.name
    # measured wall time distributes fully across rows
    assert sum(r.attr_ms for r in rep.rows) == pytest.approx(500.0)
    assert "total" in rep.render()


def test_attribution_ledger_only_rows_keep_totals_exact():
    model = _model("MnistNet1")
    shape = (1,) + INPUT_SHAPES["MnistNet1"]
    led = secure_infer_cost(model, shape)
    pred = cost_model.model_cost(model, shape)
    led.add("verify.digest", 1, 48)   # the §14 compare-view round
    rep = telemetry.attribution(pred, led)
    (vrow,) = [r for r in rep.rows if r.name == "verify"]
    assert not vrow.has_pred and vrow.meas_bytes == 48
    assert vrow.exact   # vacuous: nothing predicted to disagree with
    assert rep.exact
    assert sum(r.meas_bytes for r in rep.rows) == led.nbytes
    assert sum(r.meas_rounds for r in rep.rows) == led.rounds


def test_attribution_without_prediction_uses_byte_share():
    model = _model("MnistNet1")
    shape = (1,) + INPUT_SHAPES["MnistNet1"]
    led = secure_infer_cost(model, shape)
    rep = telemetry.attribution(None, led, online_s=1.0)
    assert all(not r.has_pred for r in rep.rows)
    assert sum(r.meas_bytes for r in rep.rows) == led.nbytes
    assert sum(r.attr_ms for r in rep.rows) == pytest.approx(1000.0)
    assert rep.as_dict()["ledger_bytes"] == led.nbytes


# ---------------------------------------------------------------------------
# Bit-identity: telemetry never changes model outputs
# ---------------------------------------------------------------------------

def test_local_outputs_bit_identical_with_telemetry_on():
    model = _model("MnistNet1")
    shape = (2,) + INPUT_SHAPES["MnistNet1"]
    parties = Parties.setup(prf.PRNGKey(7))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, shape).astype(np.float32) - 0.5
    xs = share(torch.from_numpy(x), prf.PRNGKey(3), RING32)

    def run():
        return secure_infer(model, RSS(xs.shares, model.ring),
                            Parties(parties.keys))

    base = run()
    t, reg = telemetry.Tracer(), telemetry.MetricsRegistry()
    with telemetry.tracing(t), telemetry.collecting(reg):
        with telemetry.span("query[0]", cat="online"):
            instrumented = run()
    assert torch.equal(base, instrumented)
    assert t.spans and t.spans[-1].args.get("wire_bytes", 0) > 0
    telemetry.validate_chrome_trace(t.chrome_trace())




# ---------------------------------------------------------------------------
# Held to the reference package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,weights", [("MnistNet1", "shared"),
                                         ("MnistNet3-sep", "shared"),
                                         ("MnistNet3-sep", "public")])
def test_attribution_rows_equal_reference(net, weights):
    """The same model (same numpy weights) and ledger give the reference's
    attribution rows, every field, under each deployment."""
    params = {k: v.numpy() for k, v in init_bnn(0, net).items()}
    model = compile_secure({k: torch.from_numpy(v) for k, v in
                            params.items()}, net, prf.PRNGKey(1), RING32,
                           device="cpu", weights=weights)
    jmodel = jsm.compile_secure(params, net, jax.random.PRNGKey(1), JRING,
                                weights=weights)
    shape = (2,) + INPUT_SHAPES[net]
    led = secure_infer_cost(model, shape)
    jled = jsm.secure_infer_cost(jmodel, shape)
    pred = cost_model.model_cost(model, shape)
    jpred = jcost.model_cost(jmodel, shape)
    for dep in ("local", "lan", "wan"):
        # the reference's compute figure, so the time split matches too
        pdep = dataclasses.replace(cost_model.DEPLOYMENTS[dep],
                                   compute_int8_ops=REF_INT8_OPS)
        rep = telemetry.attribution(pred, led, online_s=0.25,
                                    deployment=pdep)
        jrep = jtelemetry.attribution(jpred, jled, online_s=0.25,
                                      deployment=dep)
        assert rep.exact and jrep.exact
        assert sum(r.meas_bytes for r in rep.rows) == led.nbytes
        assert rep.as_dict() == jrep.as_dict(), dep


def test_validators_accept_each_others_traces():
    t, jt = telemetry.Tracer(parties=3), jtelemetry.Tracer(parties=3)
    for tel, tr in ((telemetry, t), (jtelemetry, jt)):
        with tel.tracing(tr):
            with tel.span("compile", cat="compile"):
                pass
            with tel.span("query[0]", cat="online", lane="parties"):
                pass
    telemetry.validate_chrome_trace(jt.chrome_trace())
    jtelemetry.validate_chrome_trace(t.chrome_trace())
    assert telemetry.PHASES == jtelemetry.PHASES


def test_prometheus_and_json_equal_reference():
    regs = (telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry())
    for r in regs:
        r.inc("comm_rounds_total", 6, tag="l0.fc", phase="online")
        r.inc("transport_ops_total", 3, kind="complete", backend="local")
        r.gauge("g", 2.5, lane="a")
        for v in (0.25, 0.5, 0.125):
            r.observe("query_latency_seconds", v)
    assert regs[0].prometheus() == regs[1].prometheus()
    assert regs[0].as_dict() == regs[1].as_dict()


def test_record_ledger_equals_reference():
    params = {k: v.numpy() for k, v in init_bnn(0, "MnistNet1").items()}
    model = compile_secure({k: torch.from_numpy(v) for k, v in
                            params.items()}, "MnistNet1", prf.PRNGKey(1),
                           RING32, device="cpu")
    jmodel = jsm.compile_secure(params, "MnistNet1", jax.random.PRNGKey(1),
                                JRING)
    shape = (2,) + INPUT_SHAPES["MnistNet1"]
    regs = (telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry())
    regs[0].record_ledger(secure_infer_cost(model, shape), model, queries=3)
    regs[1].record_ledger(jsm.secure_infer_cost(jmodel, shape), jmodel,
                          queries=3)
    assert regs[0].as_dict() == regs[1].as_dict()


# ---------------------------------------------------------------------------
# The serving entry point with telemetry
# ---------------------------------------------------------------------------

def test_serve_trace_metrics_and_attribution(tmp_path, capsys):
    """``serve_secure --deployment wan --trace --metrics-json
    --metrics-prom`` on the CPU: a valid trace with one span a query,
    each carrying that query's ops; metrics whose comm counters are the
    ledger x queries and whose movement counters are per query."""
    paths = {k: tmp_path / f"{k}" for k in ("t.json", "m.json", "m.prom")}
    st = serve_secure.main([
        "--net", "MnistNet1", "--batch", "2", "--queries", "3",
        "--device", "cpu", "--deployment", "wan",
        "--trace", str(paths["t.json"]),
        "--metrics-json", str(paths["m.json"]),
        "--metrics-prom", str(paths["m.prom"])])
    led = st["ledger"]
    out = capsys.readouterr().out
    assert "path solver (wan)" in out and "prediction exact" in out
    assert "phases:" in out
    trace = json.loads(paths["t.json"].read_text())
    telemetry.validate_chrome_trace(trace)
    jtelemetry.validate_chrome_trace(trace)
    queries = [e for e in trace["traceEvents"]
               if e["ph"] == "X" and e["name"].startswith("query[")]
    assert len(queries) == 3
    for e in queries:
        assert (e["args"]["rounds"], e["args"]["wire_bytes"]) == \
            (led.rounds, led.nbytes)
        assert "device_ms" not in e["args"]      # no events on the CPU
    m = json.loads(paths["m.json"].read_text())
    online = sum(v for k, v in m["counters"].items()
                 if k.startswith("comm_bytes_total") and "online" in k)
    assert online == 3 * led.nbytes
    assert m["histograms"]["query_latency_seconds"]["count"] == 3
    # movement ops of the three timed queries only
    reg = telemetry.MetricsRegistry()
    with telemetry.collecting(reg):
        secure_infer_cost(st["model"], (2,) + INPUT_SHAPES["MnistNet1"])
    for k, v in reg.as_dict()["counters"].items():
        assert m["counters"][k] == 3 * v
    assert "# TYPE cbnn_query_latency_seconds summary" in \
        paths["m.prom"].read_text()


def test_serve_logits_bit_identical_with_telemetry_on():
    kw = dict(net="MnistNet3-sep", batch=2, queries=2, device="cpu")
    base = serve_secure.serve(**kw)["logits"]
    t, reg = telemetry.Tracer(), telemetry.MetricsRegistry()
    on = serve_secure.serve(**kw, tracer=t, registry=reg)["logits"]
    assert np.array_equal(base, on)
    assert telemetry.tracer() is None and telemetry.metrics() is None
    assert [s.name for s in t.spans][-2:] == ["query[0]", "query[1]"]

