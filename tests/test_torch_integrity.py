"""Port integrity layer == the JAX package's (DESIGN.md §14): the uint32
digest on ring words, bit shares and RING64 words; honest verified
queries under "opens" and "full"; the 12-cell fault matrix {reshare P1,
open P1, send} x {corrupt, zero, replay, drop} with the reference's
(op, index, tag, round, party) for every cell; faulted logits with
verification off; the ingest checks; and the serving CLI's abort (exit
code 3, trace and metrics flushed).  MnistNet1 at batch 1 from numpy
weights; the reference runs eagerly on its plain products, the port on
its plain versions (CPU tensors)."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import comm as jcomm
from repro.core import integrity as jint
from repro.core import share as jshare
from repro.core import transport as jtr
from repro.core import secure_model as jsm
from repro.core.randomness import Parties as JParties
from repro.core.rss import RSS as JRSS
from repro.nn import bnn as jbnn
from repro_torch.core import comm, integrity, prf, secure_model, transport
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, share
from repro_torch.launch import serve_secure
from repro_torch.weights import params_from_numpy, ring_from_numpy

torch.set_num_threads(1)

NET = "MnistNet1"
FAULT_MODES = ("corrupt", "zero", "replay", "drop")
# (op kind, faulted receiving party): send targets its natural receiver
FAULT_OPS = (("reshare", 1), ("open", 1), ("send", None))


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference model, port model, reference input shares, port input
    shares, reference keys, port keys): the reference test's setup
    (tests/test_integrity.py: its ``init_bnn`` weights, sharing key 1,
    input key 3, party key 7), the same in both packages."""
    params = {k: np.asarray(v) for k, v in
              jbnn.init_bnn(jax.random.PRNGKey(0), NET).items()}
    jm = jsm.compile_secure(params, NET, jax.random.PRNGKey(1), JRING,
                            use_kernel_dot=False)
    tm = secure_model.compile_secure(params_from_numpy(params), NET,
                                     prf.PRNGKey(1), RING32)
    x = (np.random.default_rng(0).integers(0, 2, (1, 28, 28, 1))
         .astype(np.float32) - 0.5)
    jxs = jshare(x, jax.random.PRNGKey(3), JRING)
    txs = share(torch.as_tensor(x), prf.PRNGKey(3), RING32)
    return (jm, tm, jxs, txs, JParties.setup(jax.random.PRNGKey(7)).keys,
            Parties.setup(prf.PRNGKey(7)).keys)


def _ref_run(mode, faults=None):
    """One eager reference query: (logits, verifier, report, transport)
    with ``check`` not called yet (``mode`` None: no verify scope)."""
    jm, _, jxs, _, jk, _ = _setup()
    t = jtr.LocalTransport()
    if faults:
        t = jint.FaultInjectingTransport(t, faults)
    v = jint.Verifier(mode) if mode else None
    with jtr.use_transport(t), jint.verify_scope(v):
        out = jsm.secure_infer(jm, JRSS(jxs.shares, jm.ring), JParties(jk))
        rep = v.traced_report() if v else None
    return np.asarray(out), v, rep, t


def _port_run(mode, faults=None):
    _, tm, _, txs, _, tk = _setup()
    t = transport.LocalTransport()
    if faults:
        t = integrity.FaultInjectingTransport(t, faults)
    v = integrity.Verifier(mode) if mode else None
    with transport.use_transport(t), integrity.verify_scope(v):
        out = secure_model.secure_infer(tm, RSS(txs.shares, tm.ring),
                                        Parties(tk))
        rep = v.traced_report() if v else None
    return out.numpy(), v, rep, t


def _fields(e):
    return (e.op, e.index, e.tag, e.round, e.party)


# ---------------------------------------------------------------------------
# the digest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 4099])
@pytest.mark.parametrize("kind", ["ring32", "bits", "ring64"])
def test_fold_digest_equals_reference(kind, n):
    """The int32 fold holds the reference's uint32 digest bit for bit:
    ring words (weights above 2^31, a mod-2^32 sum), zero-extended bit
    shares, and RING64 words folded with a logical shift."""
    rng = np.random.default_rng(n)
    if kind == "ring32":
        a = rng.integers(0, 2**32, (3, n), dtype=np.uint64).astype(np.uint32)
        t = ring_from_numpy(a)
        want = [np.uint32(jint.fold_digest(jnp.asarray(r))) for r in a]
    elif kind == "bits":
        a = rng.integers(0, 2, (3, n)).astype(np.uint8)
        t = torch.as_tensor(a)
        want = [np.uint32(jint.fold_digest(jnp.asarray(r))) for r in a]
    else:
        a = rng.integers(0, 2**63, (3, n), dtype=np.uint64) * 2 \
            + rng.integers(0, 2, (3, n), dtype=np.uint64)
        t = torch.as_tensor(a.view(np.int64))
        with jax.enable_x64(True):
            want = [np.uint32(jint.fold_digest(jnp.asarray(r, jnp.uint64)))
                    for r in a]
    got = [integrity.as_uint32(integrity.fold_digest(r)) for r in t]
    assert got == want
    assert list(integrity.as_uint32(integrity.fold_digest_rows(t))) == want


# ---------------------------------------------------------------------------
# honest verified queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["opens", "full"])
def test_honest_verified_query_equals_reference(mode):
    """Verification observes, never perturbs: the port's verified logits
    equal its unverified ones and the reference's, and its op metadata and
    every report vector equal the reference's."""
    ref_out, jv, jrep, _ = _ref_run(mode)
    out, v, rep, _ = _port_run(mode)
    plain, _, _, _ = _port_run(None)
    v.check(rep)                       # no deviation -> no raise
    assert np.array_equal(out, plain) and np.array_equal(out, ref_out)
    assert len(v.meta) == len(jv.meta) > 0
    assert v.meta == jv.meta
    for k in integrity.REPORT_KEYS:
        want = np.asarray(jrep[k]).reshape(3, -1)
        assert np.array_equal(integrity.as_uint32(rep[k]), want), k
    if mode == "full":
        _, v_opens, _, _ = _port_run("opens")
        assert len(v.meta) > len(v_opens.meta)


def test_verify_digest_row_equals_reference():
    """The one compare-view round a verified query adds to its ledger."""
    jm, tm, jxs, txs, jk, tk = _setup()
    jv, v = jint.Verifier("full"), integrity.Verifier("full")
    with jcomm.track() as jled, jint.verify_scope(jv):
        jsm.secure_infer(jm, JRSS(jxs.shares, jm.ring), JParties(jk))
        jv.traced_report()
    with comm.track() as led, integrity.verify_scope(v):
        secure_model.secure_infer(tm, RSS(txs.shares, tm.ring), Parties(tk))
        v.traced_report()
    assert tuple(led.by_tag["verify.digest"]) \
        == tuple(jled.by_tag["verify.digest"])
    assert {k: tuple(r) for k, r in led.by_tag.items()} \
        == {k: tuple(r) for k, r in jled.by_tag.items()}


# ---------------------------------------------------------------------------
# the fault matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", FAULT_MODES)
@pytest.mark.parametrize("op,party", FAULT_OPS, ids=lambda p: str(p))
def test_fault_matrix_equals_reference(op, party, mode):
    """Every cell raises IntegrityError in the port with the reference's
    (op, index, tag, round, party), and the message names them."""
    _, jv, jrep, jft = _ref_run("full", [jint.Fault(op, 0, mode, party)])
    out, v, rep, ft = _port_run("full",
                                [integrity.Fault(op, 0, mode, party)])
    assert ft.fired and len(ft.fired) == len(jft.fired)
    with pytest.raises(jint.IntegrityError) as jei:
        jv.check(jrep)
    with pytest.raises(integrity.IntegrityError) as ei:
        v.check(rep)
    e = ei.value
    assert _fields(e) == _fields(jei.value)
    assert e.op == op and e.index == 0 and e.round >= 1
    if party is not None:
        assert e.party == party
    else:
        assert e.party is not None     # send: the natural receiver
    assert e.tag and e.tag in str(e) and op in str(e)


@pytest.mark.parametrize("op,party", FAULT_OPS, ids=lambda p: str(p))
def test_faulted_logits_without_verification_equal_reference(op, party):
    """With verification off the faulted query returns what the
    reference's returns, bit for bit.  The reference's own test asserts a
    wrong answer and fails at open-1: flipping bit 16 of P1's view of the
    first opening leaves the logits honest, in the reference and in the
    port alike; the other two cells change them."""
    ref_out, _, _, jft = _ref_run(None, [jint.Fault(op, 0, "corrupt",
                                                    party)])
    out, _, _, ft = _port_run(None, [integrity.Fault(op, 0, "corrupt",
                                                     party)])
    assert ft.fired and jft.fired
    assert np.array_equal(out, ref_out)
    assert np.array_equal(out, _port_run(None)[0]) == (op == "open")


def test_opens_mode_catches_open_fault():
    """mode="opens" digests openings only and still catches an opening
    fault, as in the reference."""
    _, jv, jrep, _ = _ref_run("opens", [jint.Fault("open", 0, "corrupt", 1)])
    _, v, rep, ft = _port_run("opens",
                              [integrity.Fault("open", 0, "corrupt", 1)])
    assert ft.fired
    with pytest.raises(integrity.IntegrityError) as ei:
        v.check(rep)
    with pytest.raises(jint.IntegrityError) as jei:
        jv.check(jrep)
    assert ei.value.op == "open" and ei.value.party == 1
    assert _fields(ei.value) == _fields(jei.value)


# ---------------------------------------------------------------------------
# the carried-pair branch: one party a process (three gloo ranks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_group():
    from repro_torch.core.party_group import PartyGroup
    with PartyGroup("cpu", timeout=60, deadline=90) as g:
        yield g


def _mesh_runner(group, mode, faults=None):
    _, tm, _, _, _, _ = _setup()
    wrap = (functools.partial(integrity.FaultInjectingTransport,
                              faults=faults) if faults else None)
    return secure_model.make_secure_infer_mesh(
        tm, group, verifier=integrity.Verifier(mode) if mode else None,
        transport_wrap=wrap)


@pytest.mark.parametrize("mode", ["opens", "full"])
def test_mesh_verified_query_equals_local(mesh_group, mode):
    """Each rank digests its own views; the dealer's (3, n) stack of the
    ranks' reports equals the local run's report wherever the check reads
    it (every opening and reshare entry; a send's sender and receiver
    entries: the other ranks digest values they do not hold), and the
    verified logits equal the unverified ones."""
    _, _, _, txs, _, tk = _setup()
    out, v, rep, _ = _port_run(mode)
    fn = _mesh_runner(mesh_group, mode)
    try:
        got = fn(tk, txs.shares)
    finally:
        fn.close()
    assert np.array_equal(got.numpy(), out)
    assert fn.verifier.meta == v.meta
    rows = [r["queries"][0]["report"] for r in fn.last["ranks"]]
    stacked = {k: torch.stack([rw[k] for rw in rows])
               for k in integrity.REPORT_KEYS}
    for k in ("open", "pair_own", "pair_recv"):
        assert torch.equal(stacked[k], rep[k].reshape(3, -1)), k
    sends = [m for m in v.meta if m["kind"] == "send"]
    assert len(sends) == stacked["send_own"].shape[1]
    assert sends or mode == "opens"
    for m in sends:
        for k, who in (("send_own", m["frm"]), ("send_recv", m["to"])):
            assert stacked[k][who, m["idx"]] == rep[k][who, m["idx"]]


@pytest.mark.parametrize("mode", FAULT_MODES)
@pytest.mark.parametrize("op,party", FAULT_OPS, ids=lambda p: str(p))
def test_mesh_fault_matrix_equals_local(mesh_group, op, party, mode):
    """FaultInjectingTransport wraps every rank's MeshTransport and
    tampers the victim rank's received message only; the dealer's check
    raises with the local backend's (op, index, tag, round, party), which
    are the reference's."""
    _, _, _, txs, _, tk = _setup()
    _, v, rep, _ = _port_run("full", [integrity.Fault(op, 0, mode, party)])
    with pytest.raises(integrity.IntegrityError) as want:
        v.check(rep)
    fn = _mesh_runner(mesh_group, "full",
                      [integrity.Fault(op, 0, mode, party)])
    try:
        with pytest.raises(integrity.IntegrityError) as ei:
            fn(tk, txs.shares)
    finally:
        fn.close()
    assert _fields(ei.value) == _fields(want.value)


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        integrity.Fault("open", 0, "corrupt")         # names no party
    with pytest.raises(ValueError):
        integrity.Fault("flood", 0, "zero", 1)
    with pytest.raises(ValueError):
        integrity.Verifier("paranoid")


# ---------------------------------------------------------------------------
# ingest checks
# ---------------------------------------------------------------------------

def _broken(model, rss_cls, change):
    """A copy of ``model`` whose first RSS entry's shares are
    ``change(shares)``."""
    import dataclasses
    ops = [dict(op) for op in model.ops]
    for op in ops:
        for key, val in op.items():
            if isinstance(val, rss_cls):
                op[key] = rss_cls(change(val.shares), val.ring)
                return dataclasses.replace(model, ops=ops)
    raise AssertionError("no RSS entry")


@pytest.mark.parametrize("how", ["axis", "dtype"])
def test_model_ingest_verification_equals_reference(how):
    jm, tm, _, _, _, _ = _setup()
    jint.verify_model_ingest(jm)
    integrity.verify_model_ingest(tm)      # honest shares pass
    if how == "axis":     # a party slot lost
        jchange, change = (lambda s: s[:2]), (lambda s: s[:2])
    else:                 # words of another width than the ring's
        jchange = lambda s: s.astype(jnp.uint16)
        change = lambda s: s.to(torch.int64)
    with pytest.raises(jint.IntegrityError) as jei:
        jint.verify_model_ingest(_broken(jm, JRSS, jchange))
    with pytest.raises(integrity.IntegrityError) as ei:
        integrity.verify_model_ingest(_broken(tm, RSS, change))
    e, je = ei.value, jei.value
    assert (e.op, e.tag, e.index) == (je.op, je.tag, je.index)
    assert e.op == "ingest" and e.tag
    if how == "axis":
        assert "leading axis 2" in str(e)


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offline", ["inline", "pool"])
def test_cli_aborts_with_exit_3_and_flushed_outputs(tmp_path, capsys,
                                                    offline):
    """An IntegrityError inside the CLI path exits 3 with the structured
    message; the trace and metrics are written all the same.  The CLI has
    no fault flag: the fault transport is patched in."""
    trace, mets = tmp_path / "t.json", tmp_path / "m.json"
    ft = integrity.FaultInjectingTransport(
        transport.LocalTransport(), [integrity.Fault("open", 0, "zero", 1)])
    with transport.use_transport(ft), pytest.raises(SystemExit) as ex:
        serve_secure.main(["--net", NET, "--batch", "2", "--queries", "1",
                           "--device", "cpu", "--verify", "full",
                           "--offline", offline, "--trace", str(trace),
                           "--metrics-json", str(mets)])
    assert ex.value.code == 3 and ft.fired
    err = capsys.readouterr().err
    assert "ABORT: integrity violation in open #0" in err
    assert "party 1" in err and "'l1.fc'" in err
    spans = json.loads(trace.read_text())["traceEvents"]
    assert any(s.get("name") == "verify.check" for s in spans)
    counters = json.loads(mets.read_text())["counters"]
    assert counters['integrity_aborts_total{op="open"}'] == 1.0


def test_cli_verified_trace_reports_the_digest_row(tmp_path):
    """--trace --verify full: the attribution keeps the ledger-only
    verify.digest group, exactly the ledger's row; the prediction stays
    exact on every predicted row."""
    st = serve_secure.main(["--net", NET, "--batch", "2", "--queries", "2",
                            "--device", "cpu", "--verify", "full",
                            "--trace", str(tmp_path / "t.json")])
    rep = st["attribution"]
    row = next(r for r in rep.rows if r.name == "verify")
    assert (row.meas_rounds, row.meas_bytes) \
        == tuple(st["ledger"].by_tag["verify.digest"])
    assert row.meas_rounds == 1 and row.meas_bytes % 12 == 0
    assert rep.exact and not row.has_pred
    assert st["verified_ops"] > 0
