"""Port offline plant == the JAX package's (DESIGN.md §12): material specs
and slab layouts of MnistNet1 (shared and public), MnistNet3 and
MnistNet4 under paper rounds (together every kind but ``bits``, which
stays inside ``msb``); tape slabs bit for bit; tape-backed logits ==
inline == the reference's; a tape-backed query evaluates the PRF zero
times; the online ledger; the typed desync errors; the TapePool cases of
tests/test_integrity.py; and serve_secure's pool mode and argument
errors.  The reference runs on its plain products (``use_kernel_dot=
False``) from its tests' weights (``init_bnn(PRNGKey(0))``, sharing key
1); the port on its plain versions (CPU tensors)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import preprocessing as jprep
from repro.core import secure_model as jsm
from repro.core import share as jshare
from repro.core import transport as jtr
from repro.core.randomness import Parties as JParties
from repro.nn import bnn as jbnn
from repro_torch.core import integrity, prf, secure_model
from repro_torch.core import preprocessing as prep
from repro_torch.core.integrity import (IntegrityError, MaterialDesyncError,
                                        PoolExhaustedError,
                                        verify_tape_slice)
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.launch import serve_secure
from repro_torch.weights import params_from_numpy, ring_to_numpy
from test_torch_protocols_paper import set_modes  # noqa: F401 (fixture)

torch.set_num_threads(1)

SHAPE = (28, 28, 1)
# (net, weights, paper rounds): the spec cases
CASES = [("MnistNet1", "shared", False), ("MnistNet1", "public", False),
         ("MnistNet3", "shared", False), ("MnistNet4", "shared", True)]


@functools.lru_cache(maxsize=None)
def _models(net, weights):
    params = {k: np.asarray(v) for k, v in
              jbnn.init_bnn(jax.random.PRNGKey(0), net).items()}
    jm = jsm.compile_secure(params, net, jax.random.PRNGKey(1), JRING,
                            use_kernel_dot=False, weights=weights)
    tm = secure_model.compile_secure(params_from_numpy(params), net,
                                     prf.PRNGKey(1), RING32, weights=weights)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _specs(net, weights, paper, batch=1):
    """(reference spec, port spec); a paper case is traced only under
    ``set_modes("opt2", False)``, which the calling test sets."""
    jm, tm = _models(net, weights)
    shape = (batch,) + SHAPE
    return jprep.trace_material(jm, shape), prep.trace_material(tm, shape)


def _keys(seed):
    return (JParties.setup(jax.random.PRNGKey(seed)).keys,
            Parties.setup(prf.PRNGKey(seed)).keys)


def _inputs(batch, seed=1):
    x = (np.random.default_rng(seed).integers(0, 2, (batch,) + SHAPE)
         .astype(np.float32) - 0.5)
    return (jshare(x, jax.random.PRNGKey(4), JRING),
            share(torch.as_tensor(x), prf.PRNGKey(4), RING32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy() if t.dtype == torch.uint8 else ring_to_numpy(t)


def _item(it):
    return (it.kind, it.cnt, it.shape, it.aux, it.ring.bits)


def _struct(shape, dtype):
    return tuple(int(d) for d in shape), str(np.dtype(
        "uint8" if dtype in (torch.uint8, jnp.uint8) else "uint32"))


# ---------------------------------------------------------------------------
# specs and slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,weights,paper", CASES)
def test_spec_equals_reference(set_modes, net, weights, paper):
    """Items (kind, cnt, shape, aux, ring), slot index and slab structs
    equal the reference's."""
    if paper:
        set_modes("opt2", False)
    js, ts = _specs(net, weights, paper)
    assert [_item(i) for i in ts.items] == [_item(i) for i in js.items]
    assert ts.index == js.index and len(ts) == len(js) > 0
    assert {k: _struct(v.shape, v.dtype) for k, v in
            ts.slab_structs().items()} \
        == {k: _struct(v.shape, v.dtype) for k, v in
            js.slab_structs().items()}
    assert ts.summary() == js.summary()
    assert all(v.device.type == "meta" for v in ts.slab_structs().values())


def test_specs_reach_every_kind_but_bits(set_modes):
    kinds = set()
    for net, weights, paper in CASES:
        set_modes("opt2", not paper)
        kinds |= {it.kind for it in _specs(net, weights, paper)[1].items}
    assert kinds == set(prep._KIND_FIELDS) - {"bits"}


def test_tape_slabs_equal_reference():
    """Two per-query key sets: every slab of the port's tape equals the
    reference's ``generate_tape`` bit for bit, in its layout, and each
    query's slice equals a tape drawn for that query alone."""
    js, ts = _specs("MnistNet1", "shared", False, batch=2)
    (jk0, tk0), (jk1, tk1) = _keys(7), _keys(8)
    jt = jprep.generate_tape(js, jnp.stack([jk0, jk1]))
    tt = prep.generate_tape(ts, [tk0, tk1])
    assert set(tt.slabs) == set(jt.slabs) and tt.n_queries == 2
    for k, v in tt.slabs.items():
        assert np.array_equal(_np(v), np.asarray(jt.slabs[k])), k
    assert tt.nbytes == jt.nbytes
    # the batched plant == one query at a time (the loop it replaces)
    for q, tk in enumerate((tk0, tk1)):
        one = prep.generate_tape(ts, [tk]).query_slice(0)
        for k, v in tt.query_slice(q).items():
            assert torch.equal(v, one[k]), (q, k)
    sl = tt.query_slice(1)
    for k, st in ts.slab_structs().items():
        assert (tuple(sl[k].shape), sl[k].dtype) == (tuple(st.shape),
                                                     st.dtype)


def test_paper_tape_slabs_equal_reference_draws(set_modes):
    """MnistNet4 under paper rounds (private, pair and OT-mask draws):
    each slab row equals the reference plant's draw of its item (the
    code its ``generate_tape`` maps over queries), run eagerly."""
    set_modes("opt2", False)
    js, ts = _specs("MnistNet4", "shared", True)
    jk, tk = _keys(7)
    tt = prep.generate_tape(ts, [tk])
    p = JParties(jk)
    with jtr.use_transport(jtr.LocalTransport()):
        for it, (base, slot) in zip(js.items, js.index):
            p._cnt = it.cnt
            for suffix, row in jprep._draw_inline(p, it).items():
                v = tt.slabs[base + suffix]
                got = (v[0, slot] if ts.slabs[base + suffix].layout
                       == prep.REPLICATED else v[:, 0, slot])
                assert np.array_equal(_np(got), np.asarray(row)), \
                    (base + suffix, slot)


# ---------------------------------------------------------------------------
# the tape-backed online query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["shared", "public"])
def test_tape_logits_equal_inline_and_reference(weights):
    jm, tm = _models("MnistNet1", weights)
    js, ts = _specs("MnistNet1", weights, False, batch=2)
    jxs, txs = _inputs(2)
    keys = [_keys(7), _keys(8)]
    tape = prep.generate_tape(ts, [k[1] for k in keys])
    run = prep.make_tape_infer(tm, ts)
    for q, (jk, tk) in enumerate(keys):
        out = run(tk, txs.shares, tape.query_slice(q)).numpy()
        inline = secure_model.secure_infer(tm, txs, Parties(tk)).numpy()
        ref = np.asarray(jsm.secure_infer(jm, jxs, JParties(jk)))
        assert np.array_equal(out, inline) and np.array_equal(out, ref), q


def test_tape_query_evaluates_no_prf(monkeypatch):
    """The port's form of the reference's PRF-free HLO pin: a tape-backed
    query calls the threefry kernel zero times, an inline one does.  The
    counter also catches the ``fresh()`` trap: a TapeParties whose fresh
    returned a new inline Parties gives the same logits (tape == inline)
    and evaluates the PRF again."""
    _, tm = _models("MnistNet1", "shared")
    _, ts = _specs("MnistNet1", "shared", False, batch=2)
    _, txs = _inputs(2)
    _, tk = _keys(7)
    tape = prep.generate_tape(ts, [tk])
    calls = []
    real = prf._threefry_tensor
    monkeypatch.setattr(prf, "_threefry_tensor",
                        lambda *a: calls.append(1) or real(*a))
    run = prep.make_tape_infer(tm, ts)
    out = run(tk, txs.shares, tape.query_slice(0))
    assert len(calls) == 0, "PRF work left in the online query"
    tp = prep.TapeParties(tk, tape.query_slice(0), ts)
    assert tp.fresh() is tp
    inline = secure_model.secure_infer(tm, txs, Parties(tk))
    assert len(calls) > 0, "the PRF counter lost its teeth"
    assert torch.equal(out, inline)
    calls.clear()
    monkeypatch.setattr(prep.TapeParties, "fresh",
                        lambda self: Parties(self.keys, self._base))
    trapped = run(tk, txs.shares, tape.query_slice(0))
    assert torch.equal(trapped, out) and len(calls) > 0


def test_online_cost_equals_inline_online_rows_and_reference():
    """The tape-backed query's ledger is the inline ledger's online rows
    (and the reference's ``online_cost``); the plant records one query's
    ``pre:`` rows, tag for tag."""
    jm, tm = _models("MnistNet1", "shared")
    js, ts = _specs("MnistNet1", "shared", False, batch=2)
    shape = (2,) + SHAPE

    def rows(led, pre):
        return {t: tuple(v) for t, v in led.by_tag.items()
                if t.startswith("pre:") == pre}

    led_in = secure_model.secure_infer_cost(tm, shape)
    led_on = prep.online_cost(tm, ts, shape)
    assert (led_on.pre_rounds, led_on.pre_nbytes) == (0, 0)
    assert (led_on.rounds, led_on.nbytes) == (led_in.rounds, led_in.nbytes)
    assert rows(led_on, False) == rows(led_in, False)
    assert rows(led_on, False) == rows(jprep.online_cost(jm, js, shape),
                                       False)
    gen = prep.make_tape_generator(ts)
    gen([_keys(7)[1]])
    assert rows(gen.ledger, True) == rows(led_in, True)
    assert (gen.ledger.rounds, gen.ledger.nbytes) == (0, 0)
    assert led_in.pre_nbytes > 0


# ---------------------------------------------------------------------------
# typed desync errors
# ---------------------------------------------------------------------------

def _meta_run(model, spec, structs):
    from repro_torch.core import comm
    _, tk = _keys(7)
    x = torch.empty((3, 1) + SHAPE, dtype=torch.int32)
    comm.estimate_cost(
        lambda m, xs, sl: prep.make_tape_infer(m, spec)(tk, xs, sl),
        model, x, structs)


def test_tape_wrong_shape_slab_desync():
    _, tm = _models("MnistNet1", "shared")
    _, ts = _specs("MnistNet1", "shared", False)
    structs = ts.slab_structs()
    k = next(iter(structs))
    st = structs[k]
    structs[k] = torch.empty(tuple(st.shape[:-1]) + (st.shape[-1] + 1,),
                             dtype=st.dtype, device="meta")
    with pytest.raises(MaterialDesyncError, match="desync") as ei:
        _meta_run(tm, ts, structs)
    assert "kind=" in str(ei.value) and "cnt=" in str(ei.value)


def test_tape_wrong_ring_slab_desync():
    _, tm = _models("MnistNet1", "shared")
    _, ts = _specs("MnistNet1", "shared", False)
    structs = ts.slab_structs()
    k = next(k for k, st in structs.items() if st.dtype == torch.int32)
    structs[k] = torch.empty(structs[k].shape, dtype=torch.int16,
                             device="meta")
    with pytest.raises(MaterialDesyncError, match="desync") as ei:
        _meta_run(tm, ts, structs)
    assert "kind=" in str(ei.value) and "cnt=" in str(ei.value)


def test_tape_reordered_spec_desync():
    _, tm = _models("MnistNet1", "shared")
    _, ts = _specs("MnistNet1", "shared", False)
    rev = prep.MaterialSpec(list(reversed(ts.items)))
    assert [i.kind for i in rev.items] != [i.kind for i in ts.items]
    with pytest.raises(MaterialDesyncError, match="desync") as ei:
        _meta_run(tm, rev, rev.slab_structs())
    assert "traced" in str(ei.value) and "kind=" in str(ei.value)


def test_tape_of_another_model_desyncs():
    _, ts = _specs("MnistNet1", "shared", False)
    _, t3 = _models("MnistNet3", "shared")
    with pytest.raises(RuntimeError, match="desync|exhausted"):
        _meta_run(t3, ts, ts.slab_structs())


def test_verify_tape_slice_structural():
    _, ts = _specs("MnistNet1", "shared", False)
    sl = prep.generate_tape(ts, [_keys(7)[1]]).query_slice(0)
    verify_tape_slice(ts, sl)             # honest slice passes
    missing = dict(sl)
    del missing[next(iter(missing))]
    with pytest.raises(MaterialDesyncError, match="missing"):
        verify_tape_slice(ts, missing)
    extra = dict(sl)
    extra["bogus.slab"] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(MaterialDesyncError, match="unexpected"):
        verify_tape_slice(ts, extra)


# ---------------------------------------------------------------------------
# TapePool: demand gating, backpressure, typed exhaustion
# ---------------------------------------------------------------------------

def _pool(**kw):
    _, ts = _specs("MnistNet1", "shared", False)
    return ts, prep.TapePool(prep.make_tape_generator(ts), ts,
                             master_key=prf.PRNGKey(11), **kw)


def test_tape_pool_partial_buffer_economy():
    """demand 3 at depth 2: exactly two buffers; every slice equals the
    reference pool's slice (keys from fold_in(master, buffer))."""
    ts, pool = _pool(depth=2, demand=3)
    js, _ = _specs("MnistNet1", "shared", False)
    jpool = jprep.TapePool(jprep.make_tape_generator(js), js, 2,
                           jax.random.PRNGKey(11), demand=3)
    for _ in range(3):
        sl, jsl = pool.take(), jpool.take()
        assert set(sl) == set(ts.slab_structs())
        for k in sl:
            assert np.array_equal(_np(sl[k]), np.asarray(jsl[k])), k
    assert (pool.generated, pool.refills, pool.taken) == (2, 1, 3)


def test_tape_pool_exhaustion_typed():
    _, pool = _pool(depth=2, demand=2)
    pool.take(), pool.take()
    with pytest.raises(PoolExhaustedError, match="exhausted") as ei:
        pool.take()
    assert isinstance(ei.value, IntegrityError)   # one catchable family
    assert "2 slices" in str(ei.value)


def test_tape_pool_backpressure_warns_then_raises():
    _, pool = _pool(depth=2, max_buffers=2, prefetch=False)
    pool.take(), pool.take()              # drains the single initial buffer
    with pytest.warns(RuntimeWarning, match="underrun"):
        pool.take()                       # synchronous blocking refill
    pool.take()
    with pytest.raises(PoolExhaustedError, match="exhausted"):
        pool.take()


def test_tape_pool_near_dry_warning():
    _, pool = _pool(depth=2, demand=6, max_buffers=1)
    with pytest.warns(RuntimeWarning, match="nearly exhausted"):
        pool.take()


def test_tape_pool_verified_slices_and_depth():
    ts, pool = _pool(depth=1, demand=1, verify=True)
    verify_tape_slice(ts, pool.take())    # checked on every take as well
    with pytest.raises(ValueError):
        _pool(depth=0)


def test_plant_refuses_a_verify_scope():
    _, ts = _specs("MnistNet1", "shared", False)
    with integrity.verify_scope(integrity.Verifier("full")), \
            pytest.raises(RuntimeError, match="verify_scope"):
        prep.make_tape_generator(ts)([_keys(7)[1]])


# ---------------------------------------------------------------------------
# serve_secure: pool mode and argument errors
# ---------------------------------------------------------------------------

def test_serve_pool_full_verify_equals_inline():
    """serve(offline="pool", verify="full") on the CPU: the inline logits,
    the inline online ledger, the plant's offline rows, the pool stats."""
    kw = dict(batch=2, queries=3, device="cpu", verify="full")
    pool = serve_secure.serve("MnistNet1", offline="pool", pool_depth=2, **kw)
    inline = serve_secure.serve("MnistNet1", **kw)
    assert np.array_equal(pool["logits"], inline["logits"])
    for k in ("online_rounds", "online_bytes", "offline_rounds",
              "offline_bytes"):
        assert pool[k] == inline[k], k
    assert (pool["online_rounds"], pool["online_bytes"]) == (6, 2 * 10_992)
    assert not any(t.startswith("pre:") for t in pool["ledger"].by_tag)
    assert pool["pool_depth"] == 2 and pool["refills"] == 1
    for k in ("query_per_s_online", "img_per_s_online", "query_per_s",
              "img_per_s", "tape_mb_per_query"):
        assert pool[k] > 0, k
    assert pool["query_per_s_online"] >= pool["query_per_s"]


@pytest.mark.parametrize("args,needle", [
    (["--net", "NopeNet9"], "unknown --net"),
    (["--pool-depth", "4"], "--pool-depth only applies to --offline pool"),
    (["--offline", "pool", "--pool-depth", "0"], "--pool-depth must be >= 1"),
    (["--weights", "public", "--binary-linear", "generic"],
     "no generic Alg-2 route"),
    (["--queries", "0"], "--queries must be >= 1"),
    (["--verify", "paranoid"], "invalid choice"),
])
def test_serve_secure_arg_validation(capsys, args, needle):
    with pytest.raises(SystemExit) as ex:
        serve_secure.main(["--device", "cpu"] + args)
    assert ex.value.code == 2
    assert needle in capsys.readouterr().err
