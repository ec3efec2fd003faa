"""The port's MeshTransport: one party a process, three gloo ranks on the
CPU (core/party_group.py), held to the local transport and the reference.

* every primitive against ``LocalTransport`` on random stacks, and the
  wire counter's convention (the reference's ``party_wire_bytes_from_hlo``);
* ``make_secure_infer_mesh`` == the port's local ``secure_infer`` == the
  reference's, bit for bit: MnistNet1 on the kernels' plain versions and
  on the plain products, a Sign + maxpool conv net (MnistNet3), under the
  fused and the paper rounds (``set_modes``), as the reference's
  tests/test_transport_mesh.py does, plus public weights and the
  depthwise net (B2's pair entry);
* the wire against the ledger on one secure FFN layer: arithmetic, binary
  (bin-shared then public) and public alone (0 == 0);
* a failing rank (raising, dying, hanging) fails the call within its
  deadline and leaves no rank alive.

The ranks import only ``repro_torch`` (their tasks are in
torch_mesh_ranks.py); the reference runs here, eagerly.  Each group has a
60 s collective timeout and a task deadline that kills every rank.
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core import RING32 as JRING
from repro.core import linear as jlinear
from repro.core import share as jshare
from repro.core import secure_model as jsm
from repro.core.randomness import Parties as JParties
from repro.nn import bnn as jbnn
from repro_torch.core import linear, prf, secure_model, transport
from repro_torch.core.party_group import PartyGroup, RankError
from repro_torch.core.randomness import Parties, party_keys
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, BinRSS, public_rss, share
from repro_torch.weights import params_from_numpy, ring_from_numpy

torch.set_num_threads(1)

TIMEOUT = 60       # seconds: the group's init and every collective
DEADLINE = 90      # seconds a task may take before every rank is killed


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=TIMEOUT, deadline=DEADLINE) as g:
        yield g


@pytest.fixture
def set_modes():
    """``set_modes(matmul_mode, fused)`` flips both packages' toggles (the
    mesh runner carries the port's to its ranks); the defaults come back
    after the test, pass or fail."""
    def _set(matmul_mode="opt2", fused=True):
        for lin in (jlinear, linear):
            lin.set_matmul_mode(matmul_mode)
            lin.set_fused_rounds(fused)
    try:
        yield _set
    finally:
        _set()


def _words(shape, seed):
    return ring_from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32))


def _pair(a, pid):
    return a[[pid, (pid + 1) % 3]]


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

PRIMITIVES = ("views", "complete", "open_parts", "open_rss", "send",
              "slot_view", "build", "masks", "prf", "public")


@pytest.mark.parametrize("name", PRIMITIVES)
def test_mesh_primitive_equals_local(group, name):
    """Each rank's result is its slice of the local transport's: RSS
    stacks its pair, parts stacks its row, openings the whole value, a
    send the message at its receiver (zeros elsewhere), a slot view the
    slot on its two holders; the wire follows the reference's count."""
    a, b = _words((3, 4, 5), 1), torch.randint(0, 2, (3, 4, 5),
                                               dtype=torch.uint8)
    keys = Parties.setup(prf.PRNGKey(11)).keys
    got = group.run(ranks.primitive, (name, {"a": a, "b": b}, keys))
    loc = transport.LocalTransport()
    n = a[0].numel() * 4
    wire = [g["wire"] for g in got]
    for pid, g in enumerate(got):
        out = g["out"]
        if name == "views":
            assert torch.equal(out[0], a[pid:pid + 1])
            assert torch.equal(out[1], loc.next_view(a)[pid:pid + 1])
        elif name in ("complete",):
            assert torch.equal(out, _pair(loc.complete(a), pid))
            assert wire[pid]["by_op"] == {"complete": [1, n]}
        elif name == "open_parts":
            assert torch.equal(out, loc.open_parts(a))
            assert wire[pid]["by_op"] == {"open_parts": [2, 2 * n]}
        elif name == "open_rss":
            assert torch.equal(out, loc.open_rss(a))
            assert wire[pid]["by_op"] == {"open_rss": [1, n]}
        elif name == "send":
            for (frm, to), (r, merged) in zip(ranks.PAIRS, out):
                want = a[frm] if pid == to else torch.zeros_like(a[0])
                assert torch.equal(r, want), (frm, to, pid)
                assert torch.equal(merged, a[frm] if pid == to else a[pid])
            sent = sum(1 for frm, _ in ranks.PAIRS if frm == pid)
            assert wire[pid]["by_op"] == {"send": [sent, sent * n]}
        elif name == "slot_view":
            for i in (pid, (pid + 1) % 3):      # the slots P_pid holds
                assert torch.equal(out[i], loc.slot_view(a, i))
        elif name == "build":
            assert torch.equal(out[0], _pair(loc.build_rss(list(a)), pid))
            assert torch.equal(out[1], loc.build_parts(list(a))[pid:pid + 1])
        elif name == "masks":
            for i, (mr, mp) in enumerate(out):
                want = loc.party_mask_rss(i, 2, torch.int32)
                assert torch.equal(mr, _pair(want, pid))
                assert torch.equal(mp, want[pid:pid + 1])
        elif name == "prf":
            p = Parties(keys)
            want = [p.rand_rss((4, 5), RING32).shares,
                    p.zero_shares((6,), RING32),
                    p.rand_bits((3, 7)).shares,
                    p.rand_rss((9,), RING32, max_bits=30).shares]
            assert torch.equal(out[0], _pair(want[0], pid))
            assert torch.equal(out[1], want[1][pid:pid + 1])
            assert torch.equal(out[2], _pair(want[2], pid))
            assert torch.equal(out[3], _pair(want[3], pid))
        else:
            want = [RSS(a, RING32).add_public(12345).shares,
                    public_rss(7, (2, 3), RING32).shares,
                    (BinRSS(b) ^ 1).shares]
            for o, w in zip(out, want):
                assert torch.equal(o, _pair(w, pid))
    if name in ("views", "slot_view", "build", "masks", "prf", "public"):
        assert all(w["nbytes"] == 0 for w in wire)


# ---------------------------------------------------------------------------
# the classifier: mesh == local == reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(net, weights):
    """(reference model, port model, reference input shares, port input
    shares, reference keys, port keys) from the reference's ``init_bnn``
    weights and the same keys in both packages."""
    params = {k: np.asarray(v) for k, v in
              jbnn.init_bnn(jax.random.PRNGKey(0), net).items()}
    jm = jsm.compile_secure(params, net, jax.random.PRNGKey(2), JRING,
                            use_kernel_dot=False, weights=weights)
    tm = secure_model.compile_secure(params_from_numpy(params), net,
                                     prf.PRNGKey(2), RING32,
                                     weights=weights)
    shape = jbnn.INPUT_SHAPES[net]
    x = (np.random.default_rng(1).integers(0, 2, (2,) + shape)
         .astype(np.float32) - 0.5)
    return (jm, tm, jshare(x, jax.random.PRNGKey(4), JRING),
            share(torch.as_tensor(x), prf.PRNGKey(4), RING32),
            JParties.setup(jax.random.PRNGKey(3)).keys,
            Parties.setup(prf.PRNGKey(3)).keys)


def _plain_products(model):
    """The model without its kernel operands: every product on the
    plain per-party matmuls instead of the kernels' plain versions."""
    ops = [dict(op, wlimbs=[None] * len(op["wlimbs"])) if "wlimbs" in op
           else op for op in model.ops]
    return secure_model.SecureModel(ops=ops, ring=model.ring, net=model.net,
                                    weights=model.weights,
                                    binary_linear=model.binary_linear)


# (net, weights, products, fused rounds): MnistNet1 on both products and
# MnistNet3 under both round structures; public weights and the depthwise
# net fused, as in the reference's mesh test
CASES = [(net, "shared", dots, fused)
         for net, dots in (("MnistNet1", "kernel"), ("MnistNet1", "plain"),
                           ("MnistNet3", "kernel"))
         for fused in (True, False)] + [
    ("MnistNet1", "public", "kernel", True),
    ("MnistNet3-sep", "shared", "kernel", True)]


@pytest.mark.parametrize(
    "net,weights,dots,fused", CASES,
    ids=["-".join(map(str, c[:3])) + ("-fused" if c[3] else "-paper")
         for c in CASES])
def test_mesh_logits_bit_identical(group, set_modes, net, weights, dots,
                                   fused):
    """Three gloo ranks open the port's local logits and the reference's,
    bit for bit, and put exactly the ledger's bytes on the wire."""
    jm, tm, jxs, txs, jk, tk = _models(net, weights)
    if dots == "plain":
        tm = _plain_products(tm)
    set_modes("opt2", fused)
    want = np.asarray(jsm.secure_infer(jm, jxs, JParties(jk)))
    loc = secure_model.secure_infer(tm, RSS(txs.shares, tm.ring),
                                    Parties(tk))
    fn = secure_model.make_secure_infer_mesh(tm, group)
    try:
        got = fn(tk, txs.shares)
    finally:
        fn.close()
    assert torch.equal(got, loc)
    assert np.array_equal(got.numpy(), want)
    rk = fn.last["ranks"]
    led = rk[0]["queries"][0]["ledger"]
    wire = sum(r["queries"][0]["wire"]["nbytes"] for r in rk)
    assert wire == led["nbytes"] + led["pre_nbytes"] > 0


def test_mesh_output_shares_reconstruct(group):
    """``reveal_output=False``: the ranks' own shares stack to the local
    output RSS."""
    _, tm, _, txs, _, tk = _models("MnistNet1", "shared")
    loc = secure_model.secure_infer(tm, RSS(txs.shares, tm.ring),
                                    Parties(tk), reveal_output=False)
    out = secure_model.secure_infer_mesh(tm, txs, Parties(tk), group,
                                         reveal_output=False)
    assert torch.equal(out.shares, loc.shares)


def test_mesh_rank_holds_no_third_slot(group):
    """The dealer hands each rank pairs: every shared tensor of a rank's
    model has leading size 2, public tensors go whole, and no kernel cache
    of a share weight crosses (the rank builds its own slot's)."""
    _, tm, _, _, _, _ = _models("MnistNet1", "shared")
    for pid in range(3):
        pm = secure_model._pair_model(tm, pid)
        shared, public, _ = secure_model._split_arrays(pm.ops)
        assert shared and all(int(a.shape[0]) == 2 for a in shared)
        assert not public
        i = next(i for i, op in enumerate(tm.ops) if "w" in op)
        assert torch.equal(pm.ops[i]["w"][0].shares,
                           _pair(tm.ops[i]["w"][0].shares, pid))
        assert pm.ops[i]["wlimbs"] == [secure_model.OWN_SLOT]
        secure_model.check_pairs(pm.ops, pid)
        with pytest.raises(AssertionError, match="more than its pair"):
            secure_model.check_pairs(tm.ops, pid)
    _, pub, _, _, _, _ = _models("MnistNet1", "public")
    shared, public, _ = secure_model._split_arrays(
        secure_model._pair_model(pub, 1).ops)
    assert public and not shared


def _tensors(tree):
    out = []
    secure_model._map_tensors(tree, lambda a, pub: out.append(a))
    return out


def _moved_third_share(model, pid):
    """``model`` with slot (pid + 2) % 3 of every share tensor changed and
    the dealer's kernel caches rebuilt: the weights differ, P_pid's pairs
    do not."""
    third = (pid + 2) % 3

    def bump(a, pub):
        if pub:
            return a
        a = a.clone()
        a[third] += 1
        return a

    ops = secure_model._map_tensors(model.ops, bump, caches=lambda c: c)
    ops = [dict(op, wlimbs=[secure_model._weight_limbs_for(w, op["op"], j)
                            for j, w in enumerate(op["w"])])
           if "wlimbs" in op else op for op in ops]
    return secure_model.SecureModel(ops=ops, ring=model.ring, net=model.net,
                                    weights=model.weights,
                                    binary_linear=model.binary_linear)


def _rank_views(group, model):
    fn = secure_model.make_secure_infer_mesh(model, group)
    try:
        return group.run(ranks.held, (fn.key,))
    finally:
        fn.close()


@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
def test_mesh_rank_cannot_rebuild_weights(group, net):
    """What a rank keeps after setup (its pairs and the kernel caches it
    built, B2's grouped caches on the depthwise net) does not change when
    the share it must not hold changes, though the weights do; and no sum
    of its weight rows gives a weight back."""
    _, tm, _, _, _, _ = _models(net, "shared")
    views = _rank_views(group, tm)
    lin = [i for i, op in enumerate(tm.ops) if "w" in op]
    for pid in range(3):
        moved = _moved_third_share(tm, pid)
        assert not torch.equal(moved.ops[lin[0]]["w"][0].shares.sum(0),
                               tm.ops[lin[0]]["w"][0].shares.sum(0))
        other = _rank_views(group, moved)[pid]
        mine, theirs = _tensors(views[pid].ops), _tensors(other.ops)
        assert len(mine) == len(theirs)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    for pid, view in enumerate(views):
        for i in lin:
            for j, w in enumerate(tm.ops[i]["w"]):
                whole = w.shares.sum(0)
                targets = [whole.flatten()]
                if tm.ops[i]["op"] == "sepconv" and j == 0:
                    kh, kw, _, c = whole.shape   # B2's cache: (C, K, 1)
                    targets.append(whole.reshape(kh * kw, c, 1)
                                   .permute(1, 0, 2).flatten())
                rows = [r.flatten() for a in _tensors(
                            [view.ops[i]["w"][j], view.ops[i]["wlimbs"][j]])
                        if a.dtype == torch.int32
                        and a[0].numel() == whole.numel() for r in a]
                for n in (1, 2, 3):
                    for sub in itertools.combinations(rows, n):
                        got = torch.stack(sub).sum(0)
                        assert not any(torch.equal(got, t)
                                       for t in targets), (pid, i, j)


@pytest.mark.parametrize("pid", range(3))
def test_mesh_rank_holds_two_keys(pid):
    """A rank is sent k_pid and k_{pid+1} only; a draw from the absent
    key is zeros, the opened-mask shortcut refuses, and a rank sent all
    three keys fails its check."""
    keys = Parties.setup(prf.PRNGKey(11)).keys
    mine = party_keys(keys, pid)
    third = (pid + 2) % 3
    assert mine[third] is None
    assert [k for i, k in enumerate(mine) if i != third] \
        == [k for i, k in enumerate(keys) if i != third]
    secure_model._check_keys(mine, pid)
    with pytest.raises(AssertionError, match="other keys"):
        secure_model._check_keys(keys, pid)
    full, part = Parties(keys), Parties(mine)
    a, b = full.common_pair(0, 1, (4,)), part.common_pair(0, 1, (4,))
    assert torch.equal(b, torch.zeros_like(a) if third == 1 else a)
    fa, fb = full.private_to(pid, (5,)), part.private_to(pid, (5,))
    assert torch.equal(fa, fb)
    with pytest.raises(ValueError, match="simulation shortcut"):
        part.rand_rss_open((3,))


# ---------------------------------------------------------------------------
# the wire against the ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["arith", "bin", "public"])
def test_mesh_ffn_wire_equals_ledger(group, kind):
    """One secure FFN layer (the reference's ledger-vs-wire program): the
    bytes the three ranks put on the wire == the ledger's online +
    offline total; a public-weight layer records 0 bytes and sends
    nothing; the bin-shared layer is one reshare round of 3 elements an
    output."""
    d, dff, t = 16, 32, 8
    rng = np.random.default_rng(0)
    key = prf.PRNGKey(0)
    if kind == "bin":
        xv = np.where(rng.integers(0, 2, (t, d)), 1.0, -1.0) * 0.25
    else:
        xv = rng.normal(0, 0.3, (t, d))
    x = share(torch.as_tensor(xv, dtype=torch.float32), key, RING32).shares
    w1f = rng.normal(0, 0.3, (d, dff)).astype(np.float32)
    w2f = rng.normal(0, 0.3, (dff, d)).astype(np.float32)
    if kind == "arith":
        w1 = share(torch.as_tensor(w1f), prf.fold_in(key, 1), RING32).shares
        w2 = share(torch.as_tensor(w2f), prf.fold_in(key, 2), RING32).shares
    elif kind == "bin":
        w1 = share(torch.as_tensor(w1f), prf.fold_in(key, 1), RING32).shares
        w2 = RING32.encode(torch.as_tensor(w2f))
    else:
        w1, w2 = RING32.encode(torch.as_tensor(w1f)), None
    got = group.run(ranks.ffn_wire, (kind, x, w1, w2))
    led = got[0]["ledger"]
    assert all(g["ledger"] == led for g in got)
    wire = sum(g["wire"]["nbytes"] for g in got)
    total = led["nbytes"] + led["pre_nbytes"]
    if kind == "public":
        assert wire == total == 0 and led["rounds"] == 0
        return
    assert wire == total > 0
    if kind == "arith":
        assert led["rounds"] == 4
        assert sum(g["wire"]["by_op"].get("open_parts", [0, 0])[0]
                   for g in got) == 3 * 2 * 3   # up, down, the ReLU's open
    else:
        assert led["by_tag"]["bin.up"] == [1, 3 * t * dff * 4]
        assert led["by_tag"]["bin.down.pub"] == [0, 0]
        up = sum(g["wire"]["by_tag"]["bin.up"][1] for g in got)
        assert up == 3 * t * dff * 4


# ---------------------------------------------------------------------------
# a failing rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["raise", "exit", "hang"])
def test_failing_rank_fails_the_call(how):
    """A rank that raises (its traceback comes back), dies or hangs fails
    the task with RankError within the deadline, and every rank is
    killed: nothing is left running and nothing reports success."""
    g = PartyGroup("cpu", timeout=10, deadline=4)
    try:
        with pytest.raises(RankError) as ei:
            g.run(ranks.fail, (how,))
        if how == "raise":
            assert "fails on purpose" in str(ei.value) and ei.value.rank == 1
        assert g.closed
        assert not any(p.is_alive() for p in g._procs)
        with pytest.raises(RankError):
            g.run(ranks.fail, ("raise",))
    finally:
        g.close()
