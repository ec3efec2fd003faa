"""The tape pool with one party a process (three gloo ranks on the CPU):
tape playback under ``make_secure_infer_mesh(tape_spec=...)`` == inline
local inference bit for bit (== the reference's inline logits) on
MnistNet1 with shared and public weights and MnistNet3; no rank evaluates
the PRF in a tape-backed query (a counter on ``prf._threefry_tensor`` in
every rank); and the three ranks' online wire equals the online ledger
exactly, as the reference's tests/test_preprocessing_mesh.py holds its
compiled online program to.  The dealer lays each rank's slabs out as
pairs, own rows or whole."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import share as jshare
from repro.core import secure_model as jsm
from repro.core.randomness import Parties as JParties
from repro.nn import bnn as jbnn
from repro_torch.core import linear, prf, secure_model
from repro_torch.core import preprocessing as prep
from repro_torch.core.party_group import PartyGroup
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, share
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=90) as g:
        yield g


@functools.lru_cache(maxsize=None)
def _case(net, weights):
    params = {k: np.asarray(v) for k, v in
              jbnn.init_bnn(jax.random.PRNGKey(0), net).items()}
    shape = (2,) + jbnn.INPUT_SHAPES[net]
    x = (np.random.default_rng(1).integers(0, 2, shape)
         .astype(np.float32) - 0.5)
    tm = secure_model.compile_secure(params_from_numpy(params), net,
                                     prf.PRNGKey(1), RING32, weights=weights)
    jm = jsm.compile_secure(params, net, jax.random.PRNGKey(1), JRING,
                            use_kernel_dot=False, weights=weights)
    keys = Parties.setup(prf.PRNGKey(7)).keys
    want = np.asarray(jsm.secure_infer(
        jm, jshare(x, jax.random.PRNGKey(4), JRING),
        JParties(JParties.setup(jax.random.PRNGKey(7)).keys)))
    return tm, share(torch.as_tensor(x), prf.PRNGKey(4), RING32), keys, \
        shape, want


@pytest.mark.parametrize("net,weights", [("MnistNet1", "shared"),
                                         ("MnistNet1", "public"),
                                         ("MnistNet3", "shared")])
def test_mesh_tape_playback_bit_identical_and_online_wire(group, net,
                                                          weights):
    tm, xs, keys, shape, want = _case(net, weights)
    inline = secure_model.secure_infer(tm, RSS(xs.shares, tm.ring),
                                       Parties(keys))
    spec = prep.trace_material(tm, shape)
    tape = prep.generate_tape(spec, [keys])
    fn = secure_model.make_secure_infer_mesh(tm, group, tape_spec=spec)
    try:
        out = fn(keys, xs.shares, tape.query_slice(0))
    finally:
        fn.close()
    assert torch.equal(out, inline)
    assert np.array_equal(out.numpy(), want)
    rk = fn.last["ranks"]
    assert [r["queries"][0]["prf_calls"] for r in rk] == [0, 0, 0]
    led = rk[0]["queries"][0]["ledger"]
    online = prep.online_cost(tm, spec, shape)
    assert (led["rounds"], led["nbytes"], led["pre_nbytes"]) \
        == (online.rounds, online.nbytes, 0)
    wire = sum(r["queries"][0]["wire"]["nbytes"] for r in rk)
    assert wire == online.nbytes > 0


def test_mesh_rank_slab_layout(group):
    """The dealer's slab hand-off: stack-pair slabs as P_i's pair (2
    rows), parts slabs as its own row, replicated slabs whole (the paper
    rounds' OT masks)."""
    tm, xs, keys, shape, _ = _case("MnistNet1", "shared")
    linear.set_fused_rounds(False)
    try:
        spec = prep.trace_material(tm, shape)
    finally:
        linear.set_fused_rounds(True)
    sl = prep.generate_tape(spec, [keys]).query_slice(0)
    fn = secure_model.make_secure_infer_mesh(tm, group, tape_spec=spec)
    try:
        staged = fn.prepare(xs.shares, sl)
    finally:
        fn.close()
    layouts = {v.layout for v in spec.slabs.values()}
    assert layouts == {prep.STACK_PAIR, prep.STACK_PARTS, prep.REPLICATED}
    for pid, (x_pair, slabs) in enumerate(staged):
        assert torch.equal(x_pair, xs.shares[[pid, (pid + 1) % 3]])
        for k, info in spec.slabs.items():
            if info.layout == prep.STACK_PAIR:
                want = sl[k][[pid, (pid + 1) % 3]]
            elif info.layout == prep.STACK_PARTS:
                want = sl[k][pid:pid + 1]
            else:
                want = sl[k]
            assert torch.equal(slabs[k], want), k
