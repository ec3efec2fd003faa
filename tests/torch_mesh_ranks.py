"""Party-process tasks of the mesh parity tests (test_torch_*_mesh.py).

A :class:`~repro_torch.core.party_group.PartyGroup` rank unpickles the task
functions it runs by module, so they live here, in a module that imports
``repro_torch`` and torch only: no rank imports JAX or the reference
package.  Each task is ``fn(state, *args)`` and returns CPU tensors and
plain values.
"""
import torch

from repro_torch.core import comm, prf, transport
from repro_torch.core.activation import secure_relu, secure_sign
from repro_torch.core.linear import PublicTensor, bin_matmul, matmul_truncate
from repro_torch.core.ot import ot3
from repro_torch.core.randomness import Parties, party_keys
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, BinRSS, public_rss

PAIRS = ((0, 1), (1, 2), (2, 0), (0, 2), (1, 0), (2, 1))


def _pair(a, pid):
    return a[[pid, (pid + 1) % 3]]


def primitive(state, name, stacks, keys):
    """One MeshTransport primitive on this rank's slice of the global
    ``stacks`` ((3, ...) tensors): its result and this rank's wire."""
    pid = state["rank"]
    t = transport.MeshTransport(pid)
    a, b = stacks["a"], stacks["b"]
    with transport.use_transport(t):
        if name == "views":
            pair = t.ingest(a[pid:pid + 1], a[(pid + 1) % 3][None])
            out = [t.own_view(pair), t.next_view(pair)]
        elif name == "complete":
            out = t.complete(a[pid:pid + 1])
        elif name == "open_parts":
            out = t.open_parts(a[pid:pid + 1])
        elif name == "open_rss":
            out = t.open_rss(_pair(a, pid))
        elif name == "send":
            out = []
            for frm, to in PAIRS:
                r = t.send(a[pid], frm, to)
                out.append([r, t.merge_recv(a[pid], r, to)])
        elif name == "slot_view":
            out = [t.slot_view(_pair(a, pid), i) for i in range(3)]
        elif name == "build":
            out = [t.build_rss(list(a)), t.build_parts(list(a))]
        elif name == "masks":
            out = [[t.party_mask_rss(i, 2, torch.int32),
                    t.party_mask_parts(i, 2, torch.int32)] for i in range(3)]
        elif name == "prf":
            p = Parties(party_keys(keys, pid))
            out = [p.rand_rss((4, 5), RING32).shares,
                   p.zero_shares((6,), RING32),
                   p.rand_bits((3, 7)).shares,
                   p.rand_rss((9,), RING32, max_bits=30).shares]
        elif name == "public":
            x = RSS(_pair(a, pid), RING32)
            bits = BinRSS(_pair(b, pid))
            out = [x.add_public(12345).shares,
                   public_rss(7, (2, 3), RING32).shares,
                   (bits ^ 1).shares]
        else:
            raise ValueError(name)
    return {"out": out, "wire": t.wire.summary()}


def ffn_wire(state, kind, x, w1, w2):
    """One secure FFN layer on this rank's pairs, as the reference's
    ledger-vs-wire test: ``arith`` (matmul + Π_trunc, ReLU, matmul +
    Π_trunc), ``bin`` (Sign, the bin-shared product, a public product)
    or ``public`` (a public product alone).  Returns this rank's own
    output share, its ledger and its wire."""
    pid = state["rank"]
    t = transport.MeshTransport(pid)
    keys = party_keys(Parties.setup(prf.PRNGKey(3)).keys, pid)
    with transport.use_transport(t), comm.listening(t.wire.listen), \
            comm.track() as led:
        p = Parties(keys)
        xs = RSS(_pair(x, pid), RING32)
        if kind == "arith":
            h = matmul_truncate(xs, RSS(_pair(w1, pid), RING32), p,
                                tag="ffn.up")
            h = secure_relu(h, p, tag="ffn.relu")
            out = matmul_truncate(h, RSS(_pair(w2, pid), RING32), p,
                                  tag="ffn.down")
        elif kind == "bin":
            s = secure_sign(xs, p, tag="sign")
            s = s.mul_public_int(2).add_public(-1)
            h = bin_matmul(s, RSS(_pair(w1, pid), RING32), p, tag="bin.up")
            out = bin_matmul(h, PublicTensor(w2), p, tag="bin.down.pub")
        else:
            out = bin_matmul(xs, PublicTensor(w1), p, tag="pub.only")
    return {"own": t.own_view(out.shares), "ledger": led.as_dict(),
            "wire": t.wire.summary()}


def ot_wire(state, m0, m1, choice, sender, receiver, helper):
    """ot3 on this rank, the choice bit the share slot the sender does not
    hold: the received m_c (valid on the receiver), the ledger and the
    wire."""
    pid = state["rank"]
    t = transport.MeshTransport(pid)
    keys = party_keys(Parties.setup(prf.PRNGKey(5)).keys, pid)
    with transport.use_transport(t), comm.listening(t.wire.listen), \
            comm.track() as led:
        out = ot3(m0, m1, _pair(choice, pid), (sender + 2) % 3,
                  sender=sender, receiver=receiver, helper=helper,
                  parties=Parties(keys), ring=RING32, tag="ot3")
    return {"out": out, "ledger": led.as_dict(), "wire": t.wire.summary()}


def fail(state, how):
    """A failing rank: rank 1 raises, exits without an answer, or hangs
    (the others return)."""
    import os
    import time
    if state["rank"] != 1:
        return "ok"
    if how == "raise":
        raise RuntimeError("rank 1 fails on purpose")
    if how == "exit":
        os._exit(7)
    time.sleep(600)


def held(state, key):
    """Everything this rank keeps of the model set up under ``key`` (its
    pairs and the kernel caches it built), on the host."""
    return comm._to_device(state[key]["model"], "cpu")
