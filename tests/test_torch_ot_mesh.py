"""``core/ot.py::ot3`` with one party a process (three gloo ranks on the
CPU): the receiver gets m_c for every rotation of the roles, the ledger
meters 2 rounds and 3 ring elements a slot, as the reference's, and the
three ranks put exactly those bytes on the wire (three point-to-point
messages), as the reference's tests/test_ot_mesh.py holds its compiled
program to.  The ranks' task is in torch_mesh_ranks.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core import RING32 as JRING
from repro.core import comm as jcomm
from repro.core.ot import ot3 as jot3
from repro.core.randomness import Parties as JParties
from repro_torch.core.party_group import PartyGroup
from repro_torch.weights import ring_from_numpy

N = 64
# (sender, receiver, helper): every rotation of the triangle
ROLES = [(1, 0, 2), (0, 2, 1), (2, 1, 0)]


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=90) as g:
        yield g


@pytest.mark.parametrize("sender,receiver,helper", ROLES)
def test_ot3_mesh_selection_and_wire_bytes(group, sender, receiver, helper):
    rng = np.random.default_rng(0)
    m0 = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    m1 = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    choice = rng.integers(0, 2, (3, N)).astype(np.uint8)
    got = group.run(ranks.ot_wire, (ring_from_numpy(m0), ring_from_numpy(m1),
                                    torch.as_tensor(choice), sender,
                                    receiver, helper))
    cslot = choice[(sender + 2) % 3].astype(bool)
    want = np.where(cslot, m1, m0)
    out = got[receiver]["out"].numpy().view(np.uint32)
    assert np.array_equal(out, want)
    # the reference's ot3 on the same inputs picks the same words and
    # meters the same row
    with jcomm.track() as jled:
        jout = jot3(jnp.asarray(m0), jnp.asarray(m1),
                    jnp.asarray(choice), (sender + 2) % 3, sender=sender,
                    receiver=receiver, helper=helper,
                    parties=JParties.setup(jax.random.PRNGKey(5)),
                    ring=JRING, tag="ot3")
    assert np.array_equal(np.asarray(jout), want)
    led = got[0]["ledger"]
    assert led["by_tag"]["ot3"] == [2, 3 * N * 4] == list(jled.by_tag["ot3"])
    wire = [g["wire"] for g in got]
    assert sum(w["nbytes"] for w in wire) == led["nbytes"] == 3 * N * 4
    assert sum(w["messages"] for w in wire) == 3
    assert wire[sender]["by_op"] == {"send": [2, 2 * N * 4]}
    assert wire[helper]["by_op"] == {"send": [1, N * 4]}
    assert wire[receiver]["nbytes"] == 0
