"""The party x data batch axis of the port's mesh
(``make_secure_infer_mesh(..., data=2)``: 3 x 2 gloo CPU ranks, each data
shard's three parties a process group of their own) against the
reference's own batch-axis run (``batch_axis="data"`` on a (3, 2)
("party", "data") mesh of fake host devices, in a subprocess).

The reference's shard body starts every shard's parties from the same
keys and counter, so its batch-axis logits equal its ``secure_infer`` of
each batch shard, concatenated: the subprocess checks that, bit for bit,
and the port is held to those logits bit for bit (not to a whole-batch
run, from which a shard's PRF words differ by the truncation's ulps).
Also: each rank's wire summed over the six ranks equals the ledger of a
shard's query times the two shards, and the reference's two refusals (no
tape, no verifier with a batch axis) hold.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.nn import bnn as jbnn
from repro_torch.core import integrity, prf, secure_model
from repro_torch.core.party_group import PartyGroup
from repro_torch.core.preprocessing import trace_material
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS, share
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CASES = [("MnistNet1", "shared", 4), ("MnistNet1", "public", 4)]

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
import sys
import numpy as np
import jax
from repro.core import RING32, Parties, share
from repro.core.secure_model import (compile_secure, secure_infer,
                                     secure_infer_mesh)
from repro.nn import bnn

mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:6]).reshape(3, 2),
                         ("party", "data"))
out = {}
for net, weights, batch in CASES:
    params = bnn.init_bnn(jax.random.PRNGKey(0), net)
    x = (np.random.default_rng(1).integers(
        0, 2, (batch,) + bnn.INPUT_SHAPES[net]).astype(np.float32) - 0.5)
    model = compile_secure(params, net, jax.random.PRNGKey(2), RING32,
                           use_kernel_dot=True, weights=weights)
    xs = share(x, jax.random.PRNGKey(4), RING32)
    msh = np.asarray(secure_infer_mesh(
        model, xs, Parties.setup(jax.random.PRNGKey(3)), mesh,
        batch_axis="data"))
    h = batch // 2
    shards = [np.asarray(secure_infer(
        model, type(xs)(xs.shares[:, i * h:(i + 1) * h], xs.ring),
        Parties.setup(jax.random.PRNGKey(3)))) for i in range(2)]
    assert np.array_equal(msh, np.concatenate(shards)), (net, weights)
    out[f"{net}-{weights}"] = msh
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    script = d / "batch_axis.py"
    script.write_text(f"CASES = {CASES!r}\n" + SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=600,
                       env=env, cwd=str(REPO))
    assert r.returncode == 0 and "REF_OK" in r.stdout, \
        f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-3000:]}"
    with np.load(d / "out.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def group():
    with PartyGroup("cpu", timeout=60, deadline=120, ranks=6) as g:
        yield g


def _model(net, weights, batch):
    params = {k: np.asarray(v) for k, v in
              jbnn.init_bnn(jax.random.PRNGKey(0), net).items()}
    tm = secure_model.compile_secure(params_from_numpy(params), net,
                                     prf.PRNGKey(2), RING32, weights=weights)
    x = (np.random.default_rng(1).integers(
        0, 2, (batch,) + jbnn.INPUT_SHAPES[net]).astype(np.float32) - 0.5)
    return tm, share(torch.as_tensor(x), prf.PRNGKey(4), RING32)


@pytest.mark.parametrize("net,weights,batch", CASES)
def test_batch_axis_equals_reference_batch_axis(group, reference, net,
                                                weights, batch):
    tm, xs = _model(net, weights, batch)
    keys = Parties.setup(prf.PRNGKey(3)).keys
    run = secure_model.make_secure_infer_mesh(tm, group, data=2)
    try:
        got = run(keys, xs.shares)
        ranks = run.last["ranks"]
    finally:
        run.close()
    assert np.array_equal(got.numpy(), reference[f"{net}-{weights}"])
    # == the port's own local run of each shard, concatenated
    h = batch // 2
    local = torch.cat([secure_model.secure_infer(
        tm, RSS(xs.shares[:, i * h:(i + 1) * h], RING32),
        Parties.setup(prf.PRNGKey(3))) for i in range(2)])
    assert torch.equal(got, local)
    # the wire of all six ranks == a shard's ledger x 2 shards
    led = ranks[0]["queries"][0]["ledger"]
    wire = sum(rk["queries"][0]["wire"]["nbytes"] for rk in ranks)
    assert wire == 2 * (led["nbytes"] + led["pre_nbytes"])
    assert all(rk["queries"][0]["wire"]["nbytes"] > 0 for rk in ranks)


def test_batch_axis_refusals(group):
    tm, xs = _model("MnistNet1", "shared", 4)
    spec = trace_material(tm, (4,) + jbnn.INPUT_SHAPES["MnistNet1"])
    with pytest.raises(ValueError, match="tape"):
        secure_model.make_secure_infer_mesh(tm, group, tape_spec=spec,
                                            data=2)
    with pytest.raises(ValueError, match="verified"):
        secure_model.make_secure_infer_mesh(
            tm, group, verifier=integrity.Verifier("opens"), data=2)
    with pytest.raises(ValueError, match="6"):
        secure_model.make_secure_infer_mesh(tm, group)     # data=1: 3 ranks
    run = secure_model.make_secure_infer_mesh(tm, group, data=2)
    try:
        with pytest.raises(ValueError, match="split"):
            run.prepare(xs.shares[:, :3])
    finally:
        run.close()
