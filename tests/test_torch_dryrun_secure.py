"""The port's secure-plane check (``repro_torch.launch.dryrun_secure``):
one secure FFN pair in the paper's 3-product Algorithm 2 against the
fused-operand 2-product form.

The reference verifies the fused operand's one-third cut in the compiled
HLO's FLOPs of a 256-chip program; the port counts the ring products
through the protocols' per-party ``dot``: 18 against 12 for the pair,
exactly 1.5 : 1 in products and in multiply-adds, the same ledger.  The
pair is also held to the reference's own protocols (``repro.core``) on
the same shares and keys in both modes: identical output shares and
ledger rows.  (The reference's ``launch/dryrun_secure.py`` itself is not
imported: it sets a 512-device XLA flag when imported.)
"""
import pytest
import torch

from repro.core import activation as jact
from repro.core import linear as jlinear
from repro.kernels import ops as jops
from repro_torch.core import linear
from repro_torch.kernels import ops
from repro_torch.launch import dryrun_secure
from test_torch_protocols import _floats, _parties, _run, _same, _shared

torch.set_num_threads(1)

T, D, DFF = 8, 16, 32


@pytest.fixture
def restore_modes():
    try:
        yield
    finally:
        for lin in (jlinear, linear):
            lin.set_matmul_mode("opt2")


def test_paper3_over_opt2_is_one_and_a_half(restore_modes):
    linear.set_matmul_mode("paper3")            # restored as found
    res = dryrun_secure.run(T, D, DFF, device="cpu", reps=1)
    assert linear._MATMUL_MODE == "paper3"
    assert res["paper3_over_opt2_products"] == 1.5
    assert res["paper3_over_opt2_macs"] == 1.5
    assert (res["paper3"]["products"], res["opt2"]["products"]) == (18, 12)
    assert res["opt2"]["macs"] == 3 * 2 * (T * D * DFF + T * DFF * D)
    assert res["paper3"]["ledger"] == res["opt2"]["ledger"]
    # the fused route makes no per-party product; on the CPU no launch
    assert res["fused"]["products"] == 0
    assert all(not res[m]["launches"] for m in ("paper3", "opt2", "fused"))


@pytest.mark.parametrize("mode", ["paper3", "opt2"])
def test_ffn_pair_equals_reference(restore_modes, mode):
    for lin in (jlinear, linear):
        lin.set_matmul_mode(mode)
    (jx, tx) = _shared(_floats((T, D), 1), 1)
    (jw1, tw1) = _shared(_floats((D, DFF), 2, D ** -0.5), 2)
    (jw2, tw2) = _shared(_floats((DFF, D), 3, DFF ** -0.5), 3)
    jp, tp = _parties(7)

    def ref():
        h = jlinear.truncate(jlinear.matmul(jx, jw1, jp, tag="ffn.up",
                                            dot=jops.rss_matmul_dot), jp)
        h = jact.secure_relu(h, jp, tag="ffn.relu")
        return jlinear.truncate(jlinear.matmul(h, jw2, jp, tag="ffn.down",
                                               dot=jops.rss_matmul_dot), jp)

    step = dryrun_secure.build_step(ops.rss_matmul_dot)
    jo, to = _run(ref, lambda: step(tp, tx, tw1, tw2))
    _same(jo, to)
