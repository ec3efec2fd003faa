"""The deployment matrix's per-query ledgers (DESIGN.md §11): for the
MNIST nets of the pinned table under every (weights, binary_linear), the
port's meta run gives the reference's ``secure_infer_cost`` rows, tag by
tag, at batch 1 and 32.  CifarNet2's are in
test_torch_secure_public_cifar{,_ledgers}.py."""
import pytest

from repro.core import secure_model as jsm
from repro.nn import bnn as jbnn
from repro_torch.core import secure_model
from test_torch_secure_model import _rows
from test_torch_secure_public import PINNED, _ledger, _port_model, _ref_model


def _assert_same_rows(net, weights, binary_linear):
    jm = _ref_model(net, weights, binary_linear)
    tm = _port_model(net, weights, binary_linear)
    for batch in (1, 32):
        shape = (batch,) + jbnn.INPUT_SHAPES[net]
        want = jsm.secure_infer_cost(jm, shape)
        assert _rows(secure_model.secure_infer_cost(tm, shape)) == _rows(want)
    assert _ledger(want) == PINNED[(net, weights, binary_linear)]


@pytest.mark.parametrize("net,weights,binary_linear",
                         [k for k in sorted(PINNED) if k[0] != "CifarNet2"])
def test_ledger_rows_match_reference(net, weights, binary_linear):
    _assert_same_rows(net, weights, binary_linear)
