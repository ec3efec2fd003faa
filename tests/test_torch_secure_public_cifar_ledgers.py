"""CifarNet2's per-query ledgers under public/off, shared/generic and
shared/off: the port's meta run gives the reference's rows, tag by tag,
at batch 1 and 32 (public/auto is in test_torch_secure_public_cifar.py)."""
import pytest

from test_torch_secure_public_ledgers import _assert_same_rows


@pytest.mark.parametrize("weights,binary_linear",
                         [("public", "off"), ("shared", "generic"),
                          ("shared", "off")])
def test_cifarnet2_ledger_rows_match_reference(weights, binary_linear):
    _assert_same_rows("CifarNet2", weights, binary_linear)
