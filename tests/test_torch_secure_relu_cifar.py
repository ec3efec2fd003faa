"""CifarNet7 (the ReLU VGG teacher: ten convs, secure maxpool, fc → BN
folded): the port's per-query ledgers == the JAX package's under both
weight modes and both round structures, at batch 1 and 32."""
import pytest

from test_torch_protocols_paper import set_modes  # noqa: F401  (fixture)
from test_torch_secure_relu import assert_same_ledgers


@pytest.mark.parametrize("weights", ["shared", "public"])
@pytest.mark.parametrize("fused", [True, False])
def test_cifarnet7_ledgers_match_reference(set_modes, weights,  # noqa: F811
                                           fused):
    assert_same_ledgers("CifarNet7", weights, fused, set_modes)
