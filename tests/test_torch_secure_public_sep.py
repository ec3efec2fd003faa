"""The reference tests' tiny separable net under public weights and the
generic routing: ledger rows and opened logits == the JAX package's, bit
for bit."""
import pytest

from repro.core import secure_model as jsm
from repro.nn import bnn as jbnn
from repro_torch.core import secure_model
from test_torch_secure_model import _register_sep_tiny, _rows
from test_torch_secure_public import (_assert_same_logits, _port_model,
                                      _ref_model)


@pytest.mark.parametrize("weights,binary_linear",
                         [("public", "auto"), ("public", "off"),
                          ("shared", "generic")])
def test_sep_tiny_bit_identical(weights, binary_linear):
    """The tiny separable net: its post-Sign depthwise half on B4 (public)
    or, under "generic", on the plain Alg-2 round without a truncation."""
    _register_sep_tiny()
    jm = _ref_model("SepTiny", weights, binary_linear)
    tm = _port_model("SepTiny", weights, binary_linear)
    shape = (2,) + jbnn.INPUT_SHAPES["SepTiny"]
    assert _rows(secure_model.secure_infer_cost(tm, shape)) == \
        _rows(jsm.secure_infer_cost(jm, shape))
    _assert_same_logits("SepTiny", weights, binary_linear)
