"""CifarNet2 (nine separable convs, both public kernels' path) under
public weights: port compile, ledger rows and opened logits == the JAX
package's, bit for bit."""
import numpy as np

from repro.core import secure_model as jsm
from repro.nn import bnn as jbnn
from repro_torch.core import secure_model
from repro_torch.weights import ring_to_numpy
from test_torch_secure_model import _rows
from test_torch_secure_public import (PINNED, _assert_same_logits, _ledger,
                                      _port_model, _ref_model)


def test_cifarnet2_public_compile_and_ledger():
    jm = _ref_model("CifarNet2", "public", "auto")
    tm = _port_model("CifarNet2", "public", "auto")
    for jo, to in zip(jm.ops, tm.ops):
        assert jo.get("path") == to.get("path")
        for jw, tw in zip(jo.get("pub_w", []), to.get("pub_w", [])):
            assert np.array_equal(ring_to_numpy(tw.enc), np.asarray(jw.enc))
    for batch in (1, 32):
        shape = (batch,) + jbnn.INPUT_SHAPES["CifarNet2"]
        want = jsm.secure_infer_cost(jm, shape)
        assert _rows(secure_model.secure_infer_cost(tm, shape)) == _rows(want)
    assert _ledger(want) == PINNED[("CifarNet2", "public", "auto")]


def test_cifarnet2_public_logits_bit_identical():
    _assert_same_logits("CifarNet2", "public", "auto", batch=1)
