"""CifarNet2 (nine separable convs, both kernels' path): port compile,
ledger and opened logits == the JAX package's, bit for bit."""
from test_torch_secure_model import (_assert_same_ledger, _assert_same_logits,
                                     _assert_same_model, _models)


def test_cifarnet2_compile_and_ledger():
    jm, tm, _ = _models("CifarNet2")
    _assert_same_model(jm, tm)
    _assert_same_ledger("CifarNet2", jm, tm)


def test_cifarnet2_logits_bit_identical():
    _assert_same_logits("CifarNet2", 1, jit=False)
