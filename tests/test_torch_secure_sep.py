"""Separable nets (post-Sign depthwise on the grouped kernel): port
compile, ledger and opened logits == the JAX package's, bit for bit, for
MnistNet3-sep and the reference tests' tiny separable net."""
from test_torch_secure_model import (_assert_same_ledger, _assert_same_logits,
                                     _assert_same_model, _models,
                                     _register_sep_tiny)


def test_mnistnet3_sep_compile_and_ledger():
    jm, tm, _ = _models("MnistNet3-sep")
    _assert_same_model(jm, tm)
    _assert_same_ledger("MnistNet3-sep", jm, tm)


def test_mnistnet3_sep_logits_bit_identical():
    _assert_same_logits("MnistNet3-sep", 2)


def test_sep_tiny_bit_identical():
    _register_sep_tiny()
    jm, tm, _ = _models("SepTiny")
    _assert_same_model(jm, tm)
    _assert_same_ledger("SepTiny", jm, tm, batch=2)
    _assert_same_logits("SepTiny", 2)
