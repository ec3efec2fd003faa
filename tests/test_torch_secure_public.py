"""The public-weight and binary-linear deployments of the port's secure
executor == the JAX package's: compile-time encodings, kernel caches and
path labels, the per-query ledgers of DESIGN.md §11's deployment matrix,
opened logits bit for bit, and the plaintext forward.  The reference's
ledger rows are held in test_torch_secure_public*_ledgers.py, the tiny
separable net's logits in test_torch_secure_public_sep.py and CifarNet2's
in test_torch_secure_public_cifar.py."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import secure_model as jsm
from repro.core import share as jshare
from repro.nn import bnn as jbnn
from repro_torch.core import prf, secure_model
from repro_torch.core.linear import PublicTensor
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.kernels.bin_rss_matmul import (PublicGroupedLimbs,
                                                PublicWeightLimbs)
from repro_torch.nn import bnn
from repro_torch.weights import params_from_numpy, ring_to_numpy
from test_secure_model import _grid_input
from test_torch_secure_model import _np_params, _register_sep_tiny

torch.set_num_threads(1)

# per-query ledger at batch 32 (online rounds, bytes, offline rounds,
# bytes) of each (net, weights, binary_linear), as the reference's
# secure_infer_cost gives it: 32 × the DESIGN.md §11 batch-1 rows
PINNED = {
    ("MnistNet1", "public", "auto"): (4, 249_600, 8, 294_912),
    ("MnistNet1", "public", "off"): (6, 302_592, 8, 294_912),
    ("MnistNet1", "shared", "generic"): (6, 351_744, 8, 294_912),
    ("MnistNet1", "shared", "off"): (6, 404_736, 8, 294_912),
    ("MnistNet3-sep", "public", "auto"): (8, 21_154_560, 20, 22_694_400),
    ("MnistNet3-sep", "public", "off"): (11, 22_401_024, 20, 22_694_400),
    ("MnistNet3-sep", "shared", "generic"): (11, 28_422_144, 20, 22_694_400),
    ("MnistNet3-sep", "shared", "off"): (12, 29_668_608, 20, 22_694_400),
    ("CifarNet2", "public", "auto"): (23, 102_043_392, 48, 103_514_112),
    ("CifarNet2", "public", "off"): (32, 125_640_192, 48, 103_514_112),
    ("CifarNet2", "shared", "generic"): (33, 158_670_336, 48, 103_514_112),
    ("CifarNet2", "shared", "off"): (41, 182_267_136, 48, 103_514_112),
}
MODES = [("public", "auto"), ("public", "off"), ("shared", "generic"),
         ("shared", "off")]


@functools.lru_cache(maxsize=None)
def _port_model(net, weights, binary_linear):
    return secure_model.compile_secure(
        params_from_numpy(_np_params(net)), net, prf.PRNGKey(2), RING32,
        weights=weights, binary_linear=binary_linear)


@functools.lru_cache(maxsize=None)
def _ref_model(net, weights, binary_linear, kernel_cache=False):
    """The reference's model from the same parameters and key; with
    ``kernel_cache`` it also caches the public limbs (an empty autotune
    cache path keeps it from reading one)."""
    return jsm.compile_secure(
        _np_params(net), net, jax.random.PRNGKey(2), JRING,
        use_kernel_dot=kernel_cache, weights=weights,
        binary_linear=binary_linear,
        autotune_cache="/nonexistent/autotune.json" if kernel_cache
        else None)


def _ledger(led):
    return (led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes)


def _assert_same_logits(net, weights, binary_linear, batch=2):
    """Opened logits bit-identical (the reference runs eagerly: quicker
    than one XLA compile per model here; integer results are the same)."""
    jm = _ref_model(net, weights, binary_linear)
    tm = _port_model(net, weights, binary_linear)
    x = _grid_input((batch,) + jbnn.INPUT_SHAPES[net], seed=2)
    jx = jshare(x, jax.random.PRNGKey(4), JRING)
    jp = JParties.setup(jax.random.PRNGKey(3))
    want = np.asarray(jsm.secure_infer(jm, jx, jp))
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert got.dtype == torch.float32 and got.shape == (batch, 10)
    assert np.array_equal(got.numpy(), want)


# -- compile ------------------------------------------------------------------

@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
def test_compile_public_matches_reference(net):
    """Encodings of every public weight, bias and threshold, the kernel
    caches (unpadded limbs, adaptive n_limbs) and the path labels."""
    jm = _ref_model(net, "public", "auto", kernel_cache=True)
    tm = _port_model(net, "public", "auto")
    assert tm.weights == "public" and tm.binary_linear == "auto"
    assert [o["op"] for o in jm.ops] == [o["op"] for o in tm.ops]
    n_linear = 0
    for jo, to in zip(jm.ops, tm.ops):
        assert jo.get("path") == to.get("path")
        assert jo.get("binary_in") == to.get("binary_in")
        if "pub_w" not in jo:
            continue
        n_linear += 1
        assert "w" not in to and "wlimbs" not in to
        for key in ("pub_b", "pub_thresh"):
            if jo[key] is None:
                assert to[key] is None
            else:
                assert np.array_equal(ring_to_numpy(to[key]), jo[key])
        for jw, tw in zip(jo["pub_w"], to["pub_w"]):
            assert isinstance(tw, PublicTensor)
            assert np.array_equal(ring_to_numpy(tw.enc), np.asarray(jw.enc))
            assert type(tw.limbs).__name__ == type(jw.limbs).__name__
            assert isinstance(tw.limbs, (PublicWeightLimbs,
                                         PublicGroupedLimbs))
            assert tw.limbs.n_limbs == jw.limbs.n_limbs
            assert np.array_equal(ring_to_numpy(tw.limbs.w),
                                  np.asarray(jw.limbs.w))
            # the reference's dense limbs are 128-padded, the port's not
            want = np.asarray(jw.limbs.wl)[
                (slice(None),) + tuple(slice(0, d) for d in tw.limbs.w.shape)]
            assert np.array_equal(tw.limbs.wl.numpy(), want)
    assert n_linear == sum(o["op"] in ("conv", "sepconv", "fc")
                           for o in tm.ops)


@pytest.mark.parametrize("weights,binary_linear", MODES)
def test_path_labels_match_reference(weights, binary_linear):
    for net in ("MnistNet1", "MnistNet3-sep"):
        jm = _ref_model(net, weights, binary_linear)
        tm = _port_model(net, weights, binary_linear)
        assert [(o.get("path"), o.get("binary_in")) for o in tm.ops] == \
            [(o.get("path"), o.get("binary_in")) for o in jm.ops]


def test_public_generic_is_rejected_as_in_the_reference():
    params = _np_params("MnistNet1")
    with pytest.raises(AssertionError, match="generic"):
        jsm.compile_secure(params, "MnistNet1", jax.random.PRNGKey(0),
                           JRING, weights="public", binary_linear="generic")
    with pytest.raises(ValueError, match="generic"):
        secure_model.compile_secure(params_from_numpy(params), "MnistNet1",
                                    prf.PRNGKey(0), RING32, weights="public",
                                    binary_linear="generic")
    for bad in ({"weights": "private"}, {"binary_linear": "on"}):
        with pytest.raises(ValueError):
            secure_model.compile_secure(params_from_numpy(params),
                                        "MnistNet1", prf.PRNGKey(0), RING32,
                                        **bad)


# -- ledgers ------------------------------------------------------------------

@pytest.mark.parametrize("net,weights,binary_linear", sorted(PINNED))
def test_ledger_equals_pinned_table(net, weights, binary_linear):
    led = secure_model.secure_infer_cost(
        _port_model(net, weights, binary_linear),
        (32,) + bnn.INPUT_SHAPES[net])
    assert _ledger(led) == PINNED[(net, weights, binary_linear)]


# -- values -------------------------------------------------------------------

@pytest.mark.parametrize("weights,binary_linear", MODES)
def test_logits_bit_identical_mnistnet1(weights, binary_linear):
    _assert_same_logits("MnistNet1", weights, binary_linear)


@pytest.mark.parametrize("binary_linear", ["auto", "off"])
@pytest.mark.parametrize("net", ["MnistNet1", "SepTiny"])
def test_public_secure_matches_plaintext(net, binary_linear):
    """With grid-quantised weights the public path gives the plaintext
    forward's logits to within the fixed-point noise."""
    if net == "SepTiny":
        _register_sep_tiny()
    params = params_from_numpy(_np_params(net))
    model = secure_model.compile_secure(params, net, prf.PRNGKey(0), RING32,
                                        weights="public",
                                        binary_linear=binary_linear)
    x = _grid_input((4,) + bnn.INPUT_SHAPES[net], seed=5)
    got = secure_model.secure_infer(
        model, share(torch.from_numpy(x), prf.PRNGKey(1), RING32),
        Parties.setup(prf.PRNGKey(2)))
    want, _ = bnn.bnn_forward(params, torch.from_numpy(x), net)
    assert float((got - want).abs().max()) < 0.05


def test_public_relu_net_ledger_matches_reference():
    """ReLU nets run under public weights too: MnistNet4's per-query
    ledger rows == the reference's."""
    shape = (1,) + bnn.INPUT_SHAPES["MnistNet4"]
    got = secure_model.secure_infer_cost(
        _port_model("MnistNet4", "public", "auto"), shape)
    want = jsm.secure_infer_cost(_ref_model("MnistNet4", "public", "auto"),
                                 shape)
    assert (_ledger(got), sorted((k, tuple(v)) for k, v in
                                 got.by_tag.items())) == \
        (_ledger(want), sorted((k, tuple(v)) for k, v in
                               want.by_tag.items()))
