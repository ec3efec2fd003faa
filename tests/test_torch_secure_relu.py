"""The ReLU teacher net MnistNet4 (ReLU, secure maxpool, BN folded into
the linears) in the port's secure executor == the JAX package's: per-query
ledgers under both weight modes and both round structures at batch 1 and
32, the pinned batch-32 table, opened logits bit for bit under fused and
paper-faithful rounds, and closeness to the plaintext forward.  CifarNet7's
ledgers are in test_torch_secure_relu_cifar.py, the bare-BN affine op in
test_torch_secure_affine.py."""
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
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.nn import bnn
from repro_torch.weights import params_from_numpy
from test_torch_protocols_paper import set_modes  # noqa: F401  (fixture)
from test_torch_secure_model import _rows

torch.set_num_threads(1)

# per-query (online rounds, bytes) at batch 32 of init_bnn weights compiled
# with PRNGKey(1), as the reference's secure_infer_cost gives them:
# (net, weights, fused rounds) -> ledger
PINNED = {
    ("MnistNet4", "shared", True): (23, 105_762_048),
    ("MnistNet4", "shared", False): (54, 156_732_672),
    ("MnistNet4", "public", True): (23, 91_110_912),
    ("MnistNet4", "public", False): (50, 142_081_536),
    ("CifarNet7", "shared", True): (59, 626_208_000),
    ("CifarNet7", "shared", False): (140, 904_998_144),
    ("CifarNet7", "public", True): (59, 522_198_528),
    ("CifarNet7", "public", False): (128, 800_988_672),
}


@functools.lru_cache(maxsize=None)
def _np_params(net):
    """He-normal weights and identity BN (the port's init_bnn, seed 0) as
    numpy arrays.  No grid: ReLU is continuous, so the secure logits stay
    within the fixed-point noise of the plaintext forward, and they carry
    signal (a grid would round the fc weights to zero)."""
    return {k: v.numpy() for k, v in bnn.init_bnn(0, net).items()}


@functools.lru_cache(maxsize=None)
def _port_model(net, weights):
    return secure_model.compile_secure(params_from_numpy(_np_params(net)),
                                       net, prf.PRNGKey(2), RING32,
                                       weights=weights)


@functools.lru_cache(maxsize=None)
def _ref_model(net, weights):
    return jsm.compile_secure(_np_params(net), net, jax.random.PRNGKey(2),
                              JRING, weights=weights)


def assert_same_ledgers(net, weights, fused, set_modes):  # noqa: F811
    """Both packages' secure_infer_cost rows at batch 1 and 32."""
    jm, tm = _ref_model(net, weights), _port_model(net, weights)
    set_modes(fused=fused)
    for batch in (1, 32):
        shape = (batch,) + jbnn.INPUT_SHAPES[net]
        assert _rows(secure_model.secure_infer_cost(tm, shape)) == \
            _rows(jsm.secure_infer_cost(jm, shape))


@pytest.mark.parametrize("weights", ["shared", "public"])
@pytest.mark.parametrize("fused", [True, False])
def test_mnistnet4_ledgers_match_reference(set_modes, weights,  # noqa: F811
                                           fused):
    assert_same_ledgers("MnistNet4", weights, fused, set_modes)


@pytest.mark.parametrize("net,weights,fused", sorted(PINNED))
def test_relu_ledger_equals_pinned_table(set_modes, net, weights,  # noqa: F811
                                         fused):
    from repro_torch.launch.serve_secure import build
    model = build(net, device="cpu", weights=weights)
    set_modes(fused=fused)
    led = secure_model.secure_infer_cost(model, (32,) + bnn.INPUT_SHAPES[net])
    assert (led.rounds, led.nbytes) == PINNED[(net, weights, fused)]


@pytest.mark.parametrize("fused", [True, False])
def test_mnistnet4_logits_bit_identical(set_modes, fused):  # noqa: F811
    """Batch 1, shared weights; the reference runs eagerly."""
    set_modes(fused=fused)
    jm, tm = _ref_model("MnistNet4", "shared"), \
        _port_model("MnistNet4", "shared")
    x = np.random.default_rng(3).normal(0, 0.3, (1, 28, 28, 1)) \
        .astype(np.float32)
    want = np.asarray(jsm.secure_infer(
        jm, jshare(x, jax.random.PRNGKey(4), JRING),
        JParties.setup(jax.random.PRNGKey(3))))
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert got.shape == (1, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", ["shared", "public"])
@pytest.mark.parametrize("fused", [True, False])
def test_mnistnet4_secure_matches_plaintext(set_modes, weights,  # noqa: F811
                                            fused):
    """The reference's ReLU-net bound (tests/test_secure_model.py): within
    0.25 of the unbinarized plaintext forward (logits of magnitude ~1)."""
    set_modes(fused=fused)
    params = params_from_numpy(_np_params("MnistNet4"))
    x = np.random.default_rng(3).normal(0, 0.3, (2, 28, 28, 1)) \
        .astype(np.float32)
    got = secure_model.secure_infer(
        _port_model("MnistNet4", weights),
        share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    want, _ = bnn.bnn_forward(params, torch.from_numpy(x), "MnistNet4",
                              binarize=False)
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max()) < 0.25
