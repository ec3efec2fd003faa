"""CifarNet7's opened logits: bit-identical to the JAX package's at batch 1
(shared weights, fused rounds; the reference runs eagerly, ~1 min on one
core), and within the reference's ReLU-net bound of the unbinarized
plaintext forward under both weight modes and both round structures."""
import jax
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import secure_model as jsm
from repro.core import share as jshare
from repro_torch.core import prf, secure_model
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.nn import bnn
from repro_torch.weights import params_from_numpy
from test_torch_protocols_paper import set_modes  # noqa: F401  (fixture)
from test_torch_secure_relu import _np_params, _port_model, _ref_model

torch.set_num_threads(1)


def _x(batch):
    return np.random.default_rng(3).normal(0, 0.3, (batch, 32, 32, 3)) \
        .astype(np.float32)


def test_cifarnet7_logits_bit_identical():
    x = _x(1)
    want = np.asarray(jsm.secure_infer(
        _ref_model("CifarNet7", "shared"),
        jshare(x, jax.random.PRNGKey(4), JRING),
        JParties.setup(jax.random.PRNGKey(3))))
    got = secure_model.secure_infer(
        _port_model("CifarNet7", "shared"),
        share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert got.shape == (1, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", ["shared", "public"])
@pytest.mark.parametrize("fused", [True, False])
def test_cifarnet7_secure_matches_plaintext(set_modes, weights,  # noqa: F811
                                            fused):
    """Within 0.25 of the unbinarized plaintext forward (logits of
    magnitude ~1), the bound of the reference's ReLU-net test."""
    set_modes(fused=fused)
    x = _x(2)
    got = secure_model.secure_infer(
        _port_model("CifarNet7", weights),
        share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    want, _ = bnn.bnn_forward(params_from_numpy(_np_params("CifarNet7")),
                              torch.from_numpy(x), "CifarNet7",
                              binarize=False)
    assert float(want.abs().max()) > 0.1
    assert float((got - want).abs().max()) < 0.25
