"""The Sign nets under the paper-faithful round structure
(``set_fused_rounds(False)``): Sign by the Alg-4 OT, the un-fused
Sign→maxpool, every fixed-point linear layer (the pointwise half of a
sepconv included) as Alg 2's reshare plus its own truncation round.  The
port's ledgers and opened logits == the JAX package's."""
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
from repro_torch.weights import params_from_numpy
from test_secure_model import _grid_input
from test_torch_protocols_paper import set_modes  # noqa: F401  (fixture)
from test_torch_secure_model import _np_params, _rows

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(net, weights):
    p = _np_params(net)
    return (jsm.compile_secure(p, net, jax.random.PRNGKey(2), JRING,
                               weights=weights),
            secure_model.compile_secure(params_from_numpy(p), net,
                                        prf.PRNGKey(2), RING32,
                                        weights=weights))


@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3-sep"])
@pytest.mark.parametrize("weights", ["shared", "public"])
def test_paper_rounds_ledgers_match_reference(set_modes, net,  # noqa: F811
                                              weights):
    jm, tm = _models(net, weights)
    set_modes(fused=False)
    shape = (2,) + jbnn.INPUT_SHAPES[net]
    got = secure_model.secure_infer_cost(tm, shape)
    assert _rows(got) == _rows(jsm.secure_infer_cost(jm, shape))
    set_modes(fused=True)
    assert got.rounds > secure_model.secure_infer_cost(tm, shape).rounds


@pytest.mark.parametrize("mode", ["opt2", "paper3"])
def test_mnistnet1_paper_rounds_logits_bit_identical(set_modes,  # noqa: F811
                                                     mode):
    """Under "paper3" the reference (compiled here without its limb cache)
    splits each product into other additive parts than the port's
    cached-limb route, which the mode does not reach; every opened value,
    the logits included, is still the same."""
    set_modes(mode, fused=False)
    jm, tm = _models("MnistNet1", "shared")
    x = _grid_input((2,) + jbnn.INPUT_SHAPES["MnistNet1"], seed=2)
    want = np.asarray(jsm.secure_infer(
        jm, jshare(x, jax.random.PRNGKey(4), JRING),
        JParties.setup(jax.random.PRNGKey(3))))
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert np.array_equal(got.numpy(), want)
