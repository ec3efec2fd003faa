"""The bare-BN affine op (a BN with no linear before it to fold into), on a
tiny ad-hoc net ``conv 4 → relu → bn → sign → flatten → fc 4``:

* public weights, fused and paper-faithful rounds: opened logits == the
  JAX package's, bit for bit;
* shared weights: the reference adds the (3, C) shift stack to the
  (3, B, ..., C) activation as it is, which fails to broadcast (or, at
  batch 1 with a 2-D activation, mixes the party and batch axes), so the
  expected shares are built from the reference's own pieces (its
  ``mul_truncate``, or ``mul`` + ``truncate``) with the shift added over
  the party axis; the port's secure logits are also held to its plaintext
  forward.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import linear as jlinear
from repro.core import secure_model as jsm
from repro.core import share as jshare
from repro.core.rss import RSS as JRSS
from repro.nn import bnn as jbnn
from repro_torch.core import prf, secure_model
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.nn import bnn
from repro_torch.weights import params_from_numpy
from test_torch_protocols import _floats, _parties, _run, _same, _shared
from test_torch_protocols_paper import set_modes  # noqa: F401  (fixture)
from test_torch_secure_model import _np_params

torch.set_num_threads(1)

NET = "BareBN"
SPEC = [jbnn.L("conv", 4, k=3, pad=1), jbnn.L("act", act="relu"),
        jbnn.L("bn"), jbnn.L("act", act="sign"), jbnn.L("flatten"),
        jbnn.L("fc", 4)]
AFFINE = 2   # the op index of the bare BN


def _register():
    jbnn.ALL_NETS[NET] = SPEC
    jbnn.INPUT_SHAPES[NET] = (8, 8, 1)
    bnn.ALL_NETS[NET] = [bnn.L(**vars(l)) for l in SPEC]
    bnn.INPUT_SHAPES[NET] = (8, 8, 1)


@functools.lru_cache(maxsize=None)
def _params():
    """Grid weights as the other nets' tests, and a BN that does work:
    gains in {1, 2}, shifts −k/16 − 1/32, so every pre-Sign value keeps at
    least 6/256 from the boundary (conv outputs sit on the 1/16 grid plus
    the 1/256 bias) and both signs occur."""
    _register()
    p = _np_params(NET)
    rng = np.random.default_rng(9)
    p["l2_g"] = rng.integers(1, 3, 4).astype(np.float32)
    p["l2_beta"] = (-rng.integers(0, 9, 4) / 16 - 1 / 32).astype(np.float32)
    return p


@functools.lru_cache(maxsize=None)
def _models(weights):
    p = _params()
    jm = jsm.compile_secure(p, NET, jax.random.PRNGKey(2), JRING,
                            weights=weights)
    tm = secure_model.compile_secure(params_from_numpy(p), NET,
                                     prf.PRNGKey(2), RING32, weights=weights)
    assert [o["op"] for o in tm.ops][AFFINE] == "affine"
    return jm, tm


def _input(batch=2):
    return np.random.default_rng(4).integers(0, 2, (batch, 8, 8, 1)) \
        .astype(np.float32) - 0.5


@pytest.mark.parametrize("fused", [True, False])
def test_public_affine_net_logits_bit_identical(set_modes,  # noqa: F811
                                                fused):
    set_modes(fused=fused)
    jm, tm = _models("public")
    x = _input()
    want = np.asarray(jsm.secure_infer(
        jm, jshare(x, jax.random.PRNGKey(4), JRING),
        JParties.setup(jax.random.PRNGKey(3))))
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 4), (3, 4)])
def test_shared_affine_equals_reference_pieces(set_modes, fused,  # noqa: F811
                                               shape):
    """The port's shared affine op == the reference's multiply (+
    truncation) shares with the shift added per party slot, and the same
    ledger rows."""
    set_modes(fused=fused)
    jm, tm = _models("shared")
    jop, top = jm.ops[AFFINE], tm.ops[AFFINE]
    for key in ("scale", "shift"):
        _same(jop[key], top[key])
    jh, th = _shared(_floats(shape, 11, 2.0), 11)
    jp, tp = _parties(12)
    tag = f"aff{AFFINE}"

    def reference():
        if fused:
            h = jlinear.mul_truncate(jh, jop["scale"], jp, tag=tag)
        else:
            h = jlinear.truncate(jlinear.mul(jh, jop["scale"], jp, tag=tag),
                                 jp, tag=tag + ".tr")
        shift = jop["shift"].shares.reshape(
            (3,) + (1,) * (len(shape) - 1) + (-1,))
        return JRSS(h.shares + shift, JRING)

    jo, to = _run(reference,
                  lambda: secure_model._infer_affine(th, top, tp, AFFINE,
                                                     RING32, "shared"))
    assert to.shape == shape
    _same(jo, to)


@pytest.mark.parametrize("weights", ["shared", "public"])
@pytest.mark.parametrize("fused", [True, False])
def test_affine_net_secure_matches_plaintext(set_modes, weights,  # noqa: F811
                                             fused):
    set_modes(fused=fused)
    _, tm = _models(weights)
    x = _input(4)
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(1), RING32),
        Parties.setup(prf.PRNGKey(2)))
    want, _ = bnn.bnn_forward(params_from_numpy(_params()),
                              torch.from_numpy(x), NET)
    assert got.shape == (4, 4)
    assert float((got - want).abs().max()) < 0.25
