"""Port secure executor == the JAX package's: compile-time shares and path
labels, per-query ledgers, opened logits bit for bit, and the plaintext
forward.  The separable nets live in test_torch_secure_{sep,cifar}.py."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import share as jshare
from repro.core import secure_model as jsm
from repro.core.rss import RSS as JRSS
from repro.nn import bnn as jbnn
from repro_torch.core import prf, secure_model
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.kernels.bin_rss_matmul import GroupedWeightLimbs
from repro_torch.kernels.rss_matmul import WeightLimbs
from repro_torch.nn import bnn
from repro_torch.weights import (grid_quantize, params_from_numpy,
                                 ring_to_numpy)
from test_secure_model import _grid_input, _random_net_params

# the workers of a parallel run share the cores: one intra-op thread each
# (these tensors are small; oversubscribed thread pools cost far more)
torch.set_num_threads(1)

# per-query ledger (online rounds, bytes, offline rounds, bytes) of the
# shared-weight binary-engine path, as the reference measures it
PINNED = {
    ("MnistNet1", 1): (6, 10_992, 8, 9_216),
    ("MnistNet1", 32): (6, 351_744, 8, 294_912),
    ("MnistNet3", 1): (10, 812_928, None, None),
    ("MnistNet3", 32): (10, 26_013_696, None, None),
    ("MnistNet3-sep", 1): (11, 888_192, None, None),
    ("MnistNet3-sep", 32): (11, 28_422_144, None, None),
    ("CifarNet1", 1): (18, 7_508_208, None, None),
    ("CifarNet1", 32): (18, 240_262_656, None, None),
    ("CifarNet2", 1): (33, 4_958_448, 48, 3_234_816),
    ("CifarNet2", 32): (33, 158_670_336, 48, 103_514_112),
}

SEP_TINY = [jbnn.L("sepconv", 8, k=3, pad=1), jbnn.L("bn"),
            jbnn.L("act", act="sign"), jbnn.L("maxpool"), jbnn.L("flatten"),
            jbnn.L("fc", 10)]


def _register_sep_tiny():
    """The reference tests' tiny separable net, in both packages."""
    jbnn.ALL_NETS["SepTiny"] = SEP_TINY
    jbnn.INPUT_SHAPES["SepTiny"] = (8, 8, 3)
    bnn.ALL_NETS["SepTiny"] = [bnn.L(**vars(l)) for l in SEP_TINY]
    bnn.INPUT_SHAPES["SepTiny"] = (8, 8, 3)


def _np_params(net, seed=0):
    """Grid-quantised random parameters made with numpy: He-normal draws
    snapped as in the reference tests' ``_random_net_params``, so the
    secure run and the fp32 oracle make identical Sign decisions."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in bnn.init_bnn(0, net).items():
        shape = tuple(p.shape)
        if name.endswith("_var"):
            out[name] = np.full(shape, 1.0 - 1e-5, np.float32)
        elif name.endswith(("_mu", "_beta")):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        elif len(shape) > 1:
            w = rng.normal(0, math.sqrt(2.0 / math.prod(shape[:-1])), shape)
            out[name] = (np.round(w * 0.5 * 8) / 8).astype(np.float32)
        else:
            out[name] = np.full(shape, 1.0 / 256, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _port_model(net):
    return secure_model.compile_secure(params_from_numpy(_np_params(net)),
                                       net, prf.PRNGKey(2), RING32)


@functools.lru_cache(maxsize=None)
def _models(net):
    """(jax model, port model, numpy params) from the same parameters and
    the same sharing key.  The reference takes its plain route (its own
    tests pin its kernel and plain routes bit-identical; the kernels'
    weight caches are held equal in test_torch_kernels.py); the port takes
    its serving route, the kernel wrappers."""
    params = _np_params(net)
    jm = jsm.compile_secure(params, net, jax.random.PRNGKey(2), JRING)
    return jm, _port_model(net), params


def _rows(led):
    return ((led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes),
            sorted((k, tuple(v)) for k, v in led.by_tag.items()))


def _assert_same_model(jm, tm):
    assert [o["op"] for o in jm.ops] == [o["op"] for o in tm.ops]
    for jo, to in zip(jm.ops, tm.ops):
        assert jo.get("path") == to.get("path")
        assert jo.get("binary_in") == to.get("binary_in")
        for key in ("w", "b", "sign_threshold"):
            if key not in jo:
                continue
            ja, ta = jo[key], to[key]
            if ja is None:
                assert ta is None
                continue
            ja, ta = (ja, ta) if isinstance(ja, list) else ([ja], [ta])
            for a, b in zip(ja, ta):
                assert np.array_equal(np.asarray(a.shares),
                                      ring_to_numpy(b.shares))


def _assert_same_ledger(net, jm, tm, batch=1):
    shape = (batch,) + jbnn.INPUT_SHAPES[net]
    assert _rows(secure_model.secure_infer_cost(tm, shape)) == \
        _rows(jsm.secure_infer_cost(jm, shape))


def _assert_same_logits(net, batch, jit=True):
    """Opened logits bit-identical.  The reference runs jitted (one XLA
    compile instead of one per eager op; integer results are the same)
    except where its eager run is the quicker one."""
    jm, tm, _ = _models(net)
    x = _grid_input((batch,) + jbnn.INPUT_SHAPES[net], seed=2)
    jx = jshare(x, jax.random.PRNGKey(4), JRING)
    jp = JParties.setup(jax.random.PRNGKey(3))
    if jit:
        run = jax.jit(lambda keys, s: jsm.secure_infer(jm, JRSS(s, JRING),
                                                       JParties(keys)))
        want = np.asarray(run(jp.keys, jx.shares))
    else:
        want = np.asarray(jsm.secure_infer(jm, jx, jp))
    got = secure_model.secure_infer(
        tm, share(torch.from_numpy(x), prf.PRNGKey(4), RING32),
        Parties.setup(prf.PRNGKey(3)))
    assert got.dtype == torch.float32 and got.shape == (batch, 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("net", ["MnistNet1", "MnistNet3", "CifarNet1"])
def test_compile_and_ledger_match_reference(net):
    jm, tm, _ = _models(net)
    _assert_same_model(jm, tm)
    _assert_same_ledger(net, jm, tm)


@pytest.mark.parametrize("net,batch", sorted(PINNED))
def test_ledger_equals_pinned_table(net, batch):
    led = secure_model.secure_infer_cost(_port_model(net),
                                         (batch,) + bnn.INPUT_SHAPES[net])
    got = (led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes)
    want = PINNED[(net, batch)]
    assert got[:2] == want[:2]
    if want[2] is not None:
        assert got[2:] == want[2:]


def test_logits_bit_identical_mnistnet1():
    _assert_same_logits("MnistNet1", 2)


@pytest.mark.parametrize("net", ["MnistNet3-sep", "CifarNet2"])
@pytest.mark.parametrize("binarize", [True, False])
def test_bnn_forward_matches_reference(net, binarize):
    params = _np_params(net)
    if not binarize:   # unquantised He draws through tanh: smooth
        rng = np.random.default_rng(5)
        params = {k: (rng.normal(0, 0.3, v.shape).astype(np.float32)
                      if v.ndim > 1 else v) for k, v in params.items()}
    shape = (2,) + jbnn.INPUT_SHAPES[net]
    x = (_grid_input(shape, seed=3) if binarize else
         np.random.default_rng(3).normal(0, 1, shape).astype(np.float32))
    want, _ = jbnn.bnn_forward(params, jnp.asarray(x), net, train=False,
                               binarize=binarize)
    got, _ = bnn.bnn_forward(params_from_numpy(params), torch.from_numpy(x),
                             net, binarize=binarize)
    # float32 convolutions sum in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_grid_quantize_matches_reference_trick():
    params = jbnn.init_bnn(jax.random.PRNGKey(0), "MnistNet1")
    want = _random_net_params("MnistNet1")
    got = grid_quantize(params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}))
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("batch", [1, 32])
def test_mnistnet4_ledger_matches_reference(batch):
    """The ReLU teacher net (secure ReLU, secure_maxpool, BN folded into
    the linears) runs, with the reference's compile-time shares and
    per-query ledger rows.  Both round structures and public weights are
    in test_torch_secure_relu.py."""
    jm, tm, _ = _models("MnistNet4")
    _assert_same_model(jm, tm)
    _assert_same_ledger("MnistNet4", jm, tm, batch)


@pytest.mark.parametrize("net", ["MnistNet1", "CifarNet2"])
def test_compile_caches_kernel_operands(net):
    """Every linear weight part carries its kernel operands: dense parts a
    WeightLimbs over the (K, N) share stack, depthwise parts a
    GroupedWeightLimbs, so each layer on the card is one launch."""
    tm = _port_model(net)
    linear = [o for o in tm.ops if o["op"] in ("conv", "sepconv", "fc")]
    assert linear
    for op in linear:
        assert len(op["wlimbs"]) == len(op["w"])
        for j, (w, wl) in enumerate(zip(op["w"], op["wlimbs"])):
            if op["op"] == "sepconv" and j == 0:
                assert isinstance(wl, GroupedWeightLimbs)
                kh, kw, _, c = w.shape
                want = w.shares.reshape(3, kh * kw, c, 1).permute(0, 2, 1, 3)
            else:
                assert isinstance(wl, WeightLimbs)
                want = w.shares.reshape(3, -1, w.shape[-1])
            assert torch.equal(wl.ws, want)
