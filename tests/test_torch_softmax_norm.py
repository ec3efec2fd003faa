"""The port's secure softmax and RMSNorm == the JAX package's: with the same
keys and inputs, identical shares and identical ledger rows (tag, rounds,
bytes), on RING32 and on RING64 (the reference under ``jax.enable_x64``).

Shapes are those of the reference's own tests (``tests/test_nonlinear.py``
and the property tests of ``tests/test_property.py``) at fixed seeds; the
inputs are made with numpy.  The property tests' bounds are checked on the
port's outputs too: the reference meets them at these seeds, so the pins
hold the reference's values, not only the bounds."""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING32
from repro.core import RING64 as JRING64
from repro.core import Parties as JParties
from repro.core import comm as jcomm
from repro.core import linear as jlinear
from repro.core import norm as jnorm
from repro.core import softmax as jsoftmax
from repro.core.rss import reconstruct as jreconstruct
from repro.core.rss import share as jshare
from repro_torch.core import comm, linear, norm, prf, softmax
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32, RING64
from repro_torch.core.rss import reconstruct, share

torch.set_num_threads(1)

RINGS = {32: (JRING32, RING32), 64: (JRING64, RING64)}


def _ctx(bits):
    """RING64 needs the reference's 64-bit lanes."""
    return jax.enable_x64(True) if bits == 64 else nullcontext()


def _bound_bits(ring):
    """The property tests' MSB envelope: 18 at f = 12, frac + 6 at f = 20."""
    return 18 if ring.bits == 32 else ring.frac + 6


def _same(j, t):
    j = np.asarray(getattr(j, "shares", j))
    t = getattr(t, "shares", t)
    if t.dtype == torch.int64:
        assert np.array_equal(j, t.numpy().view(np.uint64))
    else:
        assert np.array_equal(j, t.numpy().view(np.uint32))


def _rows(led):
    return ((led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes),
            sorted((k, tuple(v)) for k, v in led.by_tag.items()))


def _run(bits, jfn, tfn, seeds, xs):
    """Share ``xs`` under ``seeds`` on both sides, run each side's function
    on (shares, parties) under a ledger; assert identical shares and rows.
    Returns (reference plaintext, port plaintext) of the output."""
    jring, tring = RINGS[bits]
    with _ctx(bits):
        jin = [jshare(jnp.asarray(x), jax.random.PRNGKey(s), jring)
               for x, s in zip(xs, seeds)]
        jp = JParties.setup(jax.random.PRNGKey(seeds[0] + 1))
        with jcomm.track() as jl:
            jout = jfn(*jin, jp)
        jdec = np.asarray(jreconstruct(jout))
        jout = np.asarray(jout.shares)
    tin = [share(torch.from_numpy(x), prf.PRNGKey(s), tring)
           for x, s in zip(xs, seeds)]
    tp = Parties.setup(prf.PRNGKey(seeds[0] + 1))
    with comm.track() as tl:
        tout = tfn(*tin, tp)
    _same(jout, tout)
    assert _rows(tl) == _rows(jl)
    got = reconstruct(tout).numpy()
    assert np.array_equal(got, jdec)
    return jdec, got


@pytest.fixture
def fused_off():
    """Paper rounds in both packages for one test (process globals)."""
    jlinear.set_fused_rounds(False)
    linear.set_fused_rounds(False)
    try:
        yield
    finally:
        jlinear.set_fused_rounds(True)
        linear.set_fused_rounds(True)


def _f(shape, seed, scale=1.0, kind="normal"):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, shape) if kind == "normal" \
        else rng.uniform(-1, 1, shape)
    return (v * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# _mul_tr / _sq_tr, fused and paper rounds; apply_sign_bn_shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "paper"])
def test_mul_sq_tr_identical(bits, fused, request):
    if not fused:
        request.getfixturevalue("fused_off")
    x, y = _f((5, 6), 1, 2.0), _f((5, 6), 2, 2.0)
    _run(bits, lambda a, b, p: jnorm._mul_tr(a, b, p, "mt"),
         lambda a, b, p: norm._mul_tr(a, b, p, "mt"), (3, 4), (x, y))
    jring = RINGS[bits][0]
    _run(bits, lambda a, p: jnorm._sq_tr(a, p, "sq", frac=jring.frac + 1),
         lambda a, p: norm._sq_tr(a, p, "sq", frac=RINGS[bits][1].frac + 1),
         (5,), (x,))


def test_apply_sign_bn_shift_identical():
    x, t = _f((2, 3, 3, 4), 7), _f((4,), 8)
    _run(32, lambda a, b, p: jnorm.apply_sign_bn_shift(a, b),
         lambda a, b, p: norm.apply_sign_bn_shift(a, b), (9, 10), (x, t))


# ---------------------------------------------------------------------------
# The Newton ladders and RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64])
def test_newton_reciprocal_identical(bits):
    d = np.random.default_rng(11).uniform(0.5, 16, (6,)).astype(np.float32)
    _, got = _run(bits, lambda a, p: jnorm.newton_reciprocal(a, p),
                  lambda a, p: norm.newton_reciprocal(a, p), (12,), (d,))
    assert np.abs(got - 1 / d).max() < 0.01


@pytest.mark.parametrize("bits", [32, 64])
def test_newton_rsqrt_identical(bits):
    d = np.random.default_rng(13).uniform(0.05, 8, (6,)).astype(np.float32)
    _, got = _run(bits, lambda a, p: jnorm.newton_rsqrt(a, p),
                  lambda a, p: norm.newton_rsqrt(a, p), (14,), (d,))
    assert np.abs(got - 1 / np.sqrt(d)).max() < 0.01


@pytest.mark.parametrize("bits,n,d,scale,seed", [
    (32, 4, 32, 1.0, 0),      # tests/test_nonlinear.py's shape
    (32, 3, 16, 1.7, 21),     # property-test draws
    (64, 2, 8, 0.5, 22),
    (64, 1, 32, 1.2, 23),
])
def test_secure_rmsnorm_identical(bits, n, d, scale, seed):
    x = _f((n, d), seed, scale)
    ms = (x * x).mean(-1)
    assert 0.05 < ms.min() and ms.max() < 8   # the Newton envelope
    g = np.random.default_rng(seed + 100).uniform(0.5, 1.5, (d,)) \
        .astype(np.float32)
    _, got = _run(bits, lambda a, b, p: jnorm.secure_rmsnorm(a, b, p),
                  lambda a, b, p: norm.secure_rmsnorm(a, b, p),
                  (seed, seed + 2), (x, g))
    want = x / np.sqrt(ms[:, None] + 1e-5) * g
    assert np.abs(got - want).max() < 0.02


def test_secure_rmsnorm_paper_rounds_identical(fused_off):
    x = _f((2, 16), 24, 0.8)
    g = np.ones((16,), np.float32)
    _run(32, lambda a, b, p: jnorm.secure_rmsnorm(a, b, p),
         lambda a, b, p: norm.secure_rmsnorm(a, b, p), (25, 26), (x, g))


# ---------------------------------------------------------------------------
# softmax.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64])
def test_secure_exp_identical(bits):
    z = (-np.random.default_rng(30).uniform(0, 1, (64,)) * 8) \
        .astype(np.float32)                    # tests/test_nonlinear.py
    _, got = _run(bits, lambda a, p: jsoftmax.secure_exp(a, p),
                  lambda a, p: softmax.secure_exp(a, p), (31,), (z,))
    assert np.abs(got - np.exp(z)).max() < 0.06


@pytest.mark.parametrize("bits,rows,last,scale,seed", [
    (32, 4, 8, 2.0, 40),      # tests/test_nonlinear.py's shape
    (32, 3, 5, 4.0, 41),      # property-test draws (odd width: a carry)
    (64, 2, 7, 3.0, 42),
    (64, 1, 2, 0.25, 43),
])
def test_secure_softmax_identical(bits, rows, last, scale, seed):
    x = _f((rows, last), seed, scale, "uniform")
    bb = _bound_bits(RINGS[bits][0])
    _, got = _run(bits,
                  lambda a, p: jsoftmax.secure_softmax(a, p, bound_bits=bb),
                  lambda a, p: softmax.secure_softmax(a, p, bound_bits=bb),
                  (seed,), (x,))
    e = np.exp(x - x.max(-1, keepdims=True))
    assert np.abs(got - e / e.sum(-1, keepdims=True)).max() < 0.02
    assert np.abs(got.sum(-1) - 1).max() < 0.02


def test_secure_softmax_paper_rounds_identical(fused_off):
    x = _f((2, 4), 44, 2.0)
    _run(32, lambda a, p: jsoftmax.secure_softmax(a, p),
         lambda a, p: softmax.secure_softmax(a, p), (45,), (x,))


@pytest.mark.parametrize("bits,shape,scale,seed", [
    (32, (2, 3, 8), 4.0, 50),
    (32, (1, 1, 2), 0.25, 51),
    (64, (2, 4, 5), 2.0, 52),
    (64, (1, 2, 8), 1.0, 53),
])
def test_relu_attention_scores_identical(bits, shape, scale, seed):
    x = _f(shape, seed, scale, "uniform")
    s = shape[-1]
    jring = RINGS[bits][0]
    bb = _bound_bits(jring)
    _, got = _run(bits,
                  lambda a, p: jsoftmax.relu_attention_scores(
                      a, s, p, bound_bits=bb),
                  lambda a, p: softmax.relu_attention_scores(
                      a, s, p, bound_bits=bb), (seed,), (x,))
    assert np.abs(got - np.maximum(x, 0) / s).max() < 8 * 2.0 ** -jring.frac


def test_relu_attention_scores_paper_rounds_identical(fused_off):
    x = _f((2, 2, 6), 54, 2.0)
    _run(32, lambda a, p: jsoftmax.relu_attention_scores(a, 6, p),
         lambda a, p: softmax.relu_attention_scores(a, 6, p), (55,), (x,))


@pytest.mark.parametrize("bits,shape", [(32, (16, 10)), (64, (4, 5))])
def test_secure_argmax_onehot_identical(bits, shape):
    x = _f(shape, 60, 3.0)          # RING32: tests/test_nonlinear.py's shape
    bb = _bound_bits(RINGS[bits][0])
    jring, tring = RINGS[bits]
    with _ctx(bits):
        jx = jshare(jnp.asarray(x), jax.random.PRNGKey(61), jring)
        jp = JParties.setup(jax.random.PRNGKey(62))
        with jcomm.track() as jl:
            jo = jsoftmax.secure_argmax_onehot(jx, jp, bound_bits=bb)
        jo = np.asarray(jo.shares)
    tx = share(torch.from_numpy(x), prf.PRNGKey(61), tring)
    tp = Parties.setup(prf.PRNGKey(62))
    with comm.track() as tl:
        to = softmax.secure_argmax_onehot(tx, tp, bound_bits=bb)
    _same(jo, to)
    assert _rows(tl) == _rows(jl)
    onehot = reconstruct(to, decode=False).numpy()
    want = np.zeros(shape, onehot.dtype)
    want[np.arange(shape[0]), x.argmax(-1)] = 1
    assert np.array_equal(onehot, want)
