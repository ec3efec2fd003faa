"""Port protocols under both matmul modes and both round structures ==
the JAX package's: identical shares and identical ledger rows (tag,
rounds, bytes, preprocess) for the same keys.  Covers the per-dot route
(``dot=rss_matmul_dot``), the paper-faithful MSB / Sign / ReLU / select
and the ReLU nets' maxpool protocols.

The matmul mode and the fused-rounds switch are process globals in both
packages: every test that flips one does it through the ``set_modes``
fixture, which restores "opt2" and fused rounds in both whatever happens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import activation as jact
from repro.core import linear as jlinear
from repro.core import msb as jmsb
from repro.core import pooling as jpool
from repro.core.linear import PublicTensor as JPublic
from repro.kernels import ops as jops
from repro.kernels.rss_matmul import precompute_weight_limbs as j_limbs
from repro_torch.core import activation, linear, msb, pooling
from repro_torch.core.ring import RING32
from repro_torch.core.rss import reconstruct
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels.rss_matmul import precompute_weight_limbs
from repro_torch.weights import ring_from_numpy
from test_torch_protocols import _floats, _parties, _run, _same, _shared

torch.set_num_threads(1)

MODES = ["opt2", "paper3"]


def _restore():
    for lin in (jlinear, linear):
        lin.set_matmul_mode("opt2")
        lin.set_fused_rounds(True)


@pytest.fixture
def set_modes():
    """``set_modes(matmul_mode, fused)`` flips both packages' toggles; the
    defaults come back after the test, pass or fail."""
    def _set(matmul_mode="opt2", fused=True):
        for lin in (jlinear, linear):
            lin.set_matmul_mode(matmul_mode)
            lin.set_fused_rounds(fused)
    try:
        yield _set
    finally:
        _restore()


def _bits_shared(shape, seed):
    """A secret {0,1} tensor and its binary shares in both packages,
    through the same MSB extraction (so the bit shares are identical)."""
    x = _floats(shape, seed, 4.0)
    jx, tx = _shared(x, seed)
    jp, tp = _parties(seed + 1)
    jb = jmsb.msb_extract(jx, jp, tag="b")
    tb = msb.msb_extract(tx, tp, tag="b")
    _same(jb, tb)
    return jb, tb


def test_toggles_default_and_restore(set_modes):
    assert linear.fused_rounds() and linear._MATMUL_MODE == "opt2"
    set_modes("paper3", False)
    assert not linear.fused_rounds() and linear._MATMUL_MODE == "paper3"
    assert not jlinear.fused_rounds() and jlinear._MATMUL_MODE == "paper3"
    with pytest.raises(ValueError):
        linear.set_matmul_mode("paper2")


# -- elementwise products ------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_mul_identical(set_modes, mode):
    set_modes(mode)
    (jx, tx), (jy, ty) = _shared(_floats((5, 8), 1), 1), \
        _shared(_floats((5, 8), 2), 2)
    jp, tp = _parties(3)
    jo, to = _run(lambda: jlinear.mul(jx, jy, jp, tag="m"),
                  lambda: linear.mul(tx, ty, tp, tag="m"))
    _same(jo, to)


@pytest.mark.parametrize("mode", MODES)
def test_square_identical(set_modes, mode):
    """``square`` has one form; the mode must not change it."""
    set_modes(mode)
    jx, tx = _shared(_floats((4, 9), 4), 4)
    jp, tp = _parties(5)
    jo, to = _run(lambda: jlinear.square(jx, jp),
                  lambda: linear.square(tx, tp))
    _same(jo, to)


@pytest.mark.parametrize("mode", MODES)
def test_mul_and_square_truncate_identical(set_modes, mode):
    set_modes(mode)
    (jx, tx), (jy, ty) = _shared(_floats((3, 7), 6), 6), \
        _shared(_floats((7,), 7), 7)      # broadcast over the batch
    jp, tp = _parties(8)
    jo, to = _run(lambda: (jlinear.mul_truncate(jx, jy, jp),
                           jlinear.square_truncate(jx, jp)),
                  lambda: (linear.mul_truncate(tx, ty, tp),
                           linear.square_truncate(tx, tp)))
    _same(jo[0], to[0])
    _same(jo[1], to[1])


# -- the per-dot route ---------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_matmul_dot_identical(set_modes, mode):
    """``dot=rss_matmul_dot`` (the reference runs its Pallas kernel in
    interpret mode, the port its plain version on CPU tensors) with
    leading dims folded, and one dot call per per-party product."""
    set_modes(mode)
    (jx, tx), (jw, tw) = _shared(_floats((2, 9, 20), 9), 9), \
        _shared(_floats((20, 12), 10, 0.3), 10)
    jp, tp = _parties(11)
    calls = []

    def counted(a, b):
        calls.append(tuple(a.shape))
        return ops.rss_matmul_dot(a, b)

    jo, to = _run(lambda: jlinear.matmul(jx, jw, jp, dot=jops.rss_matmul_dot),
                  lambda: linear.matmul(tx, tw, tp, dot=counted))
    _same(jo, to)
    assert len(calls) == (6 if mode == "opt2" else 9)
    assert all(c == (2, 9, 20) for c in calls)


@pytest.mark.parametrize("mode", MODES)
def test_matmul_modes_agree_and_limbs_win(set_modes, mode):
    """Cached weight limbs take precedence over ``dot`` and the mode (one
    fused launch on the card): the same shares as the reference's limb
    route; and the plain route of either mode opens to the same value."""
    set_modes(mode)
    (jx, tx), (jw, tw) = _shared(_floats((6, 16), 12), 12), \
        _shared(_floats((16, 5), 13, 0.3), 13)
    jp, tp = _parties(14)
    jo, to = _run(
        lambda: jlinear.matmul(jx, jw, jp, dot=jops.rss_matmul_dot,
                               w_limbs=j_limbs(jw.shares)),
        lambda: linear.matmul(tx, tw, tp,
                              dot=lambda a, b: pytest.fail("dot was used"),
                              w_limbs=precompute_weight_limbs(tw.shares)))
    _same(jo, to)
    plain = linear.matmul(tx, tw, _parties(14)[1])
    assert torch.equal(reconstruct(plain, decode=False),
                       reconstruct(to, decode=False))


@pytest.mark.parametrize("mode", MODES)
def test_matmul_truncate_dot_identical(set_modes, mode):
    set_modes(mode)
    (jx, tx), (jw, tw) = _shared(_floats((9, 20), 15), 15), \
        _shared(_floats((20, 12), 16, 0.3), 16)
    jb = np.random.default_rng(17).integers(0, 2**32, (3, 1, 12),
                                            dtype=np.uint64).astype(np.uint32)
    jp, tp = _parties(18)
    jo, to = _run(
        lambda: jlinear.matmul_truncate(jx, jw, jp, dot=jops.rss_matmul_dot,
                                        bias_parts=jnp.asarray(jb)),
        lambda: linear.matmul_truncate(tx, tw, tp, dot=ops.rss_matmul_dot,
                                       bias_parts=ring_from_numpy(jb)))
    _same(jo, to)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [True, False])
def test_linear_layer_identical(set_modes, mode, fused):
    """Alg 2 + bias + truncation: one opening round fused, reshare then
    truncation paper-faithful."""
    set_modes(mode, fused)
    (jx, tx), (jw, tw), (jb, tb) = _shared(_floats((2, 4, 24), 19), 19), \
        _shared(_floats((24, 7), 20, 0.3), 20), _shared(_floats((7,), 21), 21)
    jp, tp = _parties(22)
    jo, to = _run(
        lambda: jlinear.linear_layer(jx, jw, jb, jp, tag="fc",
                                     dot=jops.rss_matmul_dot),
        lambda: linear.linear_layer(tx, tw, tb, tp, tag="fc",
                                    dot=ops.rss_matmul_dot))
    _same(jo, to)
    jo, to = _run(
        lambda: jlinear.linear_layer(jx, jw, jb, jp, truncate_out=False),
        lambda: linear.linear_layer(tx, tw, tb, tp, truncate_out=False))
    _same(jo, to)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("weights", ["shared", "public"])
def test_bin_matmul_dot_identical(set_modes, mode, weights):
    """Post-Sign ±1 input through ``dot``: the shared reshare round and
    the public branch without a limb cache (zero-cost row)."""
    set_modes(mode)
    bits = np.random.default_rng(23).integers(0, 2, (5, 18))
    pm1 = (2 * bits - 1).astype(np.int64).astype(np.uint32)
    jx, tx = _shared(pm1, 23, encoded=True)
    jp, tp = _parties(24)
    if weights == "public":
        w = np.random.default_rng(25).integers(-4096, 4096, (18, 6))
        enc = w.astype(np.int64).astype(np.uint32)
        jw, tw = JPublic(jnp.asarray(enc)), linear.PublicTensor(
            ring_from_numpy(enc))
    else:
        jw, tw = _shared(_floats((18, 6), 25, 0.3), 25)
    jo, to = _run(
        lambda: jlinear.bin_matmul(jx, jw, jp, dot=jops.rss_matmul_dot),
        lambda: linear.bin_matmul(tx, tw, tp, dot=ops.rss_matmul_dot))
    _same(jo, to)


def test_dot_route_launches_nothing_on_cpu():
    """CPU tensors take the plain ring product: no kernel launch."""
    before = dict(kbuild.LAUNCHES)
    a = ring_from_numpy(np.arange(12, dtype=np.uint32).reshape(2, 2, 3))
    b = ring_from_numpy(np.arange(6, dtype=np.uint32).reshape(3, 2))
    got = ops.rss_matmul_dot(a, b)
    assert torch.equal(got, torch.matmul(a, b))
    assert kbuild.LAUNCHES == before


# -- MSB, Sign, ReLU and select, paper-faithful and fused ----------------------

@pytest.mark.parametrize("fused", [True, False])
def test_msb_extract_identical(set_modes, fused):
    set_modes(fused=fused)
    jx, tx = _shared(_floats((6, 11), 26, 8.0), 26)
    jp, tp = _parties(27)
    jo, to = _run(lambda: jmsb.msb_extract(jx, jp, tag="s.msb"),
                  lambda: msb.msb_extract(tx, tp, tag="s.msb"))
    _same(jo, to)


def test_sign_from_msb_identical():
    jb, tb = _bits_shared((4, 7), 28)
    jp, tp = _parties(29)
    jo, to = _run(lambda: jact.sign_from_msb(jb, jp, JRING),
                  lambda: activation.sign_from_msb(tb, tp, RING32))
    _same(jo, to)


def test_relu_and_select_from_msb_identical():
    jb, tb = _bits_shared((3, 10), 30)
    (jx, tx), (jy, ty) = _shared(_floats((3, 10), 31), 31), \
        _shared(_floats((3, 10), 32), 32)
    jp, tp = _parties(33)
    jo, to = _run(lambda: (jact.relu_from_msb(jx, jb, jp),
                           jact.select_from_msb(jx, jy, jb, jp)),
                  lambda: (activation.relu_from_msb(tx, tb, tp),
                           activation.select_from_msb(tx, ty, tb, tp)))
    _same(jo[0], to[0])
    _same(jo[1], to[1])


@pytest.mark.parametrize("fused", [True, False])
def test_secure_sign_and_relu_identical(set_modes, fused):
    set_modes(fused=fused)
    jx, tx = _shared(_floats((2, 3, 5), 34, 4.0), 34)
    jp, tp = _parties(35)
    jo, to = _run(lambda: (jact.secure_sign(jx, jp),
                           jact.secure_relu(jx, jp, tag="r")),
                  lambda: (activation.secure_sign(tx, tp),
                           activation.secure_relu(tx, tp, tag="r")))
    _same(jo[0], to[0])
    _same(jo[1], to[1])


# -- maxpool of the ReLU nets ---------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_secure_maxpool_identical(set_modes, fused):
    set_modes(fused=fused)
    jx, tx = _shared(_floats((2, 4, 6, 3), 36, 2.0), 36)
    jp, tp = _parties(37)
    jo, to = _run(lambda: jpool.secure_maxpool(jx, jp, tag="mp"),
                  lambda: pooling.secure_maxpool(tx, tp, tag="mp"))
    _same(jo, to)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("width", [7, 8])
def test_secure_max_lastdim_identical(set_modes, fused, width):
    set_modes(fused=fused)
    jx, tx = _shared(_floats((3, width), 38 + width, 2.0), 38 + width)
    jp, tp = _parties(39)
    jo, to = _run(lambda: jpool.secure_max_lastdim(jx, jp),
                  lambda: pooling.secure_max_lastdim(tx, tp))
    assert to.shape == (3, 1)
    _same(jo, to)


def test_sign_maxpool_fused_paper_identical(set_modes):
    set_modes(fused=False)
    bits = np.random.default_rng(40).integers(0, 2, (2, 4, 6, 3)) \
        .astype(np.uint32)
    jx, tx = _shared(bits, 40, encoded=True)
    jp, tp = _parties(41)
    jo, to = _run(lambda: jpool.sign_maxpool_fused(jx, jp, tag="mp"),
                  lambda: pooling.sign_maxpool_fused(tx, tp, tag="mp"))
    _same(jo, to)
