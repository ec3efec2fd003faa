"""Port protocols == the JAX package's: with the same keys, identical
shares and identical ledger rows (tag, rounds, bytes, preprocess)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import Parties as JParties
from repro.core import comm as jcomm
from repro.core import linear as jlinear
from repro.core import msb as jmsb
from repro.core import pooling as jpool
from repro.core import share as jshare
from repro.kernels.bin_rss_matmul import grouped_weight_limbs as j_glimbs
from repro.kernels.rss_matmul import precompute_weight_limbs as j_limbs
from repro_torch.core import comm, linear, msb, pooling, prf
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import share
from repro_torch.kernels.bin_rss_matmul import grouped_weight_limbs
from repro_torch.kernels.rss_matmul import precompute_weight_limbs
from repro_torch.weights import ring_from_numpy, ring_to_numpy

# the workers of a parallel run share the cores: one intra-op thread each
torch.set_num_threads(1)


def _parties(seed):
    return (JParties.setup(jax.random.PRNGKey(seed)),
            Parties.setup(prf.PRNGKey(seed)))


def _shared(x, seed, encoded=False):
    """The same secret shared by both packages with the same key."""
    if encoded:
        j = jshare(jnp.asarray(x, jnp.uint32), jax.random.PRNGKey(seed),
                   JRING, encoded=True)
        t = share(ring_from_numpy(x), prf.PRNGKey(seed), RING32, encoded=True)
    else:
        x = np.asarray(x, np.float32)
        j = jshare(x, jax.random.PRNGKey(seed), JRING)
        t = share(torch.from_numpy(x), prf.PRNGKey(seed), RING32)
    return j, t


def _same(j, t):
    """Identical ring tensors / share stacks / bit stacks."""
    j = np.asarray(getattr(j, "shares", j))
    t = getattr(t, "shares", t)
    t = ring_to_numpy(t) if t.dtype == torch.int32 else t.cpu().numpy()
    assert j.shape == t.shape and np.array_equal(j, t)


def _rows(led):
    return ((led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes),
            sorted((k, tuple(v)) for k, v in led.by_tag.items()))


def _run(jfn, tfn):
    """Run both sides under ledgers; assert identical rows."""
    with jcomm.track() as jl:
        jout = jfn()
    with comm.track() as tl:
        tout = tfn()
    assert _rows(tl) == _rows(jl)
    return jout, tout


def _floats(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape) \
        .astype(np.float32)


def test_share_identical():
    for seed in (0, 5):
        j, t = _shared(_floats((4, 5), seed), seed)
        _same(j, t)


def test_reshare_identical():
    z = np.random.default_rng(0).integers(0, 2**32, (3, 6, 7),
                                          dtype=np.uint64).astype(np.uint32)
    jp, tp = _parties(1)
    jo, to = _run(lambda: jlinear._reshare(jnp.asarray(z), JRING, jp, "rs"),
                  lambda: linear._reshare(ring_from_numpy(z), RING32, tp,
                                          "rs"))
    _same(jo, to)


def test_mul_open_identical():
    (jx, tx), (jy, ty) = _shared(_floats((5, 8), 1), 1), \
        _shared(_floats((5, 8), 2), 2)
    jp, tp = _parties(3)
    jo, to = _run(lambda: jlinear.mul_open(jx, jy, jp, tag="mo"),
                  lambda: linear.mul_open(tx, ty, tp, tag="mo"))
    _same(jo, to)


@pytest.mark.parametrize("kernel", [True, False])
def test_matmul_truncate_identical(kernel):
    (jx, tx), (jw, tw) = _shared(_floats((9, 20), 4), 4), \
        _shared(_floats((20, 12), 5, 0.3), 5)
    jb = np.random.default_rng(6).integers(0, 2**32, (3, 1, 12),
                                           dtype=np.uint64).astype(np.uint32)
    jwl = j_limbs(jw.shares) if kernel else None
    twl = precompute_weight_limbs(tw.shares) if kernel else None
    jp, tp = _parties(7)
    jo, to = _run(
        lambda: jlinear.matmul_truncate(jx, jw, jp, tag="fc", w_limbs=jwl,
                                        bias_parts=jnp.asarray(jb)),
        lambda: linear.matmul_truncate(tx, tw, tp, tag="fc", w_limbs=twl,
                                       bias_parts=ring_from_numpy(jb)))
    _same(jo, to)


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 0)])
def test_conv2d_truncate_identical(stride, pad):
    (jx, tx), (jw, tw) = _shared(_floats((1, 8, 8, 3), 8), 8), \
        _shared(_floats((3, 3, 3, 8), 9, 0.3), 9)
    jwl = j_limbs(jw.shares.reshape(3, 27, 8))
    twl = precompute_weight_limbs(tw.shares.reshape(3, 27, 8))
    jp, tp = _parties(10)
    jo, to = _run(
        lambda: jlinear.conv2d_truncate(jx, jw, jp, stride=stride,
                                        padding=pad, w_limbs=jwl),
        lambda: linear.conv2d_truncate(tx, tw, tp, stride=stride,
                                       padding=pad, w_limbs=twl))
    _same(jo, to)


@pytest.mark.parametrize("kernel", [True, False])
def test_depthwise_bin_conv2d_identical(kernel):
    bits = np.random.default_rng(11).integers(0, 2, (1, 6, 6, 4))
    pm1 = (2 * bits - 1).astype(np.int64).astype(np.uint32)  # ±1, scale 0
    (jx, tx), (jw, tw) = _shared(pm1, 11, encoded=True), \
        _shared(_floats((3, 3, 1, 4), 12), 12)

    jwl = j_glimbs(jw.shares.reshape(3, 9, 4, 1).transpose(0, 2, 1, 3)) \
        if kernel else None
    twl = grouped_weight_limbs(tw.shares.reshape(3, 9, 4, 1)
                               .permute(0, 2, 1, 3)) if kernel else None
    jp, tp = _parties(13)
    jo, to = _run(
        lambda: jlinear.bin_conv2d(jx, jw, jp, padding=1, groups=4,
                                   w_limbs=jwl),
        lambda: linear.bin_conv2d(tx, tw, tp, padding=1, groups=4,
                                  w_limbs=twl))
    _same(jo, to)


def test_truncate_identical():
    x = _floats((7, 9), 14, 3.0) * 4096  # a product at scale 2f
    jx, tx = _shared(x, 14)
    jp, tp = _parties(15)
    jo, to = _run(lambda: jlinear.truncate(jx, jp),
                  lambda: linear.truncate(tx, tp))
    _same(jo, to)


def test_msb_extract_arith_identical():
    jx, tx = _shared(_floats((6, 11), 16, 8.0), 16)
    jp, tp = _parties(17)
    (jb, ja), (tb, ta) = _run(
        lambda: jmsb.msb_extract_arith(jx, jp, tag="s.msb"),
        lambda: msb.msb_extract_arith(tx, tp, tag="s.msb"))
    _same(jb, tb)
    _same(ja, ta)


def test_sign_maxpool_fused_identical():
    bits = np.random.default_rng(18).integers(0, 2, (2, 4, 6, 3)) \
        .astype(np.uint32)
    jx, tx = _shared(bits, 18, encoded=True)
    jp, tp = _parties(19)
    jo, to = _run(lambda: jpool.sign_maxpool_fused(jx, jp, tag="mp"),
                  lambda: pooling.sign_maxpool_fused(tx, tp, tag="mp"))
    _same(jo, to)
