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


# ---------------------------------------------------------------------------
# The protocol API of queue A item 1, held to the reference's cases in
# tests/test_rss.py / tests/test_protocols.py
# ---------------------------------------------------------------------------

from repro.core import RING64 as JRING64  # noqa: E402
from repro.core import rss as jrss  # noqa: E402
from repro_torch.core import rss  # noqa: E402
from repro_torch.core.ring import RING64, shr  # noqa: E402


def test_share_bits_and_reconstruct_bits_identical():
    bits = (np.random.default_rng(20).random((500,)) > 0.3).astype(np.uint8)
    for seed in (0, 3):
        j = jrss.share_bits(jnp.asarray(bits), jax.random.PRNGKey(seed))
        t = rss.share_bits(torch.from_numpy(bits), prf.PRNGKey(seed))
        _same(j, t)
        assert np.array_equal(rss.reconstruct_bits(t).numpy(), bits)


def test_b2a_of_shared_bits_identical():
    """The reference's test_b2a: B2A of an XOR sharing opens to the bits."""
    bits = (np.random.default_rng(21).random((200,)) > 0.3).astype(np.uint8)
    jp, tp = _parties(22)
    jb = jrss.share_bits(jnp.asarray(bits), jax.random.PRNGKey(23))
    tb = rss.share_bits(torch.from_numpy(bits), prf.PRNGKey(23))
    jo, to = _run(lambda: jmsb.b2a(jb, jp, JRING),
                  lambda: msb.b2a(tb, tp, RING32))
    _same(jo, to)
    assert np.array_equal(ring_to_numpy(rss.reconstruct(to, decode=False)),
                          bits.astype(np.uint32))


def test_zeros_like_shares():
    _, t = _shared(_floats((3, 4), 24), 24)
    z = rss.zeros_like_shares(t)
    assert z.shares.shape == t.shares.shape and not z.shares.any()
    assert z.ring is t.ring


def test_a2b_msb_identical():
    """The MSB bit as binary shares (paper §3.3), the reference's edges."""
    v = np.array([0.0, 1e-4, -1e-4, 31.9, -31.9, 1.0, -1.0] +
                 list(_floats((40,), 25, 10.0)), np.float32)
    jx, tx = _shared(v, 25)
    jp, tp = _parties(26)
    jo, to = _run(lambda: jmsb.a2b_msb(jx, jp), lambda: msb.a2b_msb(tx, tp))
    _same(jo, to)
    enc = ring_to_numpy(RING32.encode(torch.from_numpy(v)))
    assert np.array_equal(rss.reconstruct_bits(to).numpy(),
                          (enc >> 31).astype(np.uint8))


def test_truncate_probabilistic_identical():
    """ABY3's Π_trunc1 (the reference baseline): identical shares and
    ledger rows, the offline reshare included; correct for small values."""
    x = _floats((256,), 27, 0.01) * 4096     # at scale 2f
    jx, tx = _shared(x, 27)
    jp, tp = _parties(28)
    jo, to = _run(lambda: jlinear.truncate_probabilistic(jx, jp),
                  lambda: linear.truncate_probabilistic(tx, tp))
    _same(jo, to)
    err = np.abs(rss.reconstruct(to).numpy() - x / 4096)
    assert np.median(err) < 1e-3


def test_rand_rss_open_identical():
    jp, tp = _parties(29)
    (jr, jplain), (tr, tplain) = _run(
        lambda: jp.rand_rss_open((5, 3), JRING),
        lambda: tp.rand_rss_open((5, 3), RING32))
    _same(jr, tr)
    _same(jplain, tplain)
    assert np.array_equal(ring_to_numpy(rss.reconstruct(tr, decode=False)),
                          ring_to_numpy(tplain))


def test_post_sign_linear_cost_equals_reference():
    from repro.core import secure_model as jsm
    from repro_torch.core import secure_model
    from repro_torch.nn import bnn
    params = {k: v.numpy() for k, v in bnn.init_bnn(0, "MnistNet3").items()}
    shape = (2,) + bnn.INPUT_SHAPES["MnistNet3"]
    for kw in ({}, {"binary_linear": "off"}, {"weights": "public"}):
        t = secure_model.compile_secure(
            {k: torch.from_numpy(v) for k, v in params.items()}, "MnistNet3",
            prf.PRNGKey(1), RING32, device="cpu", **kw)
        j = jsm.compile_secure(params, "MnistNet3", jax.random.PRNGKey(1),
                               JRING, **kw)
        got = secure_model.post_sign_linear_cost(
            t, secure_model.secure_infer_cost(t, shape))
        assert got == jsm.post_sign_linear_cost(
            j, jsm.secure_infer_cost(j, shape)), kw
        assert got[1] >= 0


# RING64: int64 storage, the reference under jax's 64-bit mode

def _same64(j, t):
    j = np.asarray(getattr(j, "shares", j))
    t = getattr(t, "shares", t)
    assert t.dtype == torch.int64
    assert np.array_equal(j, t.numpy().view(np.uint64))


def test_ring64_spec():
    assert (RING64.bits, RING64.frac, RING64.nbytes) == (64, 20, 8)
    assert RING64.dtype == torch.int64 and RING64.float_dtype == torch.float64
    assert RING64.half() == 1 << 63 and RING64.modulus == 1 << 64
    x = torch.tensor([-1, -(1 << 40), 5], dtype=torch.int64)
    # logical shifts masked as for int32
    assert shr(x, 60).tolist() == [15, 15, 0]
    assert shr(torch.tensor([-1], dtype=torch.int32), 28).tolist() == [15]
    assert RING64.wrap((1 << 64) - 3).item() == -3
    assert RING64.msb(x).tolist() == [1, 1, 0]


def test_ring64_share_and_randomness_identical():
    """Bit identity needs the reference's 64-bit words: low word
    bits(k), high word bits(fold_in(k, 1))."""
    x = _floats((6, 5), 30, 100.0)
    with jax.enable_x64(True):
        j = jshare(x, jax.random.PRNGKey(31), JRING64)
        jp = JParties.setup(jax.random.PRNGKey(32))
        jz = jp.zero_shares((7,), JRING64)
        jr = jp.rand_rss((7,), JRING64, max_bits=40)
        jro, jplain = jp.rand_rss_open((3,), JRING64)
        jc = jp.common_pair(0, 1, (4,), JRING64)
        jm = jp.ot_masks(1, (4,), JRING64)
        jdec = np.asarray(jrss.reconstruct(j))
    t = share(torch.from_numpy(x), prf.PRNGKey(31), RING64)
    tp = Parties.setup(prf.PRNGKey(32))
    _same64(j, t)
    _same64(jz, tp.zero_shares((7,), RING64))
    _same64(jr, tp.rand_rss((7,), RING64, max_bits=40))
    tro, tplain = tp.rand_rss_open((3,), RING64)
    _same64(jro, tro)
    _same64(jplain, tplain)
    _same64(jc, tp.common_pair(0, 1, (4,), RING64))
    for a, b in zip(jm, tp.ot_masks(1, (4,), RING64)):
        _same64(a, b)
    got = rss.reconstruct(t)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), jdec)
    assert np.abs(got.numpy() - x).max() < 1e-6


def test_ring64_mul_truncate_and_msb_identical():
    """The reference's protocol cases at RING64: a product and its
    truncation, and the MSB extraction, share for share and row for
    row.  The MSB envelope at f = 20 is frac + 6 bits, the reference's own
    rule for RING64 (tests/test_property.py ``_bound_bits``)."""
    x, y = _floats((64,), 33, 2.0), _floats((64,), 34, 2.0)
    with jax.enable_x64(True):
        jx = jshare(x, jax.random.PRNGKey(35), JRING64)
        jy = jshare(y, jax.random.PRNGKey(36), JRING64)
        jp = JParties.setup(jax.random.PRNGKey(37))
        with jcomm.track() as jl:
            jz = jlinear.truncate(jlinear.mul(jx, jy, jp), jp)
            jb = jmsb.a2b_msb(jx, jp, bound_bits=RING64.frac + 6)
        jz, jb = np.asarray(jz.shares), np.asarray(jb.shares)
    tx = share(torch.from_numpy(x), prf.PRNGKey(35), RING64)
    ty = share(torch.from_numpy(y), prf.PRNGKey(36), RING64)
    tp = Parties.setup(prf.PRNGKey(37))
    with comm.track() as tl:
        tz = linear.truncate(linear.mul(tx, ty, tp), tp)
        tb = msb.a2b_msb(tx, tp, bound_bits=RING64.frac + 6)
    assert _rows(tl) == _rows(jl)
    _same64(jz, tz)
    assert np.array_equal(jb, tb.shares.numpy())
    assert np.abs(rss.reconstruct(tz).numpy() - x * y).max() < 1e-4
    assert np.array_equal(rss.reconstruct_bits(tb).numpy(),
                          (x < 0).astype(np.uint8))
