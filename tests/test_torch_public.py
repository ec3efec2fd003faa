"""Port public-weight kernels and protocols == the JAX package's: the B3
and B4 plain versions against the Pallas kernels (interpret mode) and
their references, the adaptive limb count, the weight caches, the op
wrappers, and ``bin_matmul`` / ``bin_conv2d`` with a ``PublicTensor``
(shares and ledger rows).  The CUDA cases are in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.core import comm as jcomm
from repro.core import linear as jlinear
from repro.core.rss import RSS as JRSS
from repro.kernels import bin_rss_matmul as jbin
from repro.kernels import ops as jops
from repro_torch.core import comm, linear, prf
from repro_torch.core.randomness import Parties
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS
from repro_torch.kernels import bin_rss_matmul as pub
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.weights import ring_from_numpy, ring_to_numpy

# the workers of a parallel run share the cores: one intra-op thread each
torch.set_num_threads(1)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _public(shape, wmag, seed):
    """A public encoding with |w| < wmag (wmag None: full-range words)."""
    if wmag is None:
        return _words(shape, seed)
    w = np.random.default_rng(seed).integers(-wmag + 1, wmag, shape)
    return w.astype(np.int64).astype(np.uint32)


# magnitudes whose minimal limb counts are 1, 2, 3 and 4
WMAGS = [64, 4096, 1 << 20, None]


# -- the adaptive limb count and the caches ---------------------------------

@pytest.mark.parametrize("vals,want", [
    ([0], 1), ([1], 1), ([-1], 1), ([127], 1), ([128], 2),
    ([32767], 3), ([-32768], 2), ([1, -1, 4096, -4096], 2),
])
def test_min_public_limbs_matches_reference(vals, want):
    enc = np.asarray(vals, np.int64).astype(np.uint32)
    assert jbin.min_public_limbs(enc) == want
    assert pub.min_public_limbs(ring_from_numpy(enc)) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_min_public_limbs_of_a_share_is_four(seed):
    enc = _words((16, 8), seed)
    assert pub.min_public_limbs(ring_from_numpy(enc)) == \
        jbin.min_public_limbs(enc) == 4


@pytest.mark.parametrize("wmag", WMAGS)
def test_public_weight_limbs_cache_matches_reference(wmag):
    k, n = 24, 11
    w = _public((k, n), wmag, 3)
    jwl = jbin.public_weight_limbs(jnp.asarray(w))
    wl = pub.public_weight_limbs(ring_from_numpy(w))
    assert wl.n_limbs == jwl.n_limbs
    assert np.array_equal(ring_to_numpy(wl.w), np.asarray(jwl.w))
    # the reference pads its limbs to 128 tiles; the port keeps them unpadded
    assert tuple(wl.wl.shape) == (jwl.n_limbs, k, n)
    assert np.array_equal(wl.wl.numpy(), np.asarray(jwl.wl)[:, :k, :n])


@pytest.mark.parametrize("wmag", WMAGS)
def test_public_grouped_limbs_cache_matches_reference(wmag):
    w = _public((6, 9, 1), wmag, 4)
    jwl = jbin.public_grouped_limbs(jnp.asarray(w))
    wl = pub.public_grouped_limbs(ring_from_numpy(w))
    assert wl.n_limbs == jwl.n_limbs
    assert np.array_equal(ring_to_numpy(wl.w), np.asarray(jwl.w))
    assert np.array_equal(wl.wl.numpy(), np.asarray(jwl.wl))


# -- B3: the dense public product ---------------------------------------------

@pytest.mark.parametrize("wmag", WMAGS)
@pytest.mark.parametrize("s,m,k,n", [(3, 40, 24, 16), (2, 72, 136, 9)])
def test_bin_rss_matmul_plain_equals_pallas_kernel(s, m, k, n, wmag):
    x, w = _words((s, m, k), m + k), _public((k, n), wmag, n)
    jwl = jbin.public_weight_limbs(jnp.asarray(w))
    # ≥ min_dim in every axis: the Pallas kernel (interpret mode) runs
    want = np.asarray(jbin.bin_rss_matmul_parts(jnp.asarray(x), jwl))
    assert np.array_equal(
        want, np.asarray(jbin.bin_rss_matmul_ref(jnp.asarray(x), jwl)))
    wl = pub.public_weight_limbs(ring_from_numpy(w))
    launches = kbuild.LAUNCHES["bin_rss_matmul"]
    got = pub.bin_rss_matmul_parts(ring_from_numpy(x), wl)
    assert np.array_equal(ring_to_numpy(got), want)
    assert np.array_equal(ring_to_numpy(pub.bin_rss_matmul_ref(
        ring_from_numpy(x), wl)), want)
    assert kbuild.LAUNCHES["bin_rss_matmul"] == launches  # CPU: plain


def test_bin_rss_matmul_op_folds_leading_dims():
    x, w = _words((3, 2, 5, 4, 27), 3), _public((27, 11), 4096, 4)
    want = np.asarray(jops.bin_rss_matmul_op(
        jnp.asarray(x), jbin.public_weight_limbs(jnp.asarray(w))))
    got = ops.bin_rss_matmul_op(
        ring_from_numpy(x), pub.public_weight_limbs(ring_from_numpy(w)))
    assert got.shape == (3, 2, 5, 4, 11)
    assert np.array_equal(ring_to_numpy(got), want)


# -- B4: the depthwise public product -----------------------------------------

@pytest.mark.parametrize("wmag", WMAGS)
@pytest.mark.parametrize("s,c,m,k,n", [(3, 5, 40, 9, 1), (2, 7, 24, 25, 2),
                                       (3, 96, 24, 4, 1),
                                       # a slab past 48 KB (the card's
                                       # kernel stages it in channel ranges)
                                       (2, 520, 8, 25, 1)])
def test_bin_grouped_plain_equals_pallas_kernel(s, c, m, k, n, wmag):
    x, w = _words((s, c, m, k), c + m), _public((c, k, n), wmag, k)
    jwl = jbin.public_grouped_limbs(jnp.asarray(w))
    want = np.asarray(jbin.bin_grouped_matmul_parts(jnp.asarray(x), jwl))
    assert np.array_equal(
        want, np.asarray(jbin.bin_grouped_matmul_ref(jnp.asarray(x), jwl)))
    wl = pub.public_grouped_limbs(ring_from_numpy(w))
    launches = kbuild.LAUNCHES["bin_grouped_matmul"]
    got = pub.bin_grouped_matmul_parts(ring_from_numpy(x), wl)
    assert np.array_equal(ring_to_numpy(got), want)
    assert kbuild.LAUNCHES["bin_grouped_matmul"] == launches


def test_bin_grouped_op_reads_patch_layout():
    """(S, B, H, W, K, C) patches -> (S, B, H, W, C, N), as the reference's
    fold/transpose route, with the fold done as a strided view."""
    c, k = 6, 9
    x, w = _words((3, 2, 4, 5, k, c), 5), _public((c, k, 1), 4096, 6)
    want = np.asarray(jops.bin_grouped_matmul_op(
        jnp.asarray(x), jbin.public_grouped_limbs(jnp.asarray(w))))
    got = ops.bin_grouped_matmul_op(
        ring_from_numpy(x), pub.public_grouped_limbs(ring_from_numpy(w)))
    assert np.array_equal(ring_to_numpy(got), want)


# -- the public branches of bin_matmul / bin_conv2d ---------------------------

def _rows(led):
    return ((led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes),
            sorted((k, tuple(v)) for k, v in led.by_tag.items()))


def _both(x_np, w_np, limbs, make_jlimbs, make_limbs):
    """The same public weight as the reference's and the port's
    PublicTensor, with or without the kernel cache."""
    jw = jlinear.PublicTensor(jnp.asarray(w_np),
                              make_jlimbs(jnp.asarray(w_np)) if limbs
                              else None)
    tw = linear.PublicTensor(ring_from_numpy(w_np),
                             make_limbs(ring_from_numpy(w_np)) if limbs
                             else None)
    return (JRSS(jnp.asarray(x_np), JRING), jw,
            RSS(ring_from_numpy(x_np), RING32), tw)


@pytest.mark.parametrize("limbs", [True, False])
def test_bin_matmul_public_matches_reference(limbs):
    x = _words((3, 12, 40), 7)
    w = _public((40, 10), 4096, 8)
    b = _public((10,), 1 << 16, 9)
    jx, jw, tx, tw = _both(x, w, limbs, jbin.public_weight_limbs,
                           pub.public_weight_limbs)
    with jcomm.track() as jled:
        want = jlinear.bin_matmul(jx, jw, None, tag="l3.fc.pub",
                                  bias_public=jnp.asarray(b))
    with comm.track() as led:
        got = linear.bin_matmul(tx, tw, Parties.setup(prf.PRNGKey(0)),
                                tag="l3.fc.pub",
                                bias_public=ring_from_numpy(b))
    assert np.array_equal(ring_to_numpy(got.shares), np.asarray(want.shares))
    assert _rows(led) == _rows(jled)
    assert _rows(led)[1] == [("l3.fc.pub", (0, 0))]


def _conv_weight_limbs(kind):
    """The cache ``compile_secure`` builds for a (kh, kw, cin_g, cout)
    public conv weight, in both packages."""
    if kind == "dense":
        def port(w):
            return pub.public_weight_limbs(w.reshape(-1, w.shape[-1]))

        def ref(w):
            return jbin.public_weight_limbs(w.reshape(-1, w.shape[-1]))
    else:
        def port(w):
            kh, kw, _, c = w.shape
            return pub.public_grouped_limbs(
                w.reshape(kh * kw, c, 1).permute(1, 0, 2))

        def ref(w):
            kh, kw, _, c = w.shape
            return jbin.public_grouped_limbs(
                w.reshape(kh * kw, c, 1).transpose(1, 0, 2))
    return ref, port


@pytest.mark.parametrize("limbs", [True, False])
@pytest.mark.parametrize("kind", ["dense", "depthwise"])
def test_bin_conv2d_public_matches_reference(kind, limbs):
    c = 4
    x = _words((3, 2, 6, 6, c), 11)
    wshape = (3, 3, c, 5) if kind == "dense" else (3, 3, 1, c)
    groups = 1 if kind == "dense" else c
    w = _public(wshape, 1 << 12, 12)
    b = _public((wshape[-1],), 1 << 16, 13)
    jx, jw, tx, tw = _both(x, w, limbs, *_conv_weight_limbs(kind))
    with jcomm.track() as jled:
        want = jlinear.bin_conv2d(jx, jw, None, stride=1, padding=1,
                                  groups=groups, tag="l0.conv.pub",
                                  bias_public=jnp.asarray(b))
    with comm.track() as led:
        got = linear.bin_conv2d(tx, tw, Parties.setup(prf.PRNGKey(0)),
                                stride=1, padding=1, groups=groups,
                                tag="l0.conv.pub",
                                bias_public=ring_from_numpy(b))
    assert got.shares.shape == tuple(want.shares.shape)
    assert np.array_equal(ring_to_numpy(got.shares), np.asarray(want.shares))
    assert _rows(led) == _rows(jled)
