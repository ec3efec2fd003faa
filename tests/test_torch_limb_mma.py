"""The limb arithmetic of B1's, B3's, B5's and B6's tensor-core route, on
the CPU.

``limb_model`` repeats, in plain torch, what ``csrc/limb_mma.cuh`` computes:
the four bytes of each activation word as unsigned limbs, the cached
K-major balanced weight limbs (``WeightLimbs.wt`` / ``PublicWeightLimbs.wt``)
as signed ones, one int32 accumulator per shift p + q (pairs with
p + q >= 4 dropped), Σ_s acc_s << 8s at the end, and split-K partial sums
added mod 2^32.  It is held bit for bit to the reference's Pallas kernels
in interpret mode and to the port's plain versions, at ragged shapes and
at full-range and carry-boundary words.  B5 splits its (K, N) operand per
call (``ring_matmul.ring_weight_limbs_ref`` is the split pass's plain
version) and runs the model at one slot; B6's int8 weight is its own
single balanced limb (``binary_matmul.binary_weight_t_ref`` is its weight
pass's plain version: w.T, K-major and 128-padded), the model at one slot
and L = 1.  The CUDA cases are in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bin_rss_matmul as jbin
from repro.kernels import binary_matmul as jbm
from repro.kernels import ring_matmul as jring
from repro.kernels import rss_matmul as jdense
from repro_torch.kernels import bin_rss_matmul as grp
from repro_torch.kernels import binary_matmul as binmm
from repro_torch.kernels import ring_matmul as ringmm
from repro_torch.kernels import rss_matmul as dense
from repro_torch.kernels.limbs import (CUDA_CORE, K_STAGE, TENSOR_CORE,
                                       balanced_limbs, limb_mma_plan)
from repro_torch.weights import ring_from_numpy, ring_to_numpy

# the workers of a parallel run share the cores: one intra-op thread each
torch.set_num_threads(1)

# words at the limbs' carry boundaries (as uint32)
CARRY = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 32767, 0x7F7F7F7F,
                  0x80808080, 0x00000080, 0x00008080, 0xFF7F80FF],
                 dtype=np.uint32)
# (M, K, N): ragged K (one k32 step and less, 25 / 27 of conv1, 131 past
# four k32 steps) and N = 10 of the fc heads
SHAPES = [(5, 3, 10), (33, 25, 10), (16, 27, 16), (9, 131, 10)]


def _words(shape, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "carry":
        return rng.choice(CARRY, size=shape)
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _public(shape, n_limbs, seed, kind):
    """A public encoding whose minimal balanced-limb count is <= L."""
    rng = np.random.default_rng(seed)
    if n_limbs == 4:
        return _words(shape, seed, kind)
    if kind == "carry":   # the extremes of L balanced limbs, and carries
        top = sum(127 << (8 * i) for i in range(n_limbs))
        low = -sum(128 << (8 * i) for i in range(n_limbs))
        w = rng.choice(np.array([0, 1, -1, 127, -128, top, low, top - 1,
                                 low + 1]), size=shape)
    else:
        half = 1 << (8 * n_limbs - 2)
        w = rng.integers(-half, half, shape)
    return w.astype(np.int64).astype(np.uint32)


def limb_model(x: torch.Tensor, wt: torch.Tensor, n: int,
               split_k: int) -> torch.Tensor:
    """The tensor-core route's arithmetic: x (S, M, K) int32 words, wt
    (S_w, OPS, L, Np, Kp) int8 K-major limbs (S_w = S, or 1 for a weight
    shared by every slot); operand o of slot s multiplies x_{(s+o) % S};
    K split into ranges of ``split_k``."""
    s_count, m, k = x.shape
    _, ops, n_limbs = wt.shape[:3]
    out = torch.zeros((s_count, m, n), dtype=torch.int64)
    for s in range(s_count):
        w = wt[s if wt.shape[0] > 1 else 0]
        for k0 in range(0, k, split_k):
            k1 = min(k, k0 + split_k)
            acc = [torch.zeros((m, n), dtype=torch.int32) for _ in range(4)]
            for o in range(ops):
                xs = x[(s + o) % s_count, :, k0:k1]
                u = [(xs >> (8 * p)) & 0xFF for p in range(4)]  # unsigned
                for q in range(n_limbs):
                    v = w[o, q, :n, k0:k1].to(torch.int32).T     # signed
                    for p in range(4 - q):
                        acc[p + q] += u[p] @ v                   # int32 wrap
            out[s] += sum(a.to(torch.int64) << (8 * sh)
                       for sh, a in enumerate(acc))
    # two's-complement view of the sum mod 2^32
    return ((out & 0xFFFFFFFF) ^ 0x80000000).sub(0x80000000).to(torch.int32)


def _splits(k):
    """Split-K ranges: one and two of the kernel's K stages, all of K."""
    return sorted({K_STAGE, 2 * K_STAGE, k})


# -- B1: the fused RSS matmul -------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "carry"])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b1_limb_model_equals_pallas_kernel(m, k, n, s, kind):
    x, w = _words((s, m, k), m + s, kind), _words((s, k, n), k + s, kind)
    jwl = jdense.precompute_weight_limbs(jnp.asarray(w))
    want = np.asarray(jdense.rss_matmul(jnp.asarray(x), jwl, interpret=True))
    wl = dense.precompute_weight_limbs(ring_from_numpy(w))
    xt = ring_from_numpy(x)
    assert np.array_equal(ring_to_numpy(dense.rss_matmul_parts_ref(xt, wl)),
                          want)
    for split_k in _splits(k):
        got = limb_model(xt, wl.wt, n, split_k)
        assert np.array_equal(ring_to_numpy(got), want), split_k


@pytest.mark.parametrize("k,n", [(27, 10), (131, 24)])
def test_b1_k_major_cache_is_the_transposed_limbs(k, n):
    wl = dense.precompute_weight_limbs(ring_from_numpy(_words((3, k, n), 7,
                                                              "full")))
    assert wl.wt.shape == (3, 2, 4) + tuple(wl.wl.shape[-1:-3:-1])
    assert torch.equal(wl.wt[:, 0], wl.wfl.transpose(-1, -2))
    assert torch.equal(wl.wt[:, 1], wl.wl.transpose(-1, -2))
    assert wl.wt.is_contiguous()


# -- B3: the public-weight product ------------------------------------------

@pytest.mark.parametrize("kind", ["full", "carry"])
@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b3_limb_model_equals_pallas_kernel(m, k, n, n_limbs, kind):
    x = _words((3, m, k), m + n_limbs, kind)
    w = _public((k, n), n_limbs, k + n_limbs, kind)
    jwl = jbin.public_weight_limbs(jnp.asarray(w), n_limbs=n_limbs)
    want = np.asarray(jbin.bin_rss_matmul(jnp.asarray(x), jwl,
                                          interpret=True))
    wl = grp.public_weight_limbs(ring_from_numpy(w), n_limbs)
    assert grp.min_public_limbs(wl.w) <= n_limbs == wl.n_limbs
    xt = ring_from_numpy(x)
    assert np.array_equal(ring_to_numpy(grp.bin_rss_matmul_ref(xt, wl)),
                          want)
    for split_k in _splits(k):
        got = limb_model(xt, wl.wt[None, None], n, split_k)
        assert np.array_equal(ring_to_numpy(got), want), split_k


@pytest.mark.parametrize("n_limbs", [1, 2, 4])
def test_b3_k_major_cache_is_the_transposed_limbs(n_limbs):
    k, n = 131, 10
    wl = grp.public_weight_limbs(
        ring_from_numpy(_public((k, n), n_limbs, 9, "full")), n_limbs)
    assert wl.wt.shape == (n_limbs, 128, 256) and wl.wt.is_contiguous()
    assert torch.equal(wl.wt[:, :n, :k], wl.wl.transpose(1, 2))
    assert not wl.wt[:, n:].any() and not wl.wt[:, :, k:].any()


def test_unsigned_bytes_and_balanced_limbs_both_rebuild_the_word():
    """The kernel's two limb splits: x's bytes as they lie in memory, the
    weight's balanced limbs from the cache."""
    x = ring_from_numpy(CARRY)
    un = sum(((x >> (8 * p)) & 0xFF).to(torch.int64) << (8 * p)
             for p in range(4))
    bal = sum(limb.to(torch.int64) << (8 * p)
              for p, limb in enumerate(balanced_limbs(x)))
    assert torch.equal(un & 0xFFFFFFFF, torch.from_numpy(CARRY.astype(
        np.int64)))
    assert torch.equal(bal & 0xFFFFFFFF, un & 0xFFFFFFFF)


# -- B5: the per-dot ring product ----------------------------------------------

def _pallas_ring(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's Pallas ring_matmul in interpret mode, on operands
    zero-padded to its 128 tiles."""
    (m, k), n = a.shape, b.shape[1]
    pad = [(-d) % 128 for d in (m, k, n)]
    ap = np.pad(a, ((0, pad[0]), (0, pad[1])))
    bp = np.pad(b, ((0, pad[1]), (0, pad[2])))
    out = jring.ring_matmul(jnp.asarray(ap), jnp.asarray(bp), interpret=True)
    return np.asarray(out)[:m, :n]


@pytest.mark.parametrize("kind", ["full", "carry"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b5_limb_model_equals_pallas_kernel(m, k, n, kind):
    """One slot, b split per call into its four balanced limbs."""
    a, b = _words((m, k), m + 5, kind), _words((k, n), k + 5, kind)
    want = _pallas_ring(a, b)
    at, bt = ring_from_numpy(a), ring_from_numpy(b)
    assert np.array_equal(ring_to_numpy(ringmm.ring_matmul_ref(at, bt)), want)
    wt = ringmm.ring_weight_limbs_ref(bt)
    for split_k in _splits(k):
        got = limb_model(at[None], wt[None, None], n, split_k)[0]
        assert np.array_equal(ring_to_numpy(got), want), split_k


@pytest.mark.parametrize("kind", ["full", "carry"])
@pytest.mark.parametrize("k,n", [(3, 10), (131, 24), (300, 129)])
def test_b5_split_is_the_balanced_limbs_transposed_and_padded(k, n, kind):
    """The split pass's plain version (bytes of (b + 0x80808080) ^
    0x80808080) == ``balanced_limbs``, K-major, zero-padded to 128."""
    b = ring_from_numpy(_words((k, n), 19, kind))
    wt = ringmm.ring_weight_limbs_ref(b)
    assert wt.shape == (4, -(-n // 128) * 128, -(-k // 128) * 128)
    assert wt.dtype == torch.int8 and wt.is_contiguous()
    assert torch.equal(wt[:, :n, :k], balanced_limbs(b).transpose(1, 2))
    assert not wt[:, n:].any() and not wt[:, :, k:].any()


# -- B6: ring words x an int8 weight, one limb ---------------------------------

def _int8_weight(shape, seed, kind):
    """±1 ("pm1"), {0, 1} ("01"), or full-range int8 holding -128 and 127."""
    rng = np.random.default_rng(seed)
    if kind == "pm1":
        return (2 * rng.integers(0, 2, shape) - 1).astype(np.int8)
    if kind == "01":
        return rng.integers(0, 2, shape).astype(np.int8)
    w = rng.integers(-128, 128, shape)
    w.flat[0], w.flat[-1] = -128, 127
    return w.astype(np.int8)


def _pallas_bin_weight(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The reference's Pallas binary_weight_matmul in interpret mode, on
    operands zero-padded to its 128 tiles."""
    (m, k), n = a.shape, w.shape[1]
    pad = [(-d) % 128 for d in (m, k, n)]
    ap = np.pad(a, ((0, pad[0]), (0, pad[1])))
    wp = np.pad(w, ((0, pad[1]), (0, pad[2])))
    out = jbm.binary_weight_matmul(jnp.asarray(ap), jnp.asarray(wp),
                                   interpret=True)
    return np.asarray(out)[:m, :n]


@pytest.mark.parametrize("wkind", ["pm1", "01", "int8"])
@pytest.mark.parametrize("kind", ["full", "carry"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b6_limb_model_equals_pallas_kernel(m, k, n, kind, wkind):
    """One slot, one limb: the weight pass's plane is the only limb."""
    a, w = _words((m, k), m + 6, kind), _int8_weight((k, n), k + 6, wkind)
    want = _pallas_bin_weight(a, w)
    at, wt8 = ring_from_numpy(a), torch.from_numpy(w)
    assert np.array_equal(
        ring_to_numpy(binmm.binary_weight_matmul_ref(at, wt8)), want)
    wt = binmm.binary_weight_t_ref(wt8)
    for split_k in _splits(k):
        got = limb_model(at[None], wt[None, None, None], n, split_k)[0]
        assert np.array_equal(ring_to_numpy(got), want), split_k


@pytest.mark.parametrize("wkind", ["pm1", "int8"])
@pytest.mark.parametrize("k,n", [(3, 10), (25, 32), (131, 24), (300, 129)])
def test_b6_weight_pass_is_the_transpose_padded(k, n, wkind):
    """An int8 weight is its own balanced limb: the pass's plain version is
    w.T, int8, zero-padded to multiples of 128, contiguous."""
    w = torch.from_numpy(_int8_weight((k, n), 23, wkind))
    wt = binmm.binary_weight_t_ref(w)
    assert wt.shape == (-(-n // 128) * 128, -(-k // 128) * 128)
    assert wt.dtype == torch.int8 and wt.is_contiguous()
    assert torch.equal(wt[:n, :k], w.T)
    assert torch.equal(balanced_limbs(w.to(torch.int32))[0], w)
    assert not wt[n:].any() and not wt[:, k:].any()


# -- the launch plan ----------------------------------------------------------

# (S, M, K, N) -> (route, K stages per split, splits) on 132 SMs
PLANS = {
    (3, 32, 3136, 512): (TENSOR_CORE, 9, 11),
    (3, 32, 784, 128): (TENSOR_CORE, 1, 25),
    (3, 512, 4608, 512): (TENSOR_CORE, 36, 4),
    (3, 2048, 2304, 256): (TENSOR_CORE, 36, 2),
    (3, 32768, 576, 64): (TENSOR_CORE, 18, 1),
    (3, 2048, 48, 48): (TENSOR_CORE, 2, 1),
    (3, 32768, 27, 64): (TENSOR_CORE, 1, 1),
    (3, 32768, 16, 16): (CUDA_CORE, 1, 1),
    # B5 and B6 at one slot: MnistNet4's conv1, conv2, fc1 and fc2
    (1, 25088, 25, 32): (TENSOR_CORE, 1, 1),
    (1, 6272, 800, 64): (TENSOR_CORE, 13, 2),
    (1, 32, 3136, 512): (TENSOR_CORE, 3, 33),
    (1, 32, 512, 10): (TENSOR_CORE, 1, 16),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_plan(shape):
    """The M = 32 fc layers split K until the tiles fill the card, grids
    just past a wave split to even their waves, the large-M conv layers
    and short K ranges do not split, and K <= 16 takes the CUDA cores."""
    route, per, splits = limb_mma_plan(*shape, sms=132)
    assert (route, per, splits) == PLANS[shape]
    steps = -(-shape[2] // K_STAGE)
    assert (splits - 1) * per < steps <= splits * per
