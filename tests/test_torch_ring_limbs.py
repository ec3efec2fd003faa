"""Port ring encoding and limb decomposition == the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RING32 as JRING
from repro.kernels.limbs import balanced_limbs as j_limbs
from repro_torch.core.ring import RING32, shr
from repro_torch.kernels.limbs import balanced_limbs
from repro_torch.weights import ring_from_numpy, ring_to_numpy


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64) \
        .astype(np.uint32)


def test_encode_decode():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 4, 2000).astype(np.float32)
    # exact half-ulp ties round half to even in both frameworks
    ties = (np.arange(-20, 20) + 0.5).astype(np.float32) / 4096
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1e-9])])
    want = np.asarray(JRING.encode(jnp.asarray(x)))
    got = RING32.encode(torch.from_numpy(x))
    assert np.array_equal(ring_to_numpy(got), want)
    assert np.array_equal(RING32.decode(got).numpy(),
                          np.asarray(JRING.decode(jnp.asarray(want))))


def test_msb_and_logical_shift():
    w = _words(4096, 1)
    w[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    t = ring_from_numpy(w)
    assert np.array_equal(RING32.msb(t).numpy(),
                          np.asarray(JRING.msb(jnp.asarray(w))))
    for s in (1, 8, 12, 19, 31):
        assert np.array_equal(ring_to_numpy(shr(t, s)), w >> np.uint32(s))


def test_ring_numpy_round_trip():
    w = _words(100, 2)
    assert np.array_equal(ring_to_numpy(ring_from_numpy(w)), w)


BOUNDARY = [0, 1, 127, 128, 255, 256, 32767, 32768, 65535, 2**31 - 1, 2**31,
            2**32 - 1, 0x80808080, 0x7F7F7F7F, 0xFF00FF00]


@pytest.mark.parametrize("seed", [0, 1])
def test_balanced_limbs_match_reference(seed):
    w = np.concatenate([np.uint32(BOUNDARY), _words(5000, seed)]) \
        .reshape(-1, 5)
    got = balanced_limbs(ring_from_numpy(w)).numpy()
    want = np.asarray(j_limbs(jnp.asarray(w)))
    assert got.dtype == np.int8 and np.array_equal(got, want)
    # reconstruction mod 2^32
    rec = sum(got[p].astype(np.int64) << (8 * p) for p in range(4))
    assert np.array_equal((rec % 2**32).astype(np.uint32), w)


def test_balanced_limbs_carry_boundary():
    got = balanced_limbs(torch.tensor([32767], dtype=torch.int32))
    assert got[:, 0].tolist() == [-1, -128, 1, 0]
