"""Port PRF (repro_torch.core.prf) == jax.random, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prf

SEEDS = [0, 1, 7, 42, 123456, 2**31 - 1, -1, -12345]


def _key(k):
    return tuple(int(w) for w in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    assert prf.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(seed, num):
    want = [_key(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert prf.split(prf.PRNGKey(seed), num) == want


@pytest.mark.parametrize("data", [0, 1, 2, 100003, 2**31 + 5, 2**32 - 1])
def test_fold_in(data):
    for seed in SEEDS[:4]:
        got = prf.fold_in(prf.PRNGKey(seed), data)
        want = _key(jax.random.fold_in(jax.random.PRNGKey(seed),
                                       np.uint32(data)))
        assert got == want


SHAPES = [(1,), (5,), (3, 7), (2, 3, 5), (1001,), (4, 33, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["uint32", "uint8"])
def test_bits(shape, dtype):
    jdt, tdt = {"uint32": (jnp.uint32, torch.int32),
                "uint8": (jnp.uint8, torch.uint8)}[dtype]
    for seed in (0, 3, 99):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
        want = np.asarray(jax.random.bits(jk, shape, jdt))
        got = prf.bits(_key(jk), shape, tdt).numpy()
        if dtype == "uint32":
            got = got.view(np.uint32)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_bits_multi_stacks_single_draws():
    keys = prf.split(prf.PRNGKey(5), 3)
    multi = prf.bits_multi(keys, (4, 9))
    for i, k in enumerate(keys):
        assert torch.equal(multi[i], prf.bits(k, (4, 9)))
