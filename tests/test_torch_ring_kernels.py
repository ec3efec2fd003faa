"""Port kernels B5–B7: the plain versions == the JAX package's public
wrappers (``ring_matmul_op``, ``binary_weight_matmul_op``,
``binary_binary_matmul_op``, which run the Pallas kernels in interpret
mode), over the reference's test shapes and MnistNet4's layer shapes at
batch 32; and ``rss_matmul_dot`` with leading dims.  The CUDA cases are in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import binary_matmul as binmm
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels import ring_matmul as ringmm
from repro_torch.weights import ring_from_numpy, ring_to_numpy

torch.set_num_threads(1)

# the reference's kernel-test shapes, then MnistNet4 at batch 32: conv1 and
# conv2 as im2col products, fc1 and fc2
SHAPES = [(128, 128, 128), (256, 128, 384), (128, 512, 128), (64, 96, 32),
          (33, 17, 5), (1, 128, 1), (25088, 25, 32), (6272, 800, 64),
          (32, 3136, 512), (32, 512, 10)]


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _binary(shape, seed, kind):
    """int8 ±1 ("pm1") or {0, 1} ("01") weights."""
    w = np.random.default_rng(seed).integers(0, 2, shape)
    return (2 * w - 1 if kind == "pm1" else w).astype(np.int8)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ring_matmul_plain_equals_pallas(m, k, n):
    a, b = _words((m, k), m + k), _words((k, n), n)
    want = np.asarray(jops.ring_matmul_op(jnp.asarray(a), jnp.asarray(b)))
    launches = kbuild.LAUNCHES["ring_matmul"]
    got = ops.ring_matmul_op(ring_from_numpy(a), ring_from_numpy(b))
    assert got.shape == (m, n)
    assert np.array_equal(ring_to_numpy(got), want)
    assert kbuild.LAUNCHES["ring_matmul"] == launches   # CPU: plain version


@pytest.mark.parametrize("m,k,n,kind", [s + ("pm1",) for s in SHAPES]
                         + [(128, 256, 128, "pm1"), (128, 256, 128, "01")])
def test_binary_weight_matmul_plain_equals_pallas(m, k, n, kind):
    a, w = _words((m, k), m + 2 * k), _binary((k, n), n, kind)
    want = np.asarray(jops.binary_weight_matmul_op(jnp.asarray(a),
                                                   jnp.asarray(w)))
    launches = kbuild.LAUNCHES["bin_weight_matmul"]
    got = ops.binary_weight_matmul_op(ring_from_numpy(a),
                                      torch.from_numpy(w))
    assert np.array_equal(ring_to_numpy(got), want)
    assert kbuild.LAUNCHES["bin_weight_matmul"] == launches


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_binary_binary_matmul_plain_equals_pallas(m, k, n):
    a, w = _binary((m, k), m, "pm1"), _binary((k, n), k + n, "pm1")
    want = np.asarray(jops.binary_binary_matmul_op(jnp.asarray(a),
                                                   jnp.asarray(w)))
    launches = kbuild.LAUNCHES["bin_bin_matmul"]
    got = ops.binary_binary_matmul_op(torch.from_numpy(a),
                                      torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert kbuild.LAUNCHES["bin_bin_matmul"] == launches


def test_binary_weight_matmul_any_int8_weight():
    """Exact for any int8 weight, not only ±1 / {0, 1}: the sign-extended
    byte is the reference oracle's uint32 cast."""
    a = _words((9, 13), 1)
    w = np.random.default_rng(2).integers(-128, 128, (13, 6)).astype(np.int8)
    want = a.astype(np.uint64) @ w.astype(np.int64).astype(np.uint64)
    got = binmm.binary_weight_matmul(ring_from_numpy(a), torch.from_numpy(w))
    assert np.array_equal(ring_to_numpy(got),
                          (want & 0xFFFFFFFF).astype(np.uint32))


@pytest.mark.parametrize("lead", [(), (3,), (2, 5, 4)])
def test_rss_matmul_dot_folds_leading_dims(lead):
    a, b = _words(lead + (27,), 3), _words((27, 11), 4)
    want = np.asarray(jops.rss_matmul_dot(jnp.asarray(a), jnp.asarray(b)))
    got = ops.rss_matmul_dot(ring_from_numpy(a), ring_from_numpy(b))
    assert got.shape == lead + (11,)
    assert np.array_equal(ring_to_numpy(got), want)


def test_wrappers_refuse_mismatched_operands():
    """Shape errors are the plain product's on the CPU; the kernel route
    checks shapes and types itself (CUDA cases in test_torch_cuda.py)."""
    with pytest.raises(ValueError):
        ringmm._check_operands("ring_matmul", torch.zeros(2, 3, dtype=torch.int32),
                               torch.zeros(4, 2, dtype=torch.int32),
                               torch.int32, torch.int32)
    with pytest.raises(ValueError):
        ringmm._check_operands("bin_weight_matmul",
                               torch.zeros(2, 3, dtype=torch.int32),
                               torch.zeros(3, 2, dtype=torch.int32),
                               torch.int32, torch.int8)
