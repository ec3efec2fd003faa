"""Port kernels: plain versions == the JAX Pallas kernels (interpret mode)
and weight caches == the reference's.  The CUDA cases are in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bin_rss_matmul as jgrp
from repro.kernels import ops as jops
from repro.kernels import rss_matmul as jdense
from repro_torch.kernels import bin_rss_matmul as grp
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels import rss_matmul as dense
from repro_torch.weights import ring_from_numpy, ring_to_numpy

# the workers of a parallel run share the cores: one intra-op thread each
torch.set_num_threads(1)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# -- B1: the fused RSS matmul ----------------------------------------------

DENSE = [(40, 136, 24), (72, 20, 9)]


@pytest.mark.parametrize("m,k,n", DENSE)
def test_rss_matmul_plain_equals_pallas_kernel(m, k, n):
    x, w = _words((3, m, k), m), _words((3, k, n), n)
    jwl = jdense.precompute_weight_limbs(jnp.asarray(w))
    # ≥ min_dim in every axis: the Pallas kernel (interpret mode) runs
    want = np.asarray(jdense.rss_matmul_parts(jnp.asarray(x), jwl))
    wl = dense.precompute_weight_limbs(ring_from_numpy(w))
    launches = kbuild.LAUNCHES["rss_matmul"]
    got = dense.rss_matmul_parts(ring_from_numpy(x), wl)
    assert np.array_equal(ring_to_numpy(got), want)
    assert kbuild.LAUNCHES["rss_matmul"] == launches  # CPU: plain version


@pytest.mark.parametrize("m,k,n", DENSE)
def test_weight_limbs_cache_matches_reference(m, k, n):
    w = _words((3, k, n), k)
    jwl = jdense.precompute_weight_limbs(jnp.asarray(w))
    wl = dense.precompute_weight_limbs(ring_from_numpy(w))
    for name in ("ws", "wf"):
        assert np.array_equal(ring_to_numpy(getattr(wl, name)),
                              np.asarray(getattr(jwl, name)))
    for name in ("wl", "wfl"):
        assert np.array_equal(getattr(wl, name).numpy(),
                              np.asarray(getattr(jwl, name)))


def test_rss_matmul_op_folds_leading_dims():
    x, w = _words((3, 2, 5, 4, 27), 3), _words((3, 27, 11), 4)
    jwl = jdense.precompute_weight_limbs(jnp.asarray(w))
    want = np.asarray(jops.rss_matmul_parts_op(
        jnp.asarray(x), jnp.roll(jnp.asarray(x), -1, 0), jwl))
    got = ops.rss_matmul_parts_op(
        ring_from_numpy(x), None,
        dense.precompute_weight_limbs(ring_from_numpy(w)))
    assert got.shape == (3, 2, 5, 4, 11)
    assert np.array_equal(ring_to_numpy(got), want)


# -- B2: the grouped (depthwise) RSS product ---------------------------------

GROUPED = [(5, 40, 9, 1), (7, 24, 25, 2)]


@pytest.mark.parametrize("c,m,k,n", GROUPED)
def test_grouped_plain_equals_pallas_kernel(c, m, k, n):
    x, w = _words((3, c, m, k), c + m), _words((3, c, k, n), k)
    jwl = jgrp.grouped_weight_limbs(jnp.asarray(w))
    want = np.asarray(jgrp.grouped_rss_matmul_parts(jnp.asarray(x), jwl))
    wl = grp.grouped_weight_limbs(ring_from_numpy(w))
    launches = kbuild.LAUNCHES["grouped_rss_matmul"]
    got = grp.grouped_rss_matmul_parts(ring_from_numpy(x), wl)
    assert np.array_equal(ring_to_numpy(got), want)
    assert kbuild.LAUNCHES["grouped_rss_matmul"] == launches


@pytest.mark.parametrize("c,m,k,n", GROUPED)
def test_grouped_weight_limbs_cache_matches_reference(c, m, k, n):
    w = _words((3, c, k, n), c)
    jwl = jgrp.grouped_weight_limbs(jnp.asarray(w))
    wl = grp.grouped_weight_limbs(ring_from_numpy(w))
    for name in ("ws", "wf"):
        assert np.array_equal(ring_to_numpy(getattr(wl, name)),
                              np.asarray(getattr(jwl, name)))
    for name in ("wl", "wfl"):
        assert np.array_equal(getattr(wl, name).numpy(),
                              np.asarray(getattr(jwl, name)))


def test_grouped_op_reads_patch_layout():
    """(S, B, H, W, K, C) patches -> (S, B, H, W, C, N), as the reference's
    fold/transpose route, with the fold done as a strided view."""
    c, k = 6, 9
    x, w = _words((3, 2, 4, 5, k, c), 5), _words((3, c, k, 1), 6)
    jwl = jgrp.grouped_weight_limbs(jnp.asarray(w))
    want = np.asarray(jops.grouped_rss_matmul_op(jnp.asarray(x), None, jwl))
    got = ops.grouped_rss_matmul_op(
        ring_from_numpy(x), None, grp.grouped_weight_limbs(ring_from_numpy(w)))
    assert np.array_equal(ring_to_numpy(got), want)
