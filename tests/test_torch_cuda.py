"""On the card: the port's CUDA kernels == their plain versions, exactly.

Imports neither JAX nor the reference package, so it runs on a machine
with the card and without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a CUDA device every case skips at run time.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import linear
from repro_torch.core.ring import RING32
from repro_torch.core.rss import RSS
from repro_torch.kernels import bin_rss_matmul as grp
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels import rss_matmul as dense
from repro_torch.weights import ring_from_numpy


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.fixture
def cuda():
    """Decides at run time: the CUDA cases skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(40, 136, 24), (72, 20, 9), (1, 3, 1),
                                   (130, 784, 10)])
def test_rss_matmul_cuda_equals_plain(cuda, m, k, n):
    x = ring_from_numpy(_words((3, m, k), 1))
    wl = dense.precompute_weight_limbs(ring_from_numpy(_words((3, k, n), 2)))
    launches = kbuild.LAUNCHES["rss_matmul"]
    got = dense.rss_matmul_parts(
        x.to(cuda), dense.WeightLimbs(*(a.to(cuda) for a in wl)))
    assert kbuild.LAUNCHES["rss_matmul"] == launches + 1
    assert torch.equal(got.cpu(), dense.rss_matmul_parts_ref(x, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,k,n", [(5, 40, 9, 1), (7, 24, 25, 2),
                                     (3, 1000, 9, 1)])
def test_grouped_cuda_equals_plain(cuda, c, m, k, n):
    x = ring_from_numpy(_words((3, m, k, c), 3)).permute(0, 3, 1, 2)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((3, c, k, n), 4)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    want = grp.grouped_rss_matmul_ref(x, wl)
    for xd in (x.to(cuda), x.contiguous().to(cuda)):  # both layouts
        got = grp.grouped_rss_matmul_parts(xd, wd)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    """A refused launch raises; there is no fallback to the plain path."""
    monkeypatch.setattr(dense, "rss_matmul_parts_ref",
                        lambda *a: pytest.fail("plain version on a card"))
    x = torch.zeros((3, 4, 5), dtype=torch.int32, device=cuda)
    wl = dense.precompute_weight_limbs(
        torch.zeros((3, 5, 2), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        dense.rss_matmul_parts(x, wl._replace(ws=wl.ws.to(torch.int64)))


@pytest.mark.cuda
def test_cuda_shares_without_weight_limbs_raise(cuda):
    """The protocols' plain products (no cached weight limbs) are for CPU
    tensors: on the card they raise instead of bypassing the kernels."""
    x = RSS(torch.zeros((3, 2, 6, 6, 4), dtype=torch.int32, device=cuda),
            RING32)
    w = RSS(torch.zeros((3, 3, 3, 1, 4), dtype=torch.int32, device=cuda),
            RING32)
    with pytest.raises(RuntimeError):
        linear._grouped_conv_parts(x, w, 1, 1, 4)
    cols = RSS(torch.zeros((3, 2, 9), dtype=torch.int32, device=cuda), RING32)
    wm = RSS(torch.zeros((3, 9, 4), dtype=torch.int32, device=cuda), RING32)
    with pytest.raises(RuntimeError):
        linear._matmul_parts(cols, wm, None)


def _public(shape, wmag, seed):
    """A public encoding with |w| < wmag (wmag None: full-range words)."""
    if wmag is None:
        return _words(shape, seed)
    w = np.random.default_rng(seed).integers(-wmag + 1, wmag, shape)
    return w.astype(np.int64).astype(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,k,n,wmag", [
    (3, 40, 136, 24, 4096), (2, 72, 20, 9, None), (3, 1, 3, 1, 64),
    (3, 32768, 3, 16, 4096), (3, 2048, 48, 48, 1 << 20),
    (3, 32, 784, 128, 4096), (1, 130, 768, 10, None)])
def test_bin_rss_matmul_cuda_equals_plain(cuda, s, m, k, n, wmag):
    x = ring_from_numpy(_words((s, m, k), 5))
    wl = grp.public_weight_limbs(ring_from_numpy(_public((k, n), wmag, 6)))
    launches = kbuild.LAUNCHES["bin_rss_matmul"]
    got = grp.bin_rss_matmul_parts(
        x.to(cuda), grp.PublicWeightLimbs(wl.w.to(cuda), wl.wl.to(cuda),
                                          wl.n_limbs))
    assert kbuild.LAUNCHES["bin_rss_matmul"] == launches + 1
    assert torch.equal(got.cpu(), grp.bin_rss_matmul_ref(x, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,m,k,n", [(3, 5, 40, 9, 1), (2, 7, 24, 25, 2),
                                       (3, 48, 2048, 9, 1),
                                       (3, 3, 1000, 9, 1)])
def test_bin_grouped_cuda_equals_plain(cuda, s, c, m, k, n):
    x = ring_from_numpy(_words((s, m, k, c), 7)).permute(0, 3, 1, 2)
    wl = grp.public_grouped_limbs(ring_from_numpy(_public((c, k, n), 4096,
                                                          8)))
    wd = grp.PublicGroupedLimbs(wl.w.to(cuda), wl.wl.to(cuda), wl.n_limbs)
    want = grp.bin_grouped_matmul_ref(x, wl)
    for xd in (x.to(cuda), x.contiguous().to(cuda)):  # both layouts
        launches = kbuild.LAUNCHES["bin_grouped_matmul"]
        got = grp.bin_grouped_matmul_parts(xd, wd)
        assert kbuild.LAUNCHES["bin_grouped_matmul"] == launches + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_public_ops_on_the_card_equal_plain(cuda):
    """The op wrappers' folds around B3 / B4 on card tensors."""
    x = ring_from_numpy(_words((3, 2, 5, 4, 27), 9))
    wl = grp.public_weight_limbs(ring_from_numpy(_public((27, 11), 4096, 1)))
    got = ops.bin_rss_matmul_op(
        x.to(cuda), grp.PublicWeightLimbs(wl.w.to(cuda), wl.wl.to(cuda),
                                          wl.n_limbs))
    assert torch.equal(got.cpu(), ops.bin_rss_matmul_op(x, wl))
    p = ring_from_numpy(_words((3, 2, 4, 5, 9, 6), 2))
    gl = grp.public_grouped_limbs(ring_from_numpy(_public((6, 9, 1), 64, 3)))
    got = ops.bin_grouped_matmul_op(
        p.to(cuda), grp.PublicGroupedLimbs(gl.w.to(cuda), gl.wl.to(cuda),
                                           gl.n_limbs))
    assert torch.equal(got.cpu(), ops.bin_grouped_matmul_op(p, gl))


@pytest.mark.cuda
def test_cuda_public_tensor_without_limbs_raises(cuda):
    """A bare PublicTensor (no kernel cache) takes the plain product on
    CPU tensors only: on the card it raises instead of bypassing B3/B4."""
    x = RSS(torch.zeros((3, 2, 6, 6, 4), dtype=torch.int32, device=cuda),
            RING32)
    dw = linear.PublicTensor(torch.zeros((3, 3, 1, 4), dtype=torch.int32,
                                         device=cuda))
    with pytest.raises(RuntimeError):
        linear.bin_conv2d(x, dw, None, padding=1, groups=4)
    dense = linear.PublicTensor(torch.zeros((3, 3, 4, 5), dtype=torch.int32,
                                            device=cuda))
    with pytest.raises(RuntimeError):
        linear.bin_conv2d(x, dense, None, padding=1)
    cols = RSS(torch.zeros((3, 2, 9), dtype=torch.int32, device=cuda), RING32)
    wm = linear.PublicTensor(torch.zeros((9, 4), dtype=torch.int32,
                                         device=cuda))
    with pytest.raises(RuntimeError):
        linear.bin_matmul(cols, wm, None)
