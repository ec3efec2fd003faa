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
from repro_torch.core import prf
from repro_torch.core.randomness import Parties
from repro_torch.core.rss import reconstruct, share
from repro_torch.kernels import bin_rss_matmul as grp
from repro_torch.kernels import binary_matmul as binmm
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import limbs
from repro_torch.kernels import ops
from repro_torch.kernels.lowering import KernelConfig
from repro_torch.kernels import ring_matmul as ringmm
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
@pytest.mark.parametrize("m,k,n", [(40, 136, 24), (72, 20, 9), (1, 3, 1),
                                   (130, 784, 10), (1, 256, 640)])
def test_rss_matmul_pair_entry_cuda_equals_plain(cuda, m, k, n):
    """B1's pair entry (one party, the neighbour share explicit) on both
    routes == its plain version."""
    x = ring_from_numpy(_words((1, m, k), 5))
    xn = ring_from_numpy(_words((1, m, k), 6))
    wl = dense.pair_weight_limbs(ring_from_numpy(_words((2, k, n), 7)))
    xd, xnd = x.to(cuda), xn.to(cuda)
    wd = dense.WeightLimbs(*(a.to(cuda) for a in wl))
    want = dense.rss_matmul_parts_ref(x, wl, xn)
    launches = dict(kbuild.LAUNCHES)
    got = dense.rss_matmul_parts(xd, wd, x_next_stack=xnd)
    assert kbuild.LAUNCHES["rss_matmul_pair"] == \
        launches["rss_matmul_pair"] + 1
    assert kbuild.LAUNCHES["rss_matmul"] == launches["rss_matmul"]
    assert torch.equal(got.cpu(), want)
    for route in (limbs.TENSOR_CORE, limbs.CUDA_CORE):
        got = dense._launch(xd, wd, KernelConfig(route), xnd)
        assert torch.equal(got.cpu(), want), route


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,k,n", [(5, 40, 9, 1), (7, 24, 25, 2),
                                     (3, 1000, 9, 1), (64, 512, 9, 1),
                                     *[(c, 70, k, n) for c in (3, 16, 96)
                                       for k in (9, 25, 4) for n in (1, 2)]])
def test_grouped_pair_entry_cuda_equals_plain(cuda, c, m, k, n):
    """B2's pair entry == its plain version on every route: both x layouts
    and an x view one word past an aligned base (4-byte loads), K = 9 / 25
    / any, 4, 2 or 1 channels a thread."""
    x, layouts = _grouped_layouts(1, c, m, k, 8, cuda)
    xn, next_layouts = _grouped_layouts(1, c, m, k, 9, cuda)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((3, c, k, n), 10)))
    own = grp.GroupedWeightLimbs(*(a[1:2] for a in wl))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in own))
    want = grp.grouped_rss_matmul_ref(x, own, xn)
    for name, xd in layouts.items():
        launches = kbuild.LAUNCHES["grouped_rss_matmul_pair"]
        got = grp.grouped_rss_matmul_parts(xd, wd,
                                           x_next_stack=next_layouts[name])
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES["grouped_rss_matmul_pair"] == launches + 1
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,k,n", [(16, 1000, 9, 1), (3, 70, 9, 1),
                                     (96, 70, 25, 2), (5, 70, 4, 1)])
def test_grouped_pair_first_design_equals_new(cuda, c, m, k, n):
    """The pair entry's first design (timed beside the new one) gives the new
    kernel's words; the pair entry takes no stacked design."""
    x, layouts = _grouped_layouts(1, c, m, k, 11, cuda)
    _, next_layouts = _grouped_layouts(1, c, m, k, 12, cuda)
    wl = grp.pair_grouped_limbs(ring_from_numpy(_words((2, c, k, n), 13)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    for name, xd in layouts.items():
        xnd = next_layouts[name]
        new = grp._launch(xd, wd, x_next_stack=xnd)
        first = grp._launch(xd, wd, grp.FIRST_PAIR, xnd)
        assert torch.equal(first.cpu(), new.cpu()), name
    with pytest.raises(ValueError):
        grp._launch(xd, wd, grp.PER_PARTY, xnd)
    with pytest.raises(ValueError):
        grp._launch(xd, wd, grp.FIRST_PAIR)


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


def _to(cache, device):
    """A weight cache (a NamedTuple of tensors and ints) on ``device``."""
    return type(cache)(*(a.to(device) if isinstance(a, torch.Tensor) else a
                         for a in cache))


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
    got = grp.bin_rss_matmul_parts(x.to(cuda), _to(wl, cuda))
    assert kbuild.LAUNCHES["bin_rss_matmul"] == launches + 1
    assert torch.equal(got.cpu(), grp.bin_rss_matmul_ref(x, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,m,k,n", [(3, 5, 40, 9, 1), (2, 7, 24, 25, 2),
                                       (3, 48, 2048, 9, 1),
                                       (3, 3, 1000, 9, 1),
                                       # slabs past 48 KB: channel ranges
                                       (3, 520, 40, 25, 1),
                                       (2, 520, 24, 25, 2),
                                       (1, 1500, 16, 9, 1)])
def test_bin_grouped_cuda_equals_plain(cuda, s, c, m, k, n):
    x, layouts = _grouped_layouts(s, c, m, k, 7, cuda)
    wl = grp.public_grouped_limbs(ring_from_numpy(_public((c, k, n), 4096,
                                                          8)))
    wd = _to(wl, cuda)
    want = grp.bin_grouped_matmul_ref(x, wl)
    for name, xd in layouts.items():
        launches = kbuild.LAUNCHES["bin_grouped_matmul"]
        got = grp.bin_grouped_matmul_parts(xd, wd)
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES["bin_grouped_matmul"] == launches + 1
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k", [9, 25, 4])
@pytest.mark.parametrize("c", [3, 16, 96])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_bin_grouped_all_slots_cuda_equals_plain(cuda, s, c, k, n):
    """B4 on every route (16-byte and 4-byte loads, K = 9 / 25 / any, the
    next row in flight or not) == its plain version, full-range words."""
    x, layouts = _grouped_layouts(s, c, 70, k, 71, cuda)
    wl = grp.public_grouped_limbs(ring_from_numpy(_words((c, k, n), 72)))
    wd = _to(wl, cuda)
    want = grp.bin_grouped_matmul_ref(x, wl)
    for name, xd in layouts.items():
        got = grp.bin_grouped_matmul_parts(xd, wd)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,m,k,n", [(3, 16, 1000, 9, 1), (3, 3, 70, 9, 1),
                                       (2, 96, 70, 25, 2), (1, 5, 70, 4, 1)])
def test_bin_grouped_first_design_equals_new(cuda, s, c, m, k, n):
    """B4's first design (timed beside the new one) gives the new kernel's
    words; its whole-slab stage still refuses a slab past 48 KB."""
    x, layouts = _grouped_layouts(s, c, m, k, 73, cuda)
    wl = grp.public_grouped_limbs(ring_from_numpy(_words((c, k, n), 74)))
    wd = _to(wl, cuda)
    for name, xd in layouts.items():
        new = grp._launch_bin_grouped(xd, wd)
        first = grp._launch_bin_grouped(xd, wd, grp.PER_SLOT)
        assert torch.equal(first.cpu(), new.cpu()), name
    big = _to(grp.public_grouped_limbs(torch.zeros((520, 25, 1),
                                                   dtype=torch.int32)), cuda)
    xb = torch.zeros((1, 520, 4, 25), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        grp._launch_bin_grouped(xb, big, grp.PER_SLOT)
    assert torch.equal(grp._launch_bin_grouped(xb, big).cpu(),
                       torch.zeros((1, 520, 4, 1), dtype=torch.int32))


@pytest.mark.cuda
def test_public_ops_on_the_card_equal_plain(cuda):
    """The op wrappers' folds around B3 / B4 on card tensors."""
    x = ring_from_numpy(_words((3, 2, 5, 4, 27), 9))
    wl = grp.public_weight_limbs(ring_from_numpy(_public((27, 11), 4096, 1)))
    got = ops.bin_rss_matmul_op(x.to(cuda), _to(wl, cuda))
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


# -- B1 / B3 routes: int8 tensor cores over limbs, CUDA cores at tiny K ------

# the M = 32 fc layers of the served paths, whose tiles split K
SPLIT_K_B1 = [(3, 32, 3136, 512), (3, 32, 2048, 512), (3, 32, 784, 128)]
SPLIT_K_B3 = [(3, 32, 3136, 512), (3, 32, 784, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,k,n", SPLIT_K_B1)
def test_rss_matmul_cuda_split_k_exact_and_repeatable(cuda, s, m, k, n):
    assert limbs.limb_mma_plan(s, m, k, n, limbs.sm_count(cuda))[2] > 1
    x = ring_from_numpy(_words((s, m, k), 11))
    wl = dense.precompute_weight_limbs(ring_from_numpy(_words((s, k, n), 12)))
    xd, wd = x.to(cuda), _to(wl, cuda)
    got = dense.rss_matmul_parts(xd, wd)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dense.rss_matmul_parts_ref(x, wl))
    for _ in range(5):
        assert torch.equal(dense.rss_matmul_parts(xd, wd), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_limbs", [2, 4])
@pytest.mark.parametrize("s,m,k,n", SPLIT_K_B3)
def test_bin_rss_matmul_cuda_split_k_exact_and_repeatable(cuda, s, m, k, n,
                                                          n_limbs):
    assert limbs.limb_mma_plan(s, m, k, n, limbs.sm_count(cuda))[2] > 1
    x = ring_from_numpy(_words((s, m, k), 13))
    wmag = None if n_limbs == 4 else 1 << 14
    wl = grp.public_weight_limbs(ring_from_numpy(_public((k, n), wmag, 14)))
    assert wl.n_limbs == n_limbs
    xd, wd = x.to(cuda), _to(wl, cuda)
    got = grp.bin_rss_matmul_parts(xd, wd)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), grp.bin_rss_matmul_ref(x, wl))
    for _ in range(5):
        assert torch.equal(grp.bin_rss_matmul_parts(xd, wd), got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [limbs.TENSOR_CORE, limbs.CUDA_CORE])
@pytest.mark.parametrize("s,m,k,n", [(3, 200, 3, 16), (3, 70, 25, 32),
                                     (1, 40, 136, 24), (2, 65, 131, 10),
                                     (3, 300, 32, 48), (3, 130, 784, 70)])
def test_both_routes_equal_plain(cuda, route, s, m, k, n):
    """Each route at ragged shapes, whichever the plan would take, with x
    16-byte aligned and one word past it (the 4-byte copies)."""
    buf = ring_from_numpy(_words((s * m * k + 1,), 15)).to(cuda)
    w = ring_from_numpy(_words((s, k, n), 16))
    wl = dense.precompute_weight_limbs(w)
    pl = grp.public_weight_limbs(w[0])
    for off in (0, 1):
        xd = buf[off:off + s * m * k].view(s, m, k)
        x = xd.cpu()
        got = dense._launch(xd, _to(wl, cuda), KernelConfig(route))
        assert torch.equal(got.cpu(), dense.rss_matmul_parts_ref(x, wl))
        got = grp._launch_bin(xd, _to(pl, cuda), KernelConfig(route))
        assert torch.equal(got.cpu(), grp.bin_rss_matmul_ref(x, pl))


@pytest.mark.cuda
def test_limb_accumulators_wrap_exactly(cuda):
    """Carry-boundary words at K = 9000 overflow the per-shift int32
    accumulators many times over; the wrap is the ring arithmetic."""
    edge = np.array([0xFFFFFFFF, 0x80808080, 0x7F7F7F7F, 0x80000000],
                    dtype=np.uint32)
    rng = np.random.default_rng(17)
    x = ring_from_numpy(rng.choice(edge, (3, 64, 9000)))
    w = ring_from_numpy(rng.choice(edge, (3, 9000, 64)))
    wl = dense.precompute_weight_limbs(w)
    got = dense._launch(x.to(cuda), _to(wl, cuda),
                        KernelConfig(limbs.TENSOR_CORE))
    assert torch.equal(got.cpu(), dense.rss_matmul_parts_ref(x, wl))
    pl = grp.public_weight_limbs(w[1])
    got = grp._launch_bin(x.to(cuda), _to(pl, cuda),
                         KernelConfig(limbs.TENSOR_CORE))
    assert torch.equal(got.cpu(), grp.bin_rss_matmul_ref(x, pl))


@pytest.mark.cuda
def test_k_major_caches_on_the_card_are_the_transposed_limbs(cuda):
    w = ring_from_numpy(_words((3, 131, 10), 18)).to(cuda)
    wl = dense.precompute_weight_limbs(w)
    assert torch.equal(wl.wt[:, 0], wl.wfl.transpose(-1, -2))
    assert torch.equal(wl.wt[:, 1], wl.wl.transpose(-1, -2))
    pl = grp.public_weight_limbs(w[0])
    assert torch.equal(pl.wt[:, :10, :131], pl.wl.transpose(1, 2))
    assert not pl.wt[:, 10:].any() and not pl.wt[:, :, 131:].any()


# -- B5–B7: the per-dot ring product and the binarized products ---------------

RAGGED = [(33, 17, 5), (1, 128, 1), (65, 70, 67), (130, 784, 10),
          (7, 3, 1), (257, 129, 65)]


def _int8(shape, seed, lo=-128, hi=128):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, shape).astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_ring_kernels_cuda_equal_plain(cuda, m, k, n):
    a = ring_from_numpy(_words((m, k), 11))
    b = ring_from_numpy(_words((k, n), 12))
    w = _int8((k, n), 13)
    a8 = _int8((m, k), 14, -1, 2)
    cases = [("ring_matmul", ops.ring_matmul_op, ringmm.ring_matmul_ref,
              a, b),
             ("bin_weight_matmul", ops.binary_weight_matmul_op,
              binmm.binary_weight_matmul_ref, a, w),
             ("bin_bin_matmul", ops.binary_binary_matmul_op,
              binmm.binary_binary_matmul_ref, a8, w)]
    for name, op, plain, x, y in cases:
        launches = kbuild.LAUNCHES[name]
        got = op(x.to(cuda), y.to(cuda))
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES[name] == launches + 1, name
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), plain(x, y)), name


# -- B5 on the int8 limb tensor cores: the split pass, both routes, split-K ---

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(3, 10), (131, 24), (300, 129), (3136, 512)])
def test_ring_split_pass_equals_plain(cuda, k, n):
    """b's balanced limbs, K-major and 128-padded, written by one pass."""
    b = ring_from_numpy(_words((k, n), 41))
    got = ringmm.split_weight_limbs(b.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ringmm.ring_weight_limbs_ref(b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(7, 3, 1), (200, 16, 48), (33, 9, 70)])
def test_ring_matmul_cuda_core_route_at_small_k(cuda, m, k, n):
    assert limbs.limb_mma_plan(1, m, k, n, limbs.sm_count(cuda))[0] \
        == limbs.CUDA_CORE
    a, b = ring_from_numpy(_words((m, k), 42)), ring_from_numpy(
        _words((k, n), 43))
    got = ops.ring_matmul_op(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), ringmm.ring_matmul_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(32, 3136, 512), (32, 512, 10),
                                   (32, 784, 128)])
def test_ring_matmul_cuda_split_k_exact_and_repeatable(cuda, m, k, n):
    """The M = 32 fc layers split K; the blocks add with int32 atomics."""
    assert limbs.limb_mma_plan(1, m, k, n, limbs.sm_count(cuda))[2] > 1
    a, b = ring_from_numpy(_words((m, k), 44)), ring_from_numpy(
        _words((k, n), 45))
    ad, bd = a.to(cuda), b.to(cuda)
    got = ops.ring_matmul_op(ad, bd)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ringmm.ring_matmul_ref(a, b))
    for _ in range(5):
        assert torch.equal(ops.ring_matmul_op(ad, bd), got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [limbs.TENSOR_CORE, limbs.CUDA_CORE])
@pytest.mark.parametrize("m,k,n", [(65, 70, 67), (1, 128, 1), (257, 17, 65),
                                   (6272, 800, 64)])
def test_ring_matmul_both_routes_equal_plain(cuda, route, m, k, n):
    a, b = ring_from_numpy(_words((m, k), 46)), ring_from_numpy(
        _words((k, n), 47))
    got = ringmm._launch_ring(a.to(cuda), b.to(cuda), route)
    assert torch.equal(got.cpu(), ringmm.ring_matmul_ref(a, b))


@pytest.mark.cuda
def test_ring_matmul_limb_accumulators_wrap_exactly(cuda):
    """Carry-boundary words at K = 9000 overflow every shift's int32
    accumulator; the plan's split and one unsplit range both wrap to the
    ring."""
    edge = np.array([0xFFFFFFFF, 0x80808080, 0x7F7F7F7F, 0x80000000],
                    dtype=np.uint32)
    rng = np.random.default_rng(48)
    a = ring_from_numpy(rng.choice(edge, (64, 9000)))
    b = ring_from_numpy(rng.choice(edge, (9000, 64)))
    want = ringmm.ring_matmul_ref(a, b)
    ad, bd = a.to(cuda), b.to(cuda)
    assert torch.equal(ops.ring_matmul_op(ad, bd).cpu(), want)
    assert torch.equal(ringmm._launch_ring(ad, bd, limbs.TENSOR_CORE).cpu(),
                       want)


@pytest.mark.cuda
def test_new_ops_never_take_the_plain_version(cuda, monkeypatch):
    """On a card the three ops launch their kernels or raise; the plain
    versions never run."""
    for mod, fn in ((ringmm, "ring_matmul_ref"),
                    (binmm, "binary_weight_matmul_ref"),
                    (binmm, "binary_binary_matmul_ref")):
        monkeypatch.setattr(mod, fn,
                            lambda *a: pytest.fail("plain version on a card"))
    i32 = torch.ones((4, 5), dtype=torch.int32, device=cuda)
    i8 = torch.ones((5, 3), dtype=torch.int8, device=cuda)
    # refused operands raise
    with pytest.raises(ValueError):
        ops.ring_matmul_op(i32, i8)
    with pytest.raises(ValueError):
        ops.binary_weight_matmul_op(i32, i8.to(torch.int32))
    with pytest.raises(ValueError):
        ops.binary_binary_matmul_op(i32, i8)
    with pytest.raises(ValueError):
        ops.rss_matmul_dot(i32, i8)
    # accepted operands launch
    assert int(ops.ring_matmul_op(i32, i32.T.contiguous())[0, 0]) == 5
    assert int(ops.binary_weight_matmul_op(i32, i8)[0, 0]) == 5
    assert int(ops.binary_binary_matmul_op(i8.T.contiguous(),
                                           i8)[0, 0]) == 5
    assert tuple(ops.rss_matmul_dot(
        torch.ones((2, 3, 5), dtype=torch.int32, device=cuda),
        i32.T.contiguous()).shape) == (2, 3, 4)


@pytest.fixture
def matmul_mode():
    """Sets the port's matmul mode for one test; restores "opt2"."""
    try:
        yield linear.set_matmul_mode
    finally:
        linear.set_matmul_mode("opt2")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,launches", [("opt2", 6), ("paper3", 9)])
def test_per_dot_layer_runs_on_b5_only(cuda, matmul_mode, mode, launches):
    """A secure fc layer with dot=rss_matmul_dot launches B5 once per
    per-party product and nothing else, and opens to the value of the
    same layer on cached weight limbs (B1)."""
    matmul_mode(mode)
    rng = np.random.default_rng(15)
    x = share(torch.as_tensor(rng.normal(0, 1, (4, 40)), dtype=torch.float32,
                              device=cuda), prf.PRNGKey(1))
    w = share(torch.as_tensor(rng.normal(0, 0.2, (40, 9)),
                              dtype=torch.float32, device=cuda),
              prf.PRNGKey(2))
    b = share(torch.zeros(9, device=cuda), prf.PRNGKey(3))
    parties = Parties.setup(prf.PRNGKey(4), device=cuda)
    before = dict(kbuild.LAUNCHES)
    got = linear.linear_layer(x, w, b, parties.fresh(), dot=ops.rss_matmul_dot)
    torch.cuda.synchronize()
    diff = {k: v - before[k] for k, v in kbuild.LAUNCHES.items()
            if v != before[k]}
    assert diff == {"ring_matmul": launches}
    wl = dense.precompute_weight_limbs(w.shares)
    want = linear.linear_layer(x, None, b, parties.fresh(), w_limbs=wl)
    assert torch.equal(reconstruct(got, decode=False),
                       reconstruct(want, decode=False))


# -- B6 on the int8 limb tensor cores: the weight pass, both routes, split-K -

# the reference's kernel-test shapes, MnistNet4's four layers at batch 32,
# and K <= 16 (the CUDA-core route)
B6_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 512, 128), (64, 96, 32),
             (33, 17, 5), (1, 128, 1), (25088, 25, 32), (6272, 800, 64),
             (32, 3136, 512), (32, 512, 10), (7, 3, 1), (200, 16, 48),
             (33, 9, 70)]


def _int8_weight(shape, seed, kind):
    """±1 ("pm1"), {0, 1} ("01"), or full-range int8 holding -128 and 127."""
    if kind == "pm1":
        return 2 * _int8(shape, seed, 0, 2) - 1
    if kind == "01":
        return _int8(shape, seed, 0, 2)
    w = _int8(shape, seed)
    w.view(-1)[0], w.view(-1)[-1] = -128, 127
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("wkind", ["pm1", "01", "int8"])
@pytest.mark.parametrize("m,k,n", B6_SHAPES)
def test_bin_weight_matmul_cuda_routes_equal_plain(cuda, m, k, n, wkind):
    """The plan's route launches once; split-K shapes repeat bit for bit
    (int32 atomics); the route not taken gives the same words."""
    a = ring_from_numpy(_words((m, k), 51))
    w = _int8_weight((k, n), 52, wkind)
    want = binmm.binary_weight_matmul_ref(a, w)
    ad, wd = a.to(cuda), w.to(cuda)
    route, _, splits = limbs.limb_mma_plan(1, m, k, n, limbs.sm_count(cuda))
    assert route == (limbs.CUDA_CORE if k <= 16 else limbs.TENSOR_CORE)
    launches = kbuild.LAUNCHES["bin_weight_matmul"]
    got = ops.binary_weight_matmul_op(ad, wd)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["bin_weight_matmul"] == launches + 1
    assert torch.equal(got.cpu(), want)
    if splits > 1:
        for _ in range(5):
            assert torch.equal(ops.binary_weight_matmul_op(ad, wd), got)
    for forced in (limbs.TENSOR_CORE, limbs.CUDA_CORE):
        assert torch.equal(binmm._launch_bin_weight(ad, wd, forced).cpu(),
                           want), forced


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(3, 10), (25, 32), (131, 24), (300, 129),
                                 (3136, 512)])
def test_bin_weight_pass_equals_plain(cuda, k, n):
    """w.T as one K-major 128-padded int8 plane, zero past K and N."""
    w = _int8_weight((k, n), 53, "int8")
    got = binmm.binary_weight_t(w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), binmm.binary_weight_t_ref(w))


@pytest.mark.cuda
def test_bin_weight_matmul_limb_accumulators_wrap_exactly(cuda):
    """Carry-boundary words times -128 / 127 at K = 9000 overflow every
    shift's int32 accumulator; split and unsplit both wrap to the ring."""
    edge = np.array([0xFFFFFFFF, 0x80808080, 0x7F7F7F7F, 0x80000000],
                    dtype=np.uint32)
    rng = np.random.default_rng(54)
    a = ring_from_numpy(rng.choice(edge, (64, 9000)))
    w = torch.from_numpy(rng.choice(np.array([-128, 127], dtype=np.int8),
                                    (9000, 64)))
    want = binmm.binary_weight_matmul_ref(a, w)
    ad, wd = a.to(cuda), w.to(cuda)
    assert torch.equal(ops.binary_weight_matmul_op(ad, wd).cpu(), want)
    assert torch.equal(
        binmm._launch_bin_weight(ad, wd, limbs.TENSOR_CORE).cpu(), want)


# -- B2: every share slot read once, both x layouts ----------------------------

def _grouped_layouts(s, c, m, k, seed, device):
    """The same (S, C, M, K) words on the card as the channel-contiguous
    view of an (S, M, K, C) buffer, that view one word past an aligned base
    (4-byte loads), and a contiguous (S, C, M, K) tensor; and on the host."""
    x = ring_from_numpy(_words((s, m, k, c), seed))
    buf = torch.zeros(x.numel() + 1, dtype=torch.int32, device=device)
    buf[1:] = x.reshape(-1).to(device)
    shifted = buf[1:].view(s, m, k, c).permute(0, 3, 1, 2)
    xd = x.to(device).permute(0, 3, 1, 2)
    x = x.permute(0, 3, 1, 2)
    return x, {"c-contiguous": xd, "offset-by-one-word": shifted,
               "k-contiguous": xd.contiguous()}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("k", [9, 25, 7])
@pytest.mark.parametrize("c", [3, 5, 16, 48])
@pytest.mark.parametrize("s", [1, 3])
def test_grouped_all_parties_cuda_equals_plain(cuda, s, c, k, n):
    m = 70
    x, layouts = _grouped_layouts(s, c, m, k, 61, cuda)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((s, c, k, n), 62)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    want = grp.grouped_rss_matmul_ref(x, wl)
    for name, xl in layouts.items():
        launches = kbuild.LAUNCHES["grouped_rss_matmul"]
        got = grp.grouped_rss_matmul_parts(xl, wd)
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES["grouped_rss_matmul"] == launches + 1
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,k,n", [(3, 512, 9, 1), (3, 96, 25, 2),
                                     (1, 700, 9, 2)])
def test_grouped_weight_slabs_over_48kb(cuda, s, c, k, n):
    """Slabs past the 48 KB default opt in to more shared memory."""
    assert 8 * s * c * k * n > 48 * 1024
    x, layouts = _grouped_layouts(s, c, 40, k, 63, cuda)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((s, c, k, n), 64)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    want = grp.grouped_rss_matmul_ref(x, wl)
    for name, xl in layouts.items():
        got = grp.grouped_rss_matmul_parts(xl, wd)
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
def test_grouped_slabs_past_the_opt_in_limit_raise(cuda):
    wl = grp.grouped_weight_limbs(torch.zeros((3, 1200, 9, 1),
                                              dtype=torch.int32))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    x = torch.zeros((3, 1200, 4, 9), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        grp.grouped_rss_matmul_parts(x, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,m,k,n", [(3, 16, 1000, 9, 1), (3, 3, 70, 9, 1),
                                       (1, 5, 70, 25, 2)])
def test_grouped_first_design_equals_plain(cuda, s, c, m, k, n):
    """The per-party kernel (timed beside the new one) still holds."""
    x, layouts = _grouped_layouts(s, c, m, k, 65, cuda)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((s, c, k, n), 66)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    want = grp.grouped_rss_matmul_ref(x, wl)
    for name, xl in layouts.items():
        got = grp._launch(xl, wd, grp.PER_PARTY)
        assert torch.equal(got.cpu(), want), name


# -- B8 / B9: the float kernels of the LM path --------------------------------

from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402


def _normal(shape, seed, scale=1.0):
    return torch.as_tensor(np.random.default_rng(seed).normal(0, scale,
                                                              shape),
                           dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hkv,hd", [(256, 4, 4, 64), (256, 8, 2, 64),
                                        (128, 4, 1, 32), (1000, 4, 2, 64),
                                        (33, 2, 1, 32), (70, 2, 2, 32),
                                        (256, 4, 2, 96), (70, 2, 2, 96),
                                        (256, 4, 4, 128), (1000, 4, 1, 128)])
def test_flash_attention_cuda_equals_plain(cuda, s, h, hkv, hd):
    """fp32 at the reference's 2e-5 (its kernel-test tolerance), any S."""
    q = _normal((2, s, h, hd), 1)
    k, v = _normal((2, s, hkv, hd), 2), _normal((2, s, hkv, hd), 3)
    launches = kbuild.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["flash_attention"] == launches + 1
    want = flash.flash_attention_ref(q, k, v)
    assert float((got.cpu() - want).abs().max()) < 2e-5


@pytest.mark.cuda
def test_flash_attention_cuda_bf16_strided(cuda):
    """bf16 q/k/v read through strides (slices of one fused qkv buffer, as
    a projection gives them): within one bf16 rounding of the plain
    version, whose float32 math the kernel repeats."""
    b, s, h, hkv, hd = 2, 300, 8, 2, 64
    qkv = _normal((b, s, (h + 2 * hkv) * hd), 4).to(torch.bfloat16)
    q = qkv[..., :h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + hkv) * hd].reshape(b, s, hkv, hd)
    v = qkv[..., (h + hkv) * hd:].reshape(b, s, hkv, hd)
    got = ops.flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda)).cpu()
    want = flash.flash_attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    bound = 2.0 ** -7 * want.float().abs() + 1e-5
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def _bf16_gate(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element within one bf16 rounding of the plain version (itself
    rounded once to bf16): 2^-7 of |want| + 1e-5."""
    bound = 2.0 ** -7 * want.float().abs() + 1e-5
    return bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [33, 70, 1000])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_attention_cuda_bf16(cuda, s, hd, group):
    """The tensor-core route at ragged S (the diagonal tile is also the
    ragged one), every head width (96: three 64-byte swizzle blocks a
    row, 128: two 128-byte ones) and GQA groups 1, 2 and 8, under the
    bf16 gate."""
    hkv = 2
    q = _normal((2, s, group * hkv, hd), 21).to(torch.bfloat16)
    k = _normal((2, s, hkv, hd), 22).to(torch.bfloat16)
    v = _normal((2, s, hkv, hd), 23).to(torch.bfloat16)
    launches = kbuild.LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda)).cpu()
    assert kbuild.LAUNCHES["flash_attention"] == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _bf16_gate(got, flash.flash_attention_ref(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 128])
def test_flash_attention_cuda_bf16_strided_wide(cuda, hd):
    """Slices of one fused qkv buffer at the wide head widths (GQA 8 / 2,
    ragged S): rows of two or three swizzle blocks read through strides."""
    b, s, h, hkv = 2, 300, 8, 2
    qkv = _normal((b, s, (h + 2 * hkv) * hd), 24).to(torch.bfloat16)
    q = qkv[..., :h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + hkv) * hd].reshape(b, s, hkv, hd)
    v = qkv[..., (h + hkv) * hd:].reshape(b, s, hkv, hd)
    got = ops.flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda)).cpu()
    assert _bf16_gate(got, flash.flash_attention_ref(q, k, v))


@pytest.mark.cuda
def test_flash_attention_cuda_padded_head_width(cuda):
    """hd 80 (hubert's) runs the hd 96 instantiation on zero-padded heads
    and equals the plain version at hd 80 within one bf16 rounding."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 300, n, 80), generator=g).bfloat16()
               for n in (8, 2, 2))
    got = ops.flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda)).cpu()
    assert got.shape == q.shape and got.is_contiguous()
    assert _bf16_gate(got, flash.flash_attention_ref(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_wide_heads_never_take_the_plain_version(
        cuda, monkeypatch, dtype):
    """A CUDA tensor at hd 96 or 128, or at a width padded to the next
    instantiation (16, 80), launches the kernel (the counter goes up by
    one) and never reaches the plain version; a width past the widest
    instantiation raises before any launch."""
    monkeypatch.setattr(flash, "flash_attention_ref",
                        lambda *a, **kw: pytest.fail("plain version on a "
                                                     "card"))
    for hd in (96, 128, 16, 80):
        q = torch.zeros((1, 70, 4, hd), dtype=dtype, device=cuda)
        kv = torch.zeros((1, 70, 2, hd), dtype=dtype, device=cuda)
        launches = kbuild.LAUNCHES["flash_attention"]
        out = ops.flash_attention_op(q, kv, kv)
        torch.cuda.synchronize()
        assert kbuild.LAUNCHES["flash_attention"] == launches + 1
        assert out.shape == q.shape and bool((out == 0).all())
    for hd in (136, 256):
        q = torch.zeros((1, 70, 4, hd), dtype=dtype, device=cuda)
        kv = torch.zeros((1, 70, 2, hd), dtype=dtype, device=cuda)
        launches = kbuild.LAUNCHES["flash_attention"]
        with pytest.raises(ValueError, match="widest instantiation"):
            ops.flash_attention_op(q, kv, kv)
        assert kbuild.LAUNCHES["flash_attention"] == launches


@pytest.mark.cuda
def test_flash_attention_cuda_bf16_misaligned_raises(cuda):
    """The bf16 kernel's 16-byte copies need strides that are multiples of
    8 elements and aligned bases: anything else raises before a launch."""
    b, s, h, hd = 2, 40, 2, 64
    buf = torch.zeros((b, s, h * hd + 4), dtype=torch.bfloat16, device=cuda)
    q = buf[..., :h * hd].reshape(b, s, h, hd)          # seq stride 132
    kv = torch.zeros((b, s, 1, hd), dtype=torch.bfloat16, device=cuda)
    shifted = torch.zeros((b, s * h * hd + 1), dtype=torch.bfloat16,
                          device=cuda)[:, 1:].reshape(b, s, h, hd)
    launches = kbuild.LAUNCHES["flash_attention"]
    for bad in (q, shifted):
        with pytest.raises(ValueError):
            ops.flash_attention_op(bad, kv, kv)
    assert kbuild.LAUNCHES["flash_attention"] == launches


# -- MLA (deepseek v2/v3): plain torch on the card, no kernel ----------------

def _mla_setup(device):
    """The reduced deepseek-v2 MLA layer from seed 0 and its latent cache
    (2 x 8), on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.nn import attention as attn
    cfg = get_config("deepseek-v2-236b").reduced()
    p = attn.mla_init(torch.Generator().manual_seed(0), cfg).to(device)
    cache = {"c_kv": torch.zeros((2, 8, cfg.kv_lora_rank),
                                 dtype=torch.bfloat16, device=device),
             "k_rope": torch.zeros((2, 8, cfg.rope_head_dim),
                                   dtype=torch.bfloat16, device=device)}
    return cfg, attn, p, cache


def _close_card(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Card against CPU: the bf16 products sum in another order there, so
    a value may round one bf16 ulp apart and carry it one product on:
    within 2^-6 of the scale."""
    err = float((got.cpu().float() - want.float()).abs().max())
    return err <= 2.0 ** -6 * float(want.float().abs().max())


@pytest.mark.cuda
def test_mla_prefill_on_the_card_equals_cpu(cuda):
    """MLA prefill (float32 _sdpa, q·k 48 wide, v 32) on the card against
    the CPU: the output and the latent cache; no kernel launches."""
    outs = {}
    x = _normal((2, 40, 128), 31).to(torch.bfloat16)
    for dev in ("cpu", cuda):
        cfg, attn, p, _ = _mla_setup(dev)
        before = dict(kbuild.LAUNCHES)
        out, (c_kv, k_rope) = attn.mla_prefill(p, x.to(dev), cfg)
        assert kbuild.LAUNCHES == before
        outs[str(dev)] = (out, c_kv, k_rope)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.device.type == "cuda" and _close_card(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_on_the_card_equals_cpu(cuda, absorbed):
    """Four decode steps (naive or absorbed) on the card against the CPU:
    each step's output and both cache tensors."""
    runs = {}
    for dev in ("cpu", cuda):
        cfg, attn, p, cache = _mla_setup(dev)
        fn = attn.mla_decode_absorbed if absorbed else attn.mla_decode
        outs = []
        for pos in range(4):
            x = _normal((2, 1, 128), 40 + pos).to(torch.bfloat16).to(dev)
            out, cache = fn(p, x, cache, pos, cfg)
            outs.append(out)
        runs[str(dev)] = (torch.cat(outs, 1), cache["c_kv"],
                          cache["k_rope"])
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert _close_card(got, want)


MNIST4 = [(25088, 25, 32), (6272, 800, 64), (32, 3136, 512), (32, 512, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MNIST4)
def test_bin_bin_matmul_cuda_mnist4_exact_and_repeatable(cuda, m, k, n):
    """B7 at MnistNet4's layer shapes (conv1, conv2 as im2col products; fc1,
    whose 8 output tiles split K over grid.z and add with atomics; fc2) on
    any int8 operands: equal to the plain version, and bit-identical on
    repeats."""
    a, w = _int8((m, k), 31), _int8((k, n), 32)
    ad, wd = a.to(cuda), w.to(cuda)
    launches = kbuild.LAUNCHES["bin_bin_matmul"]
    got = ops.binary_binary_matmul_op(ad, wd)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["bin_bin_matmul"] == launches + 1
    assert torch.equal(got.cpu(), binmm.binary_binary_matmul_ref(a, w))
    for _ in range(5):
        assert torch.equal(ops.binary_binary_matmul_op(ad, wd), got)


# the reference's kernel-test shapes, Mamba2-1.3B's widths, and ragged ones:
# a chunk of 96 (neither <= 64 nor a multiple of 64), hd 80, N 24 and 160;
# hd 18 / N 6 and a chunk of 30 take the 4-byte copies (rows not 16-byte
# aligned)
SSD_CUDA = [(128, 2, 32, 16, 64), (256, 1, 64, 32, 64), (64, 4, 16, 8, 32),
            (512, 2, 64, 128, 256), (192, 3, 80, 24, 96),
            (256, 2, 128, 160, 128), (96, 2, 18, 6, 32), (60, 3, 10, 5, 30)]


def _ssd_inputs(bsz, s, h, hd, n):
    x = _normal((bsz, s, h, hd), 5, 0.5)
    bm, cm = _normal((bsz, s, n), 6, 0.5), _normal((bsz, s, n), 7, 0.5)
    da = -_normal((bsz, s, h), 8, 0.3).abs()
    dt = _normal((bsz, s, h), 9, 0.3).abs() + 0.1
    return x, bm, cm, da, dt


def _ssd_rel_err(got, want) -> float:
    return float((got.cpu() - want).abs().max()) / float(want.abs().max())


def _within_ssd_gate(got, want):
    return float((got.cpu() - want).abs().max()) \
        <= 2e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("s,h,hd,n,chunk", SSD_CUDA)
def test_ssd_scan_cuda_equals_plain(cuda, bsz, s, h, hd, n, chunk):
    """The kernel's float32 chunk math within 2e-5 of max |y| of the same
    math in float64 on the host (the reference's 5e-4 is its
    kernel-against-recurrence tolerance), and a repeat bit-identical (the
    passes sum in a fixed order, with no atomics).  The float32 plain
    version's own summation order on the host CPU varies with its thread
    count and BLAS path, so it is printed beside, not gated."""
    host = _ssd_inputs(bsz, s, h, hd, n)
    dev = [t.to(cuda) for t in host]
    launches = kbuild.LAUNCHES["ssd_scan"]
    got = ssd.ssd_scan(*dev, chunk=chunk)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["ssd_scan"] == launches + 1
    assert torch.equal(ssd.ssd_scan(*dev, chunk=chunk), got)
    exact = ssd.ssd_chunked(*host, chunk, dtype=torch.float64)[0]
    plain = ssd.ssd_scan_ref(*host, chunk=chunk).double()
    assert _within_ssd_gate(got.double(), exact), (
        f"max |err| / max |y|: kernel vs float64 "
        f"{_ssd_rel_err(got.double(), exact):.3g}, kernel vs float32 plain "
        f"{_ssd_rel_err(got.double(), plain):.3g}, float32 plain vs float64 "
        f"{_ssd_rel_err(plain, exact):.3g} ({torch.get_num_threads()} host "
        f"threads)")


def _poison_allocator(cuda, fill=float("nan")):
    """Fill 384 MB of memory and free it: the caching allocator hands it
    out again, so scratch a kernel reads before it writes holds NaN."""
    junk = torch.full((96 << 20,), fill, device=cuda)
    del junk


@pytest.mark.cuda
def test_kernels_read_no_stale_memory(cuda):
    """B9, B2 and B6 on memory that held NaN: every result as before."""
    for s, h, hd, n, chunk in SSD_CUDA:
        host = _ssd_inputs(2, s, h, hd, n)
        dev = [t.to(cuda) for t in host]
        _poison_allocator(cuda)
        got = ssd.ssd_scan(*dev, chunk=chunk)
        want = ssd.ssd_scan_ref(*host, chunk=chunk)
        assert _within_ssd_gate(got, want), \
            f"{(s, h, hd, n, chunk)}: {_ssd_rel_err(got, want):.3g}"
    x, layouts = _grouped_layouts(3, 16, 1000, 9, 61, cuda)
    wl = grp.grouped_weight_limbs(ring_from_numpy(_words((3, 16, 9, 1), 62)))
    wd = grp.GroupedWeightLimbs(*(a.to(cuda) for a in wl))
    want = grp.grouped_rss_matmul_ref(x, wl)
    for name, xl in layouts.items():
        _poison_allocator(cuda)
        assert torch.equal(grp.grouped_rss_matmul_parts(xl, wd).cpu(),
                           want), name
    for m, k, n in [(32, 3136, 512), (6272, 800, 64), (7, 3, 1)]:
        a = ring_from_numpy(_words((m, k), 51))
        w = _int8_weight((k, n), 52, "int8")
        _poison_allocator(cuda)
        got = ops.binary_weight_matmul_op(a.to(cuda), w.to(cuda))
        assert torch.equal(got.cpu(), binmm.binary_weight_matmul_ref(a, w))


@pytest.mark.cuda
def test_ssd_passes_one_at_a_time_equal_the_launch(cuda):
    """The timing modes: the four passes launched one by one on shared
    buffers give the launch's output bit for bit."""
    bsz, s, h, hd, n, chunk = 2, 512, 2, 64, 128, 256
    dev = [t.to(cuda) for t in _ssd_inputs(bsz, s, h, hd, n)]
    buffers = ssd.scratch(bsz, s, h, hd, n, chunk, cuda)
    for mode in ("gram", "states", "pass"):
        ssd._launch(*dev, chunk, mode, buffers)
    got = ssd._launch(*dev, chunk, "scan", buffers)
    assert torch.equal(got, ssd.ssd_scan(*dev, chunk=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hd,n,chunk", SSD_CUDA[:4])
def test_ssd_serial_kernel_equals_plain(cuda, s, h, hd, n, chunk):
    """The serial kernel (one block per (head, batch)), kept for
    chip_smoke.py's comparison."""
    host = _ssd_inputs(2, s, h, hd, n)
    got = ssd._launch(*[t.to(cuda) for t in host], chunk, "serial")
    assert _within_ssd_gate(got, ssd.ssd_scan_ref(*host, chunk=chunk))


@pytest.mark.cuda
def test_float_kernels_never_take_the_plain_version(cuda, monkeypatch):
    """On a card B8 and B9 launch or raise; the plain versions never run."""
    monkeypatch.setattr(flash, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain version on a card"))
    monkeypatch.setattr(ssd, "ssd_chunked",
                        lambda *a, **k: pytest.fail("plain version on a card"))
    q = torch.zeros((1, 5, 2, 256), device=cuda)
    with pytest.raises(ValueError):     # wider than any instantiation
        ops.flash_attention_op(q, q, q)
    x = torch.zeros((1, 192, 2, 16), device=cuda)
    bm = torch.zeros((1, 192, 8), device=cuda)
    da = torch.zeros((1, 192, 2), device=cuda)
    with pytest.raises(ValueError):     # B and C of different widths
        ssd.ssd_scan(x, bm, bm[..., :4], da, da, chunk=96)
    long = torch.zeros((1, 24000, 1, 4), device=cuda)
    with pytest.raises(ValueError):     # a chunk past the shared memory
        ssd.ssd_scan(long, long[..., 0, :], long[..., 0, :], long[..., 0],
                     long[..., 0], chunk=24000)
    with pytest.raises(AssertionError):  # S % chunk != 0
        ssd.ssd_scan(x, bm, bm, da, da, chunk=128)
    out = ops.flash_attention_op(q[..., :32], q[..., :32], q[..., :32])
    assert out.shape == (1, 5, 2, 32)
    assert ssd.ssd_scan(x, bm, bm, da, da, chunk=32).shape == x.shape
    # any chunk that divides S runs (before the four passes, 96 raised)
    assert ssd.ssd_scan(x, bm, bm, da, da, chunk=96).shape == x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,k,n", [(3, 32, 3136, 512), (3, 2048, 9, 32),
                                     (3, 6272, 800, 64), (3, 130, 784, 70),
                                     (3, 70, 25, 10)])
def test_every_launch_choice_equals_plain(cuda, s, m, k, n):
    """B1 and B3 on every config of the autotuner's full space (both
    routes, every split-K count, B3's three CUDA-core widths): each equals
    the plain version, so tuning changes times, never words."""
    from repro_torch.kernels import autotune
    x = ring_from_numpy(_words((s, m, k), 71))
    w = ring_from_numpy(_words((s, k, n), 72))
    wl = dense.precompute_weight_limbs(w)
    pl = grp.public_weight_limbs(w[0])
    xd, wld, pld = x.to(cuda), _to(wl, cuda), _to(pl, cuda)
    want = dense.rss_matmul_parts_ref(x, wl)
    want_pub = grp.bin_rss_matmul_ref(x, pl)
    for cfg in autotune.candidate_space("rss_matmul", m, k, n, device=cuda):
        assert torch.equal(dense._launch(xd, wld, cfg).cpu(), want), cfg
    for cfg in autotune.candidate_space("bin_rss_matmul", m, k, n,
                                        device=cuda):
        assert torch.equal(grp._launch_bin(xd, pld, cfg).cpu(), want_pub), \
            cfg


@pytest.mark.cuda
def test_plain_config_raises_on_the_card(cuda):
    from repro_torch.kernels.lowering import PLAIN
    x = ring_from_numpy(_words((3, 8, 64), 73)).to(cuda)
    wl = _to(dense.precompute_weight_limbs(
        ring_from_numpy(_words((3, 64, 8), 74))), cuda)
    with pytest.raises(ValueError, match="plain version"):
        dense.rss_matmul_parts(x, wl, KernelConfig(route=PLAIN))


@pytest.mark.cuda
def test_online_spans_carry_device_time(cuda):
    """On a CUDA tracer an online span records a pair of CUDA events,
    read at export as ``device_ms``; other spans take none."""
    from repro_torch.core import telemetry
    t = telemetry.Tracer(device=cuda)
    x = torch.ones(4096, 4096, device=cuda)
    with telemetry.tracing(t):
        with telemetry.span("setup", cat="setup"):
            pass
        with telemetry.span("query[0]", cat="online"):
            for _ in range(10):
                x = x * 1.0001
    trace = t.chrome_trace()
    ev = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    assert "device_ms" not in ev["setup"]["args"]
    assert ev["query[0]"]["args"]["device_ms"] > 0
    telemetry.validate_chrome_trace(trace)


@pytest.mark.cuda
def test_serve_with_telemetry_on_the_card(cuda, tmp_path):
    """serve_secure with --trace and --metrics-json on the card: logits
    equal the run without telemetry, each query span carries device
    time."""
    import json
    from repro_torch.launch import serve_secure
    base = serve_secure.serve("MnistNet1", 4, 2, device="cuda")
    trace = tmp_path / "t.json"
    st = serve_secure.main(["--net", "MnistNet1", "--batch", "4",
                            "--queries", "2", "--deployment", "wan",
                            "--trace", str(trace), "--metrics-json",
                            str(tmp_path / "m.json")])
    assert np.array_equal(st["logits"], base["logits"])
    ev = [e for e in json.loads(trace.read_text())["traceEvents"]
          if e["ph"] == "X" and e["name"].startswith("query[")]
    assert len(ev) == 2 and all(e["args"]["device_ms"] > 0 for e in ev)


def _secure_setup(net, batch, device):
    """A compiled net (seed-0 weights), its input shares and party keys on
    ``device``: the same values on every device."""
    from repro_torch.launch.serve_secure import build
    from repro_torch.nn.bnn import INPUT_SHAPES
    model = build(net, device=device)
    x = (np.random.default_rng(0).integers(0, 2, (batch,)
                                           + INPUT_SHAPES[net])
         .astype(np.float32) - 0.5)
    xs = share(torch.as_tensor(x, device=device), prf.PRNGKey(3), RING32)
    return model, xs, Parties.setup(prf.PRNGKey(7)).keys


@pytest.mark.cuda
def test_tape_on_the_card_equals_cpu_tape(cuda):
    """One query's tape generated on the card == the CPU's, every slab."""
    from repro_torch.core import preprocessing as prep
    model, _, keys = _secure_setup("MnistNet1", 2, "cpu")
    spec = prep.trace_material(model, (2, 28, 28, 1))
    host = prep.generate_tape(spec, [keys], device="cpu")
    card = prep.generate_tape(spec, [keys], device=cuda)
    assert set(card.slabs) == set(host.slabs)
    for k, v in card.slabs.items():
        assert v.device.type == "cuda" and torch.equal(v.cpu(),
                                                       host.slabs[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("op,party", [("reshare", 1), ("open", 1),
                                      ("send", None)])
def test_fault_cell_on_the_card_raises_the_cpu_fields(cuda, op, party):
    """One fault cell per op kind under verify "full": the card raises
    IntegrityError with the CPU run's (op, index, tag, round, party)."""
    from repro_torch.core import integrity, secure_model, transport
    fields = []
    for dev in ("cpu", cuda):
        model, xs, keys = _secure_setup("MnistNet1", 1, dev)
        ft = integrity.FaultInjectingTransport(
            transport.LocalTransport(),
            [integrity.Fault(op, 0, "corrupt", party)])
        v = integrity.Verifier("full")
        with transport.use_transport(ft), integrity.verify_scope(v):
            secure_model.secure_infer(model, xs, Parties(keys, device=dev))
            rep = v.traced_report()
        assert ft.fired
        with pytest.raises(integrity.IntegrityError) as ei:
            v.check(rep)
        e = ei.value
        fields.append((e.op, e.index, e.tag, e.round, e.party))
    assert fields[0] == fields[1] and fields[0][0] == op


@pytest.mark.cuda
def test_tape_backed_cifarnet2_equals_inline_on_the_card(cuda):
    """A tape-backed CifarNet2 query at batch 2 on the card == the inline
    query, through the kernels."""
    from repro_torch.core import preprocessing as prep, secure_model
    model, xs, keys = _secure_setup("CifarNet2", 2, cuda)
    spec = prep.trace_material(model, (2, 32, 32, 3))
    tape = prep.generate_tape(spec, [keys], device=cuda)
    launches = kbuild.LAUNCHES["rss_matmul"]
    out = prep.make_tape_infer(model, spec)(keys, xs.shares,
                                            tape.query_slice(0))
    assert kbuild.LAUNCHES["rss_matmul"] > launches
    inline = secure_model.secure_infer(model, xs, Parties(keys, device=cuda))
    assert torch.equal(out, inline)


# ---------------------------------------------------------------------------
# B5's batched entry and the secure LM decode step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bt,m,k,n", [(96, 1, 128, 16), (96, 1, 32, 64),
                                      (96, 1, 128, 64), (6, 3, 16, 5),
                                      (4, 70, 200, 130), (1, 1, 1, 1)])
def test_ring_matmul_batched_cuda_equals_plain(cuda, bt, m, k, n):
    a = ring_from_numpy(_words((bt, m, k), 60))
    b = ring_from_numpy(_words((bt, k, n), 61))
    ad, bd = a.to(cuda), b.to(cuda)
    launches = kbuild.LAUNCHES["ring_matmul_batched"]
    got = ops.ring_matmul_batched_op(ad, bd)
    assert kbuild.LAUNCHES["ring_matmul_batched"] == launches + 1
    assert torch.equal(got.cpu(), ringmm.ring_matmul_batched_ref(a, b))
    for _ in range(3):     # split-K blocks add with atomics: bit-identical
        assert torch.equal(ops.ring_matmul_batched_op(ad, bd), got)
    for route in (limbs.TENSOR_CORE, limbs.CUDA_CORE):
        assert torch.equal(ringmm._launch_batched(ad, bd, route).cpu(),
                           ringmm.ring_matmul_batched_ref(a, b)), route
    assert torch.equal(ringmm.split_weight_limbs_batched(bd).cpu(),
                       ringmm.ring_weight_limbs_batched_ref(b))


@pytest.mark.cuda
def test_ring_matmul_batched_never_takes_the_plain_version(cuda,
                                                           monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version on a CUDA tensor")
    monkeypatch.setattr(ringmm, "ring_matmul_batched_ref", boom)
    a = torch.ones((2, 1, 4), dtype=torch.int32, device=cuda)
    assert int(ops.ring_matmul_batched_op(a, a.transpose(1, 2)
                                          .contiguous())[1, 0, 0]) == 4
    with pytest.raises(ValueError):
        ops.ring_matmul_batched_op(a.long(), a.long().transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("customized,static_norm", [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_secure_decode_step_on_the_card_equals_cpu(cuda, customized,
                                                   static_norm):
    """Logits and KV cache of the card's decode steps (B1 on cached limbs,
    batched B5) == the CPU's plain products, bit for bit; the step
    launches B1 and the batched B5 only."""
    from repro_torch.core import secure_transformer as st
    keys = prf.split(prf.PRNGKey(7), 3)
    runs = {}
    for dev in ("cpu", "cuda"):
        lm, _ = st.share_lm_params(prf.PRNGKey(1), 40, 64, 4, 96, 2, RING32,
                                   device=dev)
        cache = st.init_kv_cache(2, 4, 16, 16, RING32, device=dev)
        before = dict(kbuild.LAUNCHES)
        lgs = []
        for p, t in enumerate((3, 17, 5)):
            lg, cache = st.secure_decode_step(lm, cache, t, p, keys,
                                              customized, static_norm)
            lgs.append(lg.cpu())
        diff = {k: v - before[k] for k, v in kbuild.LAUNCHES.items()
                if v != before[k]}
        runs[dev] = (torch.stack(lgs), cache.k.cpu(), cache.v.cpu(), diff)
    assert runs["cpu"][3] == {}
    assert runs["cuda"][3] == {"rss_matmul": 3 * (6 * 2 + 1),
                               "ring_matmul_batched": 3 * 2 * 2}
    for a, b in zip(runs["cpu"][:3], runs["cuda"][:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_secure_lm_limb_caches_on_the_card(cuda):
    """On the card every weight linear carries its limb cache; a linear
    without one raises there (no plain product on a CUDA tensor)."""
    import dataclasses
    from repro_torch.core import secure_transformer as st
    lm, _ = st.share_lm_params(prf.PRNGKey(1), 16, 16, 2, 32, 1, RING32,
                               device=cuda)
    assert sorted(lm.blocks[0].limbs) == sorted(st.WEIGHT_LINEARS)
    assert lm.w_out_limbs.n == 16
    bare = dataclasses.replace(
        lm, w_out_limbs=None,
        blocks=tuple(dataclasses.replace(b, limbs=None) for b in lm.blocks))
    cache = st.init_kv_cache(1, 2, 8, 8, RING32, device=cuda)
    with pytest.raises(RuntimeError, match="cached weight limbs"):
        st.secure_decode_step(bare, cache, 0, 0,
                              prf.split(prf.PRNGKey(7), 3))
