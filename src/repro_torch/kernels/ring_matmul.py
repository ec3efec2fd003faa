"""One ring product C = A·B mod 2^32: wrapper and plain version.

Port of ``repro/kernels/ring_matmul.py`` (``ring_matmul``) and of its
oracle ``repro/kernels/ref.py::ring_matmul_ref``.  It is the per-dot
route of the linear protocols (``dot=kernels.ops.rss_matmul_dot``): each
per-party product of a secure layer is one call.

On a CUDA tensor :func:`ring_matmul` launches the hand-written kernels
of ``csrc/ring_matmul.cu`` (they replace the TPU kernel
``repro/kernels/ring_matmul.py::_ring_matmul_kernel``) or raises; on a
CPU (or ``meta``) tensor it runs the plain version, an int32 matmul that
wraps mod 2^32.  torch has no integer matmul on CUDA, so the plain version
is CPU-only.

The route comes from :func:`~.limbs.limb_mma_plan` at one slot: at K > 16
the int8 tensor cores (B3's ``limb_mma.cuh`` kernel with L = 4 limbs), after
a pass that splits b into its balanced limbs, K-major and 128-padded
(:func:`ring_weight_limbs_ref` is that pass's plain version); at K <= 16
the CUDA cores multiply the words.

:func:`ring_matmul_batched` is the batched entry, (Bt, M, K) x (Bt, K, N)
-> (Bt, M, N): the share x share products of the secure attention
(``core/secure_transformer.py::_bmm``), one product per (party, head), in
one split pass and one product launch for the whole batch (the plan at Bt
slots).  Its plain version is a batched int32 matmul on the CPU.
"""
from __future__ import annotations

import torch

from . import build
from .limbs import K_STAGE, TENSOR_CORE, limb_mma_plan, sm_count

__all__ = ["ring_matmul", "ring_matmul_ref", "ring_weight_limbs_ref",
           "split_weight_limbs", "ring_matmul_batched",
           "split_weight_limbs_batched",
           "ring_matmul_batched_ref", "ring_weight_limbs_batched_ref"]

_TILE = 128
# 0x80808080 as an int32: adding it turns balanced digits into bytes
_BIAS = 0x80808080 - 2**32
# the C entry point's routes
_ROUTE_TC, _ROUTE_CC, _ROUTE_SPLIT = 0, 1, 2


def ring_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) x (K, N) int32 -> (M, N) int32, mod 2^32."""
    return torch.matmul(a, b)


def ring_weight_limbs_ref(b: torch.Tensor) -> torch.Tensor:
    """Plain version of the split pass: (K, N) int32 words -> (4, Np, Kp)
    int8, limb p of b[k, n] at [p, n, k], zero-padded to multiples of 128.
    The balanced limbs are the bytes of (b + 0x80808080) ^ 0x80808080."""
    k, n = b.shape
    v = (b.to(torch.int32) + _BIAS) ^ _BIAS
    limbs = v.contiguous().view(torch.int8).reshape(k, n, 4).permute(2, 1, 0)
    return torch.nn.functional.pad(
        limbs, (0, (-k) % _TILE, 0, (-n) % _TILE)).contiguous()


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                    a_dtype: torch.dtype, b_dtype: torch.dtype) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not multiply")
    for what, t, dt in (("a", a, a_dtype), ("b", b, b_dtype)):
        if t.dtype != dt or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name}: {what} must be a contiguous {dt} "
                             f"tensor on {a.device}")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.Tensor:
    """Launch a 2-D product kernel whose C entry point takes (a, b, c, M,
    K, N, stream) (B7's): (M, K) x (K, N) -> (M, N) int32 words."""
    _check_operands(name, a, b, a_dtype, b_dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.library(name)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
             build.stream_ptr(a.device))
    build.check(name, err)
    build.LAUNCHES[name] += 1
    return out


def _route(name: str, a: torch.Tensor, b: torch.Tensor, a_dtype: torch.dtype,
           b_dtype: torch.dtype, plain) -> torch.Tensor:
    """CUDA tensors launch the kernel at every shape (or raise); CPU and
    meta tensors run the plain version."""
    if a.device.type == "cuda":
        return _launch(name, a, b, a_dtype, b_dtype)
    if a.device.type in ("cpu", "meta"):
        return plain(a, b)
    raise ValueError(f"{name}: unsupported device {a.device}")


def _padded(d: int) -> int:
    return max(1, -(-d // _TILE)) * _TILE


def _launch_limbs(name: str, a: torch.Tensor, b: torch.Tensor,
                  b_dtype: torch.dtype, planes: int,
                  route: str | None = None) -> torch.Tensor:
    """Launch B5 or B6 (``name``) on the route of the plan: at K > 16 a pass
    writes b's ``planes`` K-major 128-padded int8 limb planes into scratch
    and ``limb_mma.cuh`` multiplies; at K <= 16 the IMAD kernel.  ``route``
    forces one, unsplit (``chip_smoke.py`` also times the route not
    taken)."""
    _check_operands(name, a, b, torch.int32, b_dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    chosen, per, _ = limb_mma_plan(1, m, k, n, sm_count(a.device))
    if route is not None and route != chosen:
        chosen, per = route, -(-k // K_STAGE)
    tc = chosen == TENSOR_CORE
    wt = torch.empty((planes, _padded(n), _padded(k)) if tc else (0,),
                     dtype=torch.int8, device=a.device)
    fn = build.library(name)
    err = fn(a.data_ptr(), b.data_ptr(), wt.data_ptr(), out.data_ptr(), m, k,
             n, _padded(k), _padded(n), _ROUTE_TC if tc else _ROUTE_CC, per,
             build.stream_ptr(a.device))
    build.check(name, err)
    build.LAUNCHES[name] += 1
    return out


def _launch_ring(a: torch.Tensor, b: torch.Tensor,
                 route: str | None = None) -> torch.Tensor:
    """Launch B5 on the route of the plan (``route`` forces one)."""
    return _launch_limbs("ring_matmul", a, b, torch.int32, 4, route)


def _weight_pass(name: str, b: torch.Tensor, b_dtype: torch.dtype,
                 planes: int) -> torch.Tensor:
    """B5's or B6's weight pass alone on the card: (K, N) -> (planes, Np,
    Kp) int8."""
    if b.device.type != "cuda" or b.ndim != 2 or b.dtype != b_dtype \
            or not b.is_contiguous():
        raise ValueError(f"{name}: b must be a contiguous (K, N) {b_dtype} "
                         f"tensor on the card")
    k, n = b.shape
    wt = torch.empty((planes, _padded(n), _padded(k)), dtype=torch.int8,
                     device=b.device)
    fn = build.library(name)
    err = fn(None, b.data_ptr(), wt.data_ptr(), None, 0, k, n, _padded(k),
             _padded(n), _ROUTE_SPLIT, 1, build.stream_ptr(b.device))
    build.check(name, err)
    build.LAUNCHES[name] += 1
    return wt


def split_weight_limbs(b: torch.Tensor) -> torch.Tensor:
    """The split pass alone on the card: (K, N) int32 -> (4, Np, Kp) int8
    (tests and ``chip_smoke.py`` hold it to :func:`ring_weight_limbs_ref`)."""
    return _weight_pass("ring_matmul", b, torch.int32, 4)


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B mod 2^32, (M, K) x (K, N) int32 ring words."""
    if a.device.type == "cuda":
        return _launch_ring(a, b)
    return _route("ring_matmul", a, b, torch.int32, torch.int32,
                  ring_matmul_ref)


# ---------------------------------------------------------------------------
# The batched entry
# ---------------------------------------------------------------------------

def ring_matmul_batched_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (Bt, M, K) x (Bt, K, N) int32 -> (Bt, M, N), mod 2^32
    (int64 words wrap mod 2^64 the same way)."""
    return torch.matmul(a, b)


def ring_weight_limbs_batched_ref(b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched split pass: (Bt, K, N) int32 words ->
    (Bt, 4, Np, Kp) int8, each product's limbs as
    :func:`ring_weight_limbs_ref` writes them."""
    bt, k, n = b.shape
    v = (b.to(torch.int32) + _BIAS) ^ _BIAS
    limbs = v.contiguous().view(torch.int8).reshape(bt, k, n, 4) \
        .permute(0, 3, 2, 1)
    return torch.nn.functional.pad(
        limbs, (0, (-k) % _TILE, 0, (-n) % _TILE)).contiguous()


def _check_batched(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"ring_matmul_batched: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not multiply")


def _check_words(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != ts[0].device:
            raise ValueError(f"ring_matmul_batched: operands must be "
                             f"contiguous int32 tensors on {ts[0].device}")


def _launch_batched(a: torch.Tensor, b: torch.Tensor,
                    route: str | None = None) -> torch.Tensor:
    """Launch the batched B5 on the route of the plan at Bt slots
    (``route`` forces one, unsplit)."""
    _check_batched(a, b)
    _check_words(a, b)
    bt, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((bt, m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    chosen, per, _ = limb_mma_plan(bt, m, k, n, sm_count(a.device))
    if route is not None and route != chosen:
        chosen, per = route, -(-k // K_STAGE)
    tc = chosen == TENSOR_CORE
    wt = torch.empty((bt, 4, _padded(n), _padded(k)) if tc else (0,),
                     dtype=torch.int8, device=a.device)
    fn = build.library("ring_matmul_batched")
    err = fn(a.data_ptr(), b.data_ptr(), wt.data_ptr(), out.data_ptr(), bt,
             m, k, n, _padded(k), _padded(n), _ROUTE_TC if tc else _ROUTE_CC,
             per, build.stream_ptr(a.device))
    build.check("ring_matmul_batched", err)
    build.LAUNCHES["ring_matmul_batched"] += 1
    return out


def split_weight_limbs_batched(b: torch.Tensor) -> torch.Tensor:
    """The batched split pass alone on the card: (Bt, K, N) int32 ->
    (Bt, 4, Np, Kp) int8 (``chip_smoke.py`` and the CUDA tests hold it to
    :func:`ring_weight_limbs_batched_ref`)."""
    if b.device.type != "cuda" or b.ndim != 3 or not 1 <= b.shape[0] <= 65535:
        raise ValueError("ring_matmul_batched: b must be a (Bt, K, N) "
                         "tensor on the card, 1 <= Bt <= 65535")
    _check_words(b)
    bt, k, n = b.shape
    wt = torch.empty((bt, 4, _padded(n), _padded(k)), dtype=torch.int8,
                     device=b.device)
    fn = build.library("ring_matmul_batched")
    err = fn(None, b.data_ptr(), wt.data_ptr(), None, bt, 0, k, n,
             _padded(k), _padded(n), _ROUTE_SPLIT, 1,
             build.stream_ptr(b.device))
    build.check("ring_matmul_batched", err)
    build.LAUNCHES["ring_matmul_batched"] += 1
    return wt


def ring_matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[z] = A[z] @ B[z] mod 2^32 for every z of a batch, (Bt, M, K) x
    (Bt, K, N) int32 ring words.  CUDA tensors launch the kernel (one split
    pass and one product for the whole batch) or raise; CPU and meta
    tensors run the plain version."""
    if a.device.type == "cuda":
        return _launch_batched(a, b)
    if a.device.type in ("cpu", "meta"):
        _check_batched(a, b)
        return ring_matmul_batched_ref(a, b)
    raise ValueError(f"ring_matmul_batched: unsupported device {a.device}")
