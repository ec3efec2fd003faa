"""The grouped (depthwise) 3-party RSS product: wrapper, plain version and
weight cache.

Port of the grouped shared-weight family of
``repro/kernels/bin_rss_matmul.py`` (``GroupedWeightLimbs``,
``grouped_weight_limbs``, ``grouped_rss_matmul_ref``,
``grouped_rss_matmul_parts``).  Per party i and channel c:

    z_i[c] = x_i[c]·(w_i[c] + w_{i+1}[c]) + x_{i+1}[c]·w_i[c]   (mod 2^32)

On a CUDA tensor :func:`grouped_rss_matmul_parts` launches the
hand-written kernel ``csrc/grouped_rss_matmul.cu`` (it replaces the TPU
kernel ``repro/kernels/bin_rss_matmul.py::_make_grouped_shared_kernel``)
or raises; on a CPU or meta tensor it runs the plain version.  The kernel
reads x through its strides, so callers may pass a permuted view (the
secure path hands it the im2col (S, M, K, C) buffer viewed as
(S, C, M, K)) and get back an (S, C, M, N) view of an (S, M, C, N) buffer.
The public-weight kernels of that module belong to a later slice.
"""
from __future__ import annotations

import typing

import torch

from . import build
from .limbs import balanced_limbs

__all__ = ["GroupedWeightLimbs", "grouped_weight_limbs",
           "grouped_rss_matmul_ref", "grouped_rss_matmul_parts"]

_SMEM_LIMIT = 48 * 1024


class GroupedWeightLimbs(typing.NamedTuple):
    """Cached per-channel weight-share operands of a depthwise layer."""

    ws: torch.Tensor   # (3, C, K, N) int32 — w_i per channel
    wf: torch.Tensor   # (3, C, K, N) int32 — fused operand w_i + w_{i+1}
    wl: torch.Tensor   # (3, 4, C, K, N) int8 — limbs of ws
    wfl: torch.Tensor  # (3, 4, C, K, N) int8 — limbs of wf

    @property
    def channels(self) -> int:
        return self.ws.shape[1]

    @property
    def k(self) -> int:
        return self.ws.shape[2]

    @property
    def n(self) -> int:
        return self.ws.shape[3]


def grouped_weight_limbs(w_shares: torch.Tensor) -> GroupedWeightLimbs:
    """Cache a (3, C, K, N) grouped weight-share stack, once at setup."""
    ws = w_shares.contiguous()
    wf = ws + torch.roll(ws, -1, dims=0)
    lim = lambda a: balanced_limbs(a).transpose(0, 1).contiguous()
    return GroupedWeightLimbs(ws=ws, wf=wf, wl=lim(ws), wfl=lim(wf))


def grouped_rss_matmul_ref(x_stack: torch.Tensor,
                           weights: GroupedWeightLimbs) -> torch.Tensor:
    """Plain version: per-channel batched int32 matmuls on the cached
    fused operand, (S, C, M, K) -> (S, C, M, N) (CPU / meta only)."""
    xn = torch.roll(x_stack, -1, dims=0)
    return torch.matmul(x_stack, weights.wf) + torch.matmul(xn, weights.ws)


def _launch(x_stack: torch.Tensor,
            weights: GroupedWeightLimbs) -> torch.Tensor:
    s, c, m, k = x_stack.shape
    n = weights.n
    if x_stack.dtype != torch.int32:
        raise ValueError("grouped_rss_matmul: x must be int32")
    for name, t in (("ws", weights.ws), ("wf", weights.wf)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != x_stack.device:
            raise ValueError(f"grouped_rss_matmul: {name} must be a "
                             f"contiguous int32 tensor on {x_stack.device}")
    if tuple(weights.ws.shape) != (s, c, k, n):
        raise ValueError(f"grouped_rss_matmul: weights "
                         f"{tuple(weights.ws.shape)} do not match x "
                         f"{tuple(x_stack.shape)}")
    if 8 * c * k * n > _SMEM_LIMIT:
        raise ValueError(f"grouped_rss_matmul: weight slab of {c}x{k}x{n} "
                         f"exceeds the kernel's shared-memory stage")
    # (S, M, C, N) buffer, returned as its (S, C, M, N) view
    buf = torch.empty((s, m, c, n), dtype=torch.int32, device=x_stack.device)
    out = buf.permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    fn = build.library("grouped_rss_matmul")
    err = fn(x_stack.data_ptr(), weights.wf.data_ptr(), weights.ws.data_ptr(),
             out.data_ptr(), s, c, m, k, n, *x_stack.stride(), *out.stride(),
             build.stream_ptr(x_stack.device))
    build.check("grouped_rss_matmul", err)
    build.LAUNCHES["grouped_rss_matmul"] += 1
    return out


def grouped_rss_matmul_parts(x_stack: torch.Tensor,
                             weights: GroupedWeightLimbs) -> torch.Tensor:
    """All parties' additive grouped products, (S, C, M, K) ->
    (S, C, M, N) int32.  CUDA tensors launch the kernel (or raise); CPU
    and meta tensors run the plain version."""
    s, c, m, k = x_stack.shape
    assert (c, k) == (weights.channels, weights.k), \
        (x_stack.shape, weights.ws.shape)
    if x_stack.device.type == "cuda":
        return _launch(x_stack, weights)
    if x_stack.device.type in ("cpu", "meta"):
        return grouped_rss_matmul_ref(x_stack, weights)
    raise ValueError(f"grouped_rss_matmul: unsupported device "
                     f"{x_stack.device}")
