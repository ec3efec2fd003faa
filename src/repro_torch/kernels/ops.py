"""Shape handling around the four linear-layer kernels.

Port of ``repro/kernels/ops.py`` (``_fold_grouped``, ``_unfold_grouped``,
``grouped_rss_matmul_op``, ``rss_matmul_parts_op``, ``bin_rss_matmul_op``,
``bin_grouped_matmul_op``).  The leading dims of a share stack fold into M.  Unlike the reference there is no 128-padding
and no small-shape fallback: the CUDA kernels mask ragged edges and take
every shape.  The grouped fold/unfold are views here (no copies): the
grouped kernel reads and writes through strides.
"""
from __future__ import annotations

import torch

from .bin_rss_matmul import (GroupedWeightLimbs, PublicGroupedLimbs,
                             PublicWeightLimbs, bin_grouped_matmul_parts,
                             bin_rss_matmul_parts, grouped_rss_matmul_parts)
from .rss_matmul import WeightLimbs, rss_matmul_parts

__all__ = ["rss_matmul_parts_op", "grouped_rss_matmul_op",
           "bin_rss_matmul_op", "bin_grouped_matmul_op"]


def _fold_grouped(x: torch.Tensor) -> torch.Tensor:
    """(S, ..., K, C) patch stack -> (S, C, M, K) view."""
    s, k, c = x.shape[0], x.shape[-2], x.shape[-1]
    return x.reshape(s, -1, k, c).permute(0, 3, 1, 2)


def _unfold_grouped(out: torch.Tensor, lead, n: int) -> torch.Tensor:
    """(S, C, M, N) -> (S, ..., C, N) channel-major layout."""
    s, c = out.shape[0], out.shape[1]
    return out.transpose(1, 2).reshape((s,) + tuple(lead) + (c, n))


def grouped_rss_matmul_op(x_stack: torch.Tensor,
                          weights: GroupedWeightLimbs) -> torch.Tensor:
    """Depthwise additive-product stack from one kernel launch.
    x_stack: (S, ..., K, C) patches; returns (S, ..., C, N)."""
    lead = x_stack.shape[1:-2]
    out = grouped_rss_matmul_parts(_fold_grouped(x_stack), weights)
    return _unfold_grouped(out, lead, weights.n)


def rss_matmul_parts_op(x_stack: torch.Tensor,
                        weights: WeightLimbs) -> torch.Tensor:
    """Full 3-party additive-product stack from one kernel launch.
    x_stack: (S, ..., K); returns (S, ..., N).  The neighbour share is
    found by index inside the kernel."""
    s = x_stack.shape[0]
    lead = x_stack.shape[1:-1]
    x2 = x_stack.reshape(s, -1, x_stack.shape[-1]).contiguous()
    out = rss_matmul_parts(x2, weights)
    return out.reshape((s,) + tuple(lead) + (weights.n,))


def bin_rss_matmul_op(x_stack: torch.Tensor,
                      weights: PublicWeightLimbs) -> torch.Tensor:
    """Local share-stack product with a PUBLIC weight matrix: z_s = x_s @ W
    for every held slot, no communication.  x_stack: (S, ..., K);
    returns (S, ..., N)."""
    s = x_stack.shape[0]
    lead = x_stack.shape[1:-1]
    x2 = x_stack.reshape(s, -1, x_stack.shape[-1]).contiguous()
    out = bin_rss_matmul_parts(x2, weights)
    return out.reshape((s,) + tuple(lead) + (weights.n,))


def bin_grouped_matmul_op(x_stack: torch.Tensor,
                          weights: PublicGroupedLimbs) -> torch.Tensor:
    """Local per-channel product with a PUBLIC depthwise kernel:
    z_s[c] = x_s[c] @ W[c] for every held slot.  x_stack: (S, ..., K, C)
    patches; returns (S, ..., C, N)."""
    lead = x_stack.shape[1:-2]
    out = bin_grouped_matmul_parts(_fold_grouped(x_stack), weights)
    return _unfold_grouped(out, lead, weights.n)
