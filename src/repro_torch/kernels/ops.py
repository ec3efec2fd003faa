"""Shape handling around the kernels.

Port of ``repro/kernels/ops.py`` (``ring_matmul_op``,
``ring_matmul_batched_op`` (the reference's batched attention products are
``jnp.einsum``; the port's run on B5's batched entry),
``binary_weight_matmul_op``, ``binary_binary_matmul_op``,
``rss_matmul_dot``, ``_fold_grouped``, ``_unfold_grouped``,
``grouped_rss_matmul_op``, ``rss_matmul_parts_op``, ``bin_rss_matmul_op``,
``bin_grouped_matmul_op``, ``flash_attention_op``).  The leading dims of
a share stack fold into M.  ``rss_matmul_parts_op`` and
``grouped_rss_matmul_op`` take the neighbour stack explicitly, as the
reference's do: under a pair-carrying transport (``MeshTransport``) a
party passes its own share and its neighbour's with S = 1 and the
weights' own slot, and the kernels' pair entries read the neighbour from
that operand; on the stacked layout the neighbour is found by index inside
the kernel and ``x_next_stack`` is unused (callers pass ``None``).  Unlike the
reference there is no 128-padding and no small-shape fallback: the CUDA
kernels mask ragged edges and take every shape.  The grouped fold/unfold
are views here (no copies): the grouped kernel reads and writes through
strides.  ``flash_attention_op`` launches at every sequence length: the
reference's fallback to its oracle for lengths that are not a multiple of
its tile (``ops.py:76-77``) has no counterpart, the kernel masks the
ragged tile.  The SSD scan's op is ``kernels.ssd.ssd_scan`` itself.
"""
from __future__ import annotations

import torch

from .bin_rss_matmul import (GroupedWeightLimbs, PublicGroupedLimbs,
                             PublicWeightLimbs, bin_grouped_matmul_parts,
                             bin_rss_matmul_parts, grouped_rss_matmul_parts)
from .binary_matmul import binary_binary_matmul, binary_weight_matmul
from .flash_attention import flash_attention
from .ring_matmul import ring_matmul, ring_matmul_batched
from .lowering import KernelConfig
from .rss_matmul import WeightLimbs, rss_matmul_parts

__all__ = ["ring_matmul_op", "ring_matmul_batched_op",
           "binary_weight_matmul_op",
           "binary_binary_matmul_op", "rss_matmul_dot",
           "rss_matmul_parts_op", "grouped_rss_matmul_op",
           "bin_rss_matmul_op", "bin_grouped_matmul_op",
           "flash_attention_op"]


def ring_matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B mod 2^32 for any (M, K) x (K, N) int32 ring words."""
    return ring_matmul(a.contiguous(), b.contiguous())


def ring_matmul_batched_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B mod 2^32 over shared leading dims: (..., M, K) x (..., K, N)
    -> (..., M, N), the leading dims folded into one batch of products."""
    lead = a.shape[:-2]
    if b.shape[:-2] != lead:
        raise ValueError(f"ring_matmul_batched: leading dims {tuple(lead)} "
                         f"and {tuple(b.shape[:-2])} differ")
    out = ring_matmul_batched(a.reshape((-1,) + tuple(a.shape[-2:]))
                              .contiguous(),
                              b.reshape((-1,) + tuple(b.shape[-2:]))
                              .contiguous())
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def binary_weight_matmul_op(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A (int32 ring words) @ W (int8 ±1 / {0, 1}) mod 2^32."""
    return binary_weight_matmul(a.contiguous(), w.contiguous())


def binary_binary_matmul_op(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plaintext BNN layer: int8 @ int8 -> int32."""
    return binary_binary_matmul(a.contiguous(), w.contiguous())


def rss_matmul_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``dot`` of the linear protocols on the ring-matmul kernel: one
    launch per per-party product (6 per secure matmul under "opt2", 9
    under "paper3"); leading dims of ``a`` fold into M."""
    lead = a.shape[:-1]
    out = ring_matmul_op(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(tuple(lead) + (b.shape[-1],))


def _fold_grouped(x: torch.Tensor) -> torch.Tensor:
    """(S, ..., K, C) patch stack -> (S, C, M, K) view."""
    s, k, c = x.shape[0], x.shape[-2], x.shape[-1]
    return x.reshape(s, -1, k, c).permute(0, 3, 1, 2)


def _unfold_grouped(out: torch.Tensor, lead, n: int) -> torch.Tensor:
    """(S, C, M, N) -> (S, ..., C, N) channel-major layout."""
    s, c = out.shape[0], out.shape[1]
    return out.transpose(1, 2).reshape((s,) + tuple(lead) + (c, n))


def grouped_rss_matmul_op(x_stack: torch.Tensor,
                          x_next_stack: torch.Tensor | None,
                          weights: GroupedWeightLimbs) -> torch.Tensor:
    """Depthwise additive-product stack from one kernel launch.
    x_stack / x_next_stack: (S, ..., K, C) patches of the own and the
    neighbour share (the neighbour read only under a pair-carrying
    transport, with the weights' own slot); returns (S, ..., C, N)."""
    from ..core import transport
    t = transport.current()
    lead = x_stack.shape[1:-2]
    if not t.carries_pair:
        w_own, xn = weights, None
    else:
        w_own = GroupedWeightLimbs(*(t.own_view(a) for a in weights))
        xn = _fold_grouped(x_next_stack)
    out = grouped_rss_matmul_parts(_fold_grouped(x_stack), w_own,
                                   x_next_stack=xn)
    return _unfold_grouped(out, lead, weights.n)


def rss_matmul_parts_op(x_stack: torch.Tensor,
                        x_next_stack: torch.Tensor | None,
                        weights: WeightLimbs,
                        cfg: KernelConfig | None = None) -> torch.Tensor:
    """Additive-product stack from one kernel launch (on ``cfg``'s launch
    choice if given).  x_stack / x_next_stack: (S, ..., K) own and
    neighbour shares; returns (S, ..., N).  Stacked (S = 3): the
    neighbour is found by index inside the kernel.  Under a pair-carrying
    transport (S = 1) the weights' own slot and ``x_next_stack`` feed the
    kernel's pair entry."""
    from ..core import transport
    t = transport.current()
    s = x_stack.shape[0]
    lead = x_stack.shape[1:-1]
    x2 = x_stack.reshape(s, -1, x_stack.shape[-1]).contiguous()
    if not t.carries_pair:
        w_own, xn2 = weights, None
    else:
        w_own = WeightLimbs(*(t.own_view(a) for a in weights))
        xn2 = x_next_stack.reshape(s, -1, x_next_stack.shape[-1]) \
            .contiguous()
    out = rss_matmul_parts(x2, w_own, cfg, x_next_stack=xn2)
    return out.reshape((s,) + tuple(lead) + (weights.n,))


def bin_rss_matmul_op(x_stack: torch.Tensor, weights: PublicWeightLimbs,
                      cfg: KernelConfig | None = None) -> torch.Tensor:
    """Local share-stack product with a PUBLIC weight matrix: z_s = x_s @ W
    for every held slot, no communication (on ``cfg``'s launch choice if
    given).  x_stack: (S, ..., K); returns (S, ..., N)."""
    s = x_stack.shape[0]
    lead = x_stack.shape[1:-1]
    x2 = x_stack.reshape(s, -1, x_stack.shape[-1]).contiguous()
    out = bin_rss_matmul_parts(x2, weights, cfg)
    return out.reshape((s,) + tuple(lead) + (weights.n,))


def bin_grouped_matmul_op(x_stack: torch.Tensor,
                          weights: PublicGroupedLimbs) -> torch.Tensor:
    """Local per-channel product with a PUBLIC depthwise kernel:
    z_s[c] = x_s[c] @ W[c] for every held slot.  x_stack: (S, ..., K, C)
    patches; returns (S, ..., C, N)."""
    lead = x_stack.shape[1:-2]
    out = bin_grouped_matmul_parts(_fold_grouped(x_stack), weights)
    return _unfold_grouped(out, lead, weights.n)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Causal GQA flash attention, the ``flash_impl`` of the prefill step:
    q (B,S,H,hd), k/v (B,S,Hkv,hd) -> (B,S,H,hd) in q's dtype."""
    return flash_attention(q, k, v)
