"""The public-weight products and the grouped (depthwise) 3-party RSS
product: wrappers, plain versions and weight caches.

Port of ``repro/kernels/bin_rss_matmul.py``:

* the public family (``PublicWeightLimbs``, ``min_public_limbs``,
  ``public_weight_limbs``, ``bin_rss_matmul_ref``,
  ``bin_rss_matmul_parts``; ``PublicGroupedLimbs``,
  ``public_grouped_limbs``, ``bin_grouped_matmul_ref``,
  ``bin_grouped_matmul_parts``).  A public weight W is held by every
  party, so every share slot's product is local:

      z_s = x_s @ W            z_s[c] = x_s[c] @ W[c]      (mod 2^32)

  On a CUDA tensor the wrappers launch the hand-written kernels
  ``csrc/bin_rss_matmul.cu`` (replaces the TPU kernel
  ``_make_bin_kernel``) and ``csrc/bin_grouped_matmul.cu`` (replaces
  ``_make_grouped_public_kernel``), or raise.
* the grouped shared-weight family (``GroupedWeightLimbs``,
  ``grouped_weight_limbs``, ``grouped_rss_matmul_ref``,
  ``grouped_rss_matmul_parts``).  Per party i and channel c:

      z_i[c] = x_i[c]·(w_i[c] + w_{i+1}[c]) + x_{i+1}[c]·w_i[c]  (mod 2^32)

  On a CUDA tensor :func:`grouped_rss_matmul_parts` launches
  ``csrc/grouped_rss_matmul.cu`` (replaces ``_make_grouped_shared_kernel``)
  or raises: one thread reads each share slot's row once and writes every
  party's output, with all S parties' weight slabs in shared memory (up to
  the card's opt-in limit).  The pair entry (``x_next_stack`` given: a
  party under ``MeshTransport``, S = 1) reads x_{i+1}[c] from that operand
  (``grouped_rss_matmul_pair``).

On a CPU or meta tensor every wrapper runs its plain version.  The grouped
kernels read x through its strides, so callers may pass a permuted view
(the secure path hands them the im2col (S, M, K, C) buffer viewed as
(S, C, M, K)) and get back an (S, C, M, N) view of an (S, M, C, N) buffer.

The public caches keep the reference's ``n_limbs`` (the adaptive limb
count, 1–4) and the minimal limbs ``wl`` unpadded.  ``PublicWeightLimbs``
adds ``wt``, the same limbs 128-padded and K-major: the operand of B3's
tensor-core route (``csrc/limb_mma.cuh``, Σ_{q<L}(4 − q) int8 products a
cell), which :func:`~.limbs.limb_mma_plan` takes at K > 16; at K <= 16 B3
multiplies the 32-bit encoding ``w`` on the CUDA cores, in tiles 16, 32
or 64 wide (by N).  A ``cfg`` (``lowering.KernelConfig``) replaces the
plan's route, split count and width.  The grouped
kernels multiply 32-bit words on the CUDA cores.
"""
from __future__ import annotations

import typing

import torch

from . import build
from .limbs import N_LIMBS, TENSOR_CORE, balanced_limbs, sm_count
from .lowering import KernelConfig, resolve

__all__ = ["PublicWeightLimbs", "min_public_limbs", "public_weight_limbs",
           "bin_rss_matmul_ref", "bin_rss_matmul_parts",
           "PublicGroupedLimbs", "public_grouped_limbs",
           "bin_grouped_matmul_ref", "bin_grouped_matmul_parts",
           "GroupedWeightLimbs", "grouped_weight_limbs", "pair_grouped_limbs",
           "grouped_rss_matmul_ref", "grouped_rss_matmul_parts"]

_SMEM_LIMIT = 48 * 1024
# the shared memory a block may opt in to on the H100 (B2's weight slabs)
_SMEM_OPTIN = 227 * 1024
_MAX_SLOTS = 3
_TILE = 128


# ---------------------------------------------------------------------------
# Public weights (the bin-public path)
# ---------------------------------------------------------------------------

class PublicWeightLimbs(typing.NamedTuple):
    """Cached operands of one PUBLIC (K, N) ring weight matrix."""

    w: torch.Tensor     # (K, N) int32 — public ring encoding
    wl: torch.Tensor    # (L, K, N) int8 — minimal balanced limbs
    n_limbs: int        # L ∈ {1..4}
    wt: torch.Tensor    # (L, Np, Kp) int8 — wl 128-padded, K-major

    @property
    def k(self) -> int:
        return self.w.shape[0]

    @property
    def n(self) -> int:
        return self.w.shape[1]


class PublicGroupedLimbs(typing.NamedTuple):
    """Cached operands of a PUBLIC (C, K, N) grouped (depthwise) weight."""

    w: torch.Tensor     # (C, K, N) int32 — public ring encoding
    wl: torch.Tensor    # (L, C, K, N) int8 — minimal balanced limbs
    n_limbs: int        # L ∈ {1..4}

    @property
    def channels(self) -> int:
        return self.w.shape[0]

    @property
    def k(self) -> int:
        return self.w.shape[1]

    @property
    def n(self) -> int:
        return self.w.shape[2]


def min_public_limbs(w_enc: torch.Tensor) -> int:
    """Minimal balanced-limb count of a PUBLIC int32 ring encoding: the
    index of its highest nonzero balanced limb, so dropping the trailing
    limbs is exact (32767 -> [-1, -128, 1, 0] needs 3).  Bounded public
    encodings need 1–3; a share (uniform mod 2^32) needs 4."""
    l4 = balanced_limbs(w_enc)
    n = N_LIMBS
    while n > 1 and not bool(l4[n - 1].any()):
        n -= 1
    return n


def _public_limbs(w_enc: torch.Tensor, n_limbs: int | None):
    w = w_enc.contiguous()
    if n_limbs is None:
        n_limbs = min_public_limbs(w)
    return w, balanced_limbs(w)[:n_limbs].contiguous(), n_limbs


def public_weight_limbs(w_enc: torch.Tensor,
                        n_limbs: int | None = None) -> PublicWeightLimbs:
    """Cache a public (K, N) int32 weight encoding once, at model setup;
    ``n_limbs`` defaults to the minimal exact count."""
    w, wl, n_limbs = _public_limbs(w_enc, n_limbs)
    k, n = w.shape
    padded = torch.nn.functional.pad(wl, (0, (-n) % _TILE, 0, (-k) % _TILE))
    return PublicWeightLimbs(w=w, wl=wl, n_limbs=n_limbs,
                             wt=padded.transpose(1, 2).contiguous())


def public_grouped_limbs(w_enc: torch.Tensor,
                         n_limbs: int | None = None) -> PublicGroupedLimbs:
    """Cache a public (C, K, N) int32 grouped weight encoding once."""
    return PublicGroupedLimbs(*_public_limbs(w_enc, n_limbs))


def bin_rss_matmul_ref(x_stack: torch.Tensor,
                       weights: PublicWeightLimbs) -> torch.Tensor:
    """Plain version: per-slot int32 matmuls on the public encoding,
    (S, M, K) -> (S, M, N) (CPU / meta only)."""
    return torch.matmul(x_stack, weights.w)


def bin_grouped_matmul_ref(x_stack: torch.Tensor,
                           weights: PublicGroupedLimbs) -> torch.Tensor:
    """Plain version: per-slot per-channel int32 batched matmuls,
    (S, C, M, K) -> (S, C, M, N) (CPU / meta only)."""
    return torch.matmul(x_stack, weights.w)


def _check_public(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"{name}: x must be int32")
    if w.dtype != torch.int32 or not w.is_contiguous() \
            or w.device != x.device:
        raise ValueError(f"{name}: the public weight must be a contiguous "
                         f"int32 tensor on {x.device}")
    if not 1 <= x.shape[0] <= _MAX_SLOTS:
        raise ValueError(f"{name}: {x.shape[0]} share slots; the kernel "
                         f"takes 1 to {_MAX_SLOTS}")


def _launch_bin(x_stack: torch.Tensor, weights: PublicWeightLimbs,
                cfg: KernelConfig | None = None) -> torch.Tensor:
    """Launch the kernel on the plan's route, split and width, or on
    ``cfg``'s (the autotuner and ``chip_smoke.py`` run and time the
    others)."""
    s, m, k = x_stack.shape
    n, n_limbs = weights.n, weights.n_limbs
    _check_public("bin_rss_matmul", x_stack, weights.w)
    if not x_stack.is_contiguous():
        raise ValueError("bin_rss_matmul: x must be contiguous")
    wt = weights.wt
    if wt.dtype != torch.int8 or not wt.is_contiguous() \
            or wt.device != x_stack.device or not 1 <= n_limbs <= N_LIMBS \
            or wt.ndim != 3 or wt.shape[0] != n_limbs \
            or wt.shape[1] % _TILE or wt.shape[2] % _TILE \
            or wt.shape[1] < n or wt.shape[2] < k:
        raise ValueError(f"bin_rss_matmul: wt must be the 128-padded "
                         f"K-major int8 limb cache ({n_limbs}, Np, Kp) of "
                         f"{(k, n)} on {x_stack.device}")
    out = torch.empty((s, m, n), dtype=torch.int32, device=x_stack.device)
    if out.numel() == 0:
        return out
    chosen, per, bn = resolve(cfg, s, m, k, n, sm_count(x_stack.device),
                              "bin_rss_matmul")
    fn = build.library("bin_rss_matmul")
    err = fn(x_stack.data_ptr(), weights.w.data_ptr(), wt.data_ptr(),
             out.data_ptr(), s, m, k, n, wt.shape[2], wt.shape[1], n_limbs,
             int(chosen == TENSOR_CORE), per, bn,
             build.stream_ptr(x_stack.device))
    build.check("bin_rss_matmul", err)
    build.LAUNCHES["bin_rss_matmul"] += 1
    return out


def bin_rss_matmul_parts(x_stack: torch.Tensor, weights: PublicWeightLimbs,
                         cfg: KernelConfig | None = None) -> torch.Tensor:
    """Every held slot's product with a public weight matrix,
    (S, M, K) -> (S, M, N) int32: a valid RSS stack of x @ W with no
    communication.  CUDA tensors launch the kernel (on ``cfg``'s choice if
    given) or raise; CPU and meta tensors run the plain version."""
    assert x_stack.shape[2] == weights.k, (x_stack.shape, weights.w.shape)
    if x_stack.device.type == "cuda":
        return _launch_bin(x_stack, weights, cfg)
    if x_stack.device.type in ("cpu", "meta"):
        return bin_rss_matmul_ref(x_stack, weights)
    raise ValueError(f"bin_rss_matmul: unsupported device {x_stack.device}")


def _launch_bin_grouped(x_stack: torch.Tensor,
                        weights: PublicGroupedLimbs) -> torch.Tensor:
    s, c, m, k = x_stack.shape
    n = weights.n
    _check_public("bin_grouped_matmul", x_stack, weights.w)
    if 4 * c * k * n > _SMEM_LIMIT:
        raise ValueError(f"bin_grouped_matmul: weight slab of {c}x{k}x{n} "
                         f"exceeds the kernel's shared-memory stage")
    # (S, M, C, N) buffer, returned as its (S, C, M, N) view
    buf = torch.empty((s, m, c, n), dtype=torch.int32, device=x_stack.device)
    out = buf.permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    fn = build.library("bin_grouped_matmul")
    err = fn(x_stack.data_ptr(), weights.w.data_ptr(), out.data_ptr(),
             s, c, m, k, n, *x_stack.stride(), *out.stride(),
             build.stream_ptr(x_stack.device))
    build.check("bin_grouped_matmul", err)
    build.LAUNCHES["bin_grouped_matmul"] += 1
    return out


def bin_grouped_matmul_parts(x_stack: torch.Tensor,
                             weights: PublicGroupedLimbs) -> torch.Tensor:
    """Every held slot's grouped product with a public depthwise kernel,
    (S, C, M, K) -> (S, C, M, N) int32, zero communication.  CUDA tensors
    launch the kernel (or raise); CPU and meta tensors run the plain
    version."""
    s, c, m, k = x_stack.shape
    assert (c, k) == (weights.channels, weights.k), \
        (x_stack.shape, weights.w.shape)
    if x_stack.device.type == "cuda":
        return _launch_bin_grouped(x_stack, weights)
    if x_stack.device.type in ("cpu", "meta"):
        return bin_grouped_matmul_ref(x_stack, weights)
    raise ValueError(f"bin_grouped_matmul: unsupported device "
                     f"{x_stack.device}")


# ---------------------------------------------------------------------------
# Shared weights, grouped (the depthwise half of the bin-shared path)
# ---------------------------------------------------------------------------

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
    return _grouped_cache(ws, ws + torch.roll(ws, -1, dims=0))


def pair_grouped_limbs(w_pair: torch.Tensor) -> GroupedWeightLimbs:
    """One party's cache from its pair [w_i, w_{i+1}] (2, C, K, N): the own
    slot alone (leading axis 1), wf_i = w_i + w_{i+1}, what the kernel's
    pair entry reads; the same words as slot i of the stacked cache."""
    ws = w_pair[0:1].contiguous()
    return _grouped_cache(ws, ws + w_pair[1:2])


def _grouped_cache(ws: torch.Tensor, wf: torch.Tensor) -> GroupedWeightLimbs:
    lim = lambda a: balanced_limbs(a).transpose(0, 1).contiguous()
    return GroupedWeightLimbs(ws=ws, wf=wf, wl=lim(ws), wfl=lim(wf))


def grouped_rss_matmul_ref(x_stack: torch.Tensor,
                           weights: GroupedWeightLimbs,
                           x_next_stack: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version: per-channel batched int32 matmuls on the cached
    fused operand, (S, C, M, K) -> (S, C, M, N) (CPU / meta only); the
    neighbour is ``x_next_stack`` or, stacked, the party-axis roll."""
    xn = (torch.roll(x_stack, -1, dims=0) if x_next_stack is None
          else x_next_stack)
    return torch.matmul(x_stack, weights.wf) + torch.matmul(xn, weights.ws)


# B2's two designs (the C entry point's modes): every share slot read once
# by one thread for all parties, or the first design, one party a grid row
ALL_PARTIES, PER_PARTY = "all-parties", "per-party"
_GROUPED_MODES = {ALL_PARTIES: 0, PER_PARTY: 1}


def _launch(x_stack: torch.Tensor, weights: GroupedWeightLimbs,
            design: str = ALL_PARTIES,
            x_next_stack: torch.Tensor | None = None) -> torch.Tensor:
    """Launch B2 (``design`` PER_PARTY: the first design, which
    ``chip_smoke.py`` times beside it; with ``x_next_stack`` the pair
    entry, whose neighbour rows share x's strides)."""
    s, c, m, k = x_stack.shape
    n = weights.n
    if x_stack.dtype != torch.int32:
        raise ValueError("grouped_rss_matmul: x must be int32")
    if x_next_stack is not None and (
            x_next_stack.dtype != torch.int32
            or x_next_stack.shape != x_stack.shape
            or x_next_stack.stride() != x_stack.stride()
            or x_next_stack.device != x_stack.device):
        raise ValueError("grouped_rss_matmul: x_next must be an int32 "
                         "tensor of x's shape and strides on x's device")
    for name, t in (("ws", weights.ws), ("wf", weights.wf)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != x_stack.device:
            raise ValueError(f"grouped_rss_matmul: {name} must be a "
                             f"contiguous int32 tensor on {x_stack.device}")
    if tuple(weights.ws.shape) != (s, c, k, n):
        raise ValueError(f"grouped_rss_matmul: weights "
                         f"{tuple(weights.ws.shape)} do not match x "
                         f"{tuple(x_stack.shape)}")
    slab, limit = ((8 * s * c * k * n, _SMEM_OPTIN) if design == ALL_PARTIES
                   else (8 * c * k * n, _SMEM_LIMIT))
    if slab > limit:
        raise ValueError(f"grouped_rss_matmul: weight slabs of "
                         f"{s}x{c}x{k}x{n} exceed the kernel's "
                         f"shared-memory stage")
    # (S, M, C, N) buffer, returned as its (S, C, M, N) view
    buf = torch.empty((s, m, c, n), dtype=torch.int32, device=x_stack.device)
    out = buf.permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    tail = (weights.wf.data_ptr(), weights.ws.data_ptr(), out.data_ptr(),
            s, c, m, k, n, *x_stack.stride(), *out.stride())
    if x_next_stack is None:
        name = "grouped_rss_matmul"
        err = build.library(name)(x_stack.data_ptr(), *tail,
                                  _GROUPED_MODES[design],
                                  build.stream_ptr(x_stack.device))
    else:
        name = "grouped_rss_matmul_pair"
        err = build.library(name)(x_stack.data_ptr(), x_next_stack.data_ptr(),
                                  *tail, build.stream_ptr(x_stack.device))
    build.check(name, err)
    build.LAUNCHES[name] += 1
    return out


def grouped_rss_matmul_parts(x_stack: torch.Tensor,
                             weights: GroupedWeightLimbs,
                             x_next_stack: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """All parties' additive grouped products, (S, C, M, K) ->
    (S, C, M, N) int32.  CUDA tensors launch the kernel (the pair entry
    with ``x_next_stack``) or raise; CPU and meta tensors run the plain
    version."""
    s, c, m, k = x_stack.shape
    assert (c, k) == (weights.channels, weights.k), \
        (x_stack.shape, weights.ws.shape)
    if x_stack.device.type == "cuda":
        return _launch(x_stack, weights, x_next_stack=x_next_stack)
    if x_stack.device.type in ("cpu", "meta"):
        return grouped_rss_matmul_ref(x_stack, weights, x_next_stack)
    raise ValueError(f"grouped_rss_matmul: unsupported device "
                     f"{x_stack.device}")
