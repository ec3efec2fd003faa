"""Maxpooling protocols (paper §3.6).

Port of ``repro/core/pooling.py`` (``_gated_relu``, ``_window_split``,
``sign_maxpool_fused``, ``secure_maxpool``, ``secure_max_lastdim``).
After a Sign layer the window holds {0,1} bits: max == OR ==
[window sum − 1 ≥ 0], one MSB extraction per window.  After any other
layer (ReLU nets) the general maxpool is a pairwise-max tournament,
max(a, b) = b + ReLU(a − b), log2(window) levels of MSB + select.
"""
from __future__ import annotations

import torch

from .activation import (relu_from_msb, relu_from_msb_arith, sign_from_msb,
                         sign_from_msb_arith)
from .linear import fused_rounds
from .msb import DEFAULT_BOUND_BITS, msb_extract, msb_extract_arith
from .randomness import Parties
from .rss import RSS

__all__ = ["sign_maxpool_fused", "secure_maxpool", "secure_max_lastdim"]


def _gated_relu(diff: RSS, parties: Parties, bound_bits: int, tag: str):
    """ReLU(diff) for the pairwise-max tournaments: the one-round
    arithmetic-MSB gate with fused rounds, Alg 3 + Alg 5 without."""
    if fused_rounds():
        _, msb_a = msb_extract_arith(diff, parties, bound_bits=bound_bits,
                                     tag=tag + ".msb")
        return relu_from_msb_arith(diff, msb_a, parties, tag=tag + ".sel")
    msb = msb_extract(diff, parties, bound_bits=bound_bits, tag=tag + ".msb")
    return relu_from_msb(diff, msb, parties, tag=tag + ".sel")


def _window_split(x: RSS, pool: int):
    """(B, H, W, C) -> list of pool*pool RSS slices aligned per window."""
    b, h, w, c = x.shape
    assert h % pool == 0 and w % pool == 0
    slots = x.shares.shape[0]
    sh = x.shares.reshape(slots, b, h // pool, pool, w // pool, pool, c)
    return [RSS(sh[:, :, :, i, :, j, :], x.ring)
            for i in range(pool) for j in range(pool)]


def sign_maxpool_fused(sign_bits: RSS, parties: Parties, pool: int = 2,
                       tag: str = "signmax") -> RSS:
    """out = 1 ⊕ MSB(Σ_window bits − 1), one MSB extraction per window."""
    parts = _window_split(sign_bits, pool)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    acc = acc.add_public(-1)
    # window sums are tiny integers: tight bound, most headroom for the mask
    if fused_rounds():
        _, msb_a = msb_extract_arith(acc, parties, bound_bits=4,
                                     tag=tag + ".msb")
        return sign_from_msb_arith(msb_a)
    msb = msb_extract(acc, parties, bound_bits=4, tag=tag + ".msb")
    return sign_from_msb(msb, parties, acc.ring, tag=tag + ".sign")


def secure_maxpool(x: RSS, parties: Parties, pool: int = 2,
                   bound_bits: int = DEFAULT_BOUND_BITS,
                   tag: str = "maxpool") -> RSS:
    """General maxpool by pairwise-max tournament over each window."""
    parts = _window_split(x, pool)
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            nxt.append(b + _gated_relu(a - b, parties, bound_bits, tag))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def secure_max_lastdim(x: RSS, parties: Parties,
                       bound_bits: int = DEFAULT_BOUND_BITS,
                       tag: str = "max") -> RSS:
    """Max over the last dim: log2(n) tournament levels, each one batched
    MSB + select; an odd width carries its last element to the next
    level."""
    n = int(x.shape[-1])
    cur = x
    while n > 1:
        half = n // 2
        a = cur[..., :half]
        b = cur[..., half:2 * half]
        m = b + _gated_relu(a - b, parties, bound_bits, tag)
        if n % 2:
            m = RSS(torch.cat([m.shares, cur[..., 2 * half:].shares],
                              dim=-1), x.ring)
            n = half + 1
        else:
            n = half
        cur = m
    return cur
