"""Replicated secret sharing (2-out-of-3) over Z_{2^l}.

Port of ``repro/core/rss.py`` (``RSS``, ``BinRSS``, ``share``,
``reconstruct``, ``share_bits``, ``reconstruct_bits``,
``zeros_like_shares``, ``public_rss``).  The three additive shares are
stacked on a leading axis of size 3 (``shares[i]`` is x_i, party P_i's
view is ``(x_i, x_{i+1})``), as int32 (int64 for RING64) for arithmetic
shares and uint8 {0, 1} for XOR shares.  Only the stacked single-program
layout (``LocalTransport``) exists in the port so far, so
party-conditional adds touch slot 0 directly.
"""
from __future__ import annotations

import dataclasses

import torch

from . import prf
from .ring import RingSpec, default_ring, signed

__all__ = ["RSS", "BinRSS", "share", "reconstruct", "share_bits",
           "reconstruct_bits", "zeros_like_shares", "public_rss", "PARTIES"]

PARTIES = 3


def _as_ring(c, ring: RingSpec, device) -> torch.Tensor:
    """A public constant as a ring tensor: ints wrap, floats encode."""
    if isinstance(c, int):
        return torch.tensor(signed(c, ring.bits), dtype=ring.dtype,
                            device=device)
    c = torch.as_tensor(c, device=device)
    if c.is_floating_point():
        return ring.encode(c)
    return ring.wrap(c)


def _add_slot0(stack: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """stack + c on share slot 0 only (the reference's party-0 mask)."""
    return torch.cat([(stack[0] + c)[None], stack[1:]])


@dataclasses.dataclass
class RSS:
    """Arithmetic replicated secret shares of a tensor over Z_{2^l}."""

    shares: torch.Tensor  # (3, *shape) int32 (int64 for RING64)
    ring: RingSpec = dataclasses.field(default_factory=default_ring)

    @property
    def shape(self):
        return tuple(self.shares.shape[1:])

    @property
    def dtype(self):
        return self.shares.dtype

    @property
    def ndim(self):
        return self.shares.ndim - 1

    @property
    def device(self):
        return self.shares.device

    def party_view(self, i: int):
        return self.shares[i], self.shares[(i + 1) % PARTIES]

    def __add__(self, other):
        if isinstance(other, RSS):
            return RSS(self.shares + other.shares, self.ring)
        return self.add_public(other)

    def __sub__(self, other):
        if isinstance(other, RSS):
            return RSS(self.shares - other.shares, self.ring)
        return self.add_public(-_as_ring(other, self.ring, self.device))

    def __rsub__(self, other):
        return (-self).add_public(other)

    def __neg__(self):
        return RSS(-self.shares, self.ring)

    def add_public(self, c):
        """x + c for public c: party 0's slot adds, the others keep."""
        c = _as_ring(c, self.ring, self.device)
        return RSS(_add_slot0(self.shares, c), self.ring)

    def mul_public_int(self, c):
        """x * c for a public integer c (no truncation needed)."""
        c = _as_ring(c, self.ring, self.device)
        return RSS(self.shares * c, self.ring)

    def reshape(self, *shape):
        return RSS(self.shares.reshape((self.shares.shape[0],) + tuple(shape)),
                   self.ring)

    def transpose(self, axes):
        axes = (0,) + tuple(a + 1 for a in axes)
        return RSS(self.shares.permute(axes), self.ring)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return RSS(self.shares[(slice(None),) + idx], self.ring)

    def sum(self, axis, keepdims=False):
        axis = axis if axis >= 0 else self.ndim + axis
        total = self.shares.sum(dim=axis + 1, keepdim=keepdims)
        return RSS(self.ring.wrap(total), self.ring)


@dataclasses.dataclass
class BinRSS:
    """Binary (XOR) replicated secret shares of bits, values in {0, 1}."""

    shares: torch.Tensor  # (3, *shape) uint8

    @property
    def shape(self):
        return tuple(self.shares.shape[1:])

    def party_view(self, i: int):
        return self.shares[i], self.shares[(i + 1) % PARTIES]

    def __xor__(self, other):
        if isinstance(other, BinRSS):
            return BinRSS(self.shares ^ other.shares)
        b = torch.as_tensor(other, dtype=torch.uint8,
                            device=self.shares.device)
        return BinRSS(torch.cat([(self.shares[0] ^ b)[None],
                                 self.shares[1:]]))

    def not_(self):
        return self ^ 1


def share(x, key: prf.Key, ring: RingSpec | None = None,
          encoded: bool = False) -> RSS:
    """Secret-share a tensor; ``x`` is float (fixed-point encoded here)
    unless ``encoded=True`` (already ring words)."""
    ring = ring or default_ring()
    v = torch.as_tensor(x)
    v = ring.wrap(v) if encoded else ring.encode(v)
    x01 = prf.ring_bits(prf.split(key), v.shape, ring.bits, device=v.device)
    x2 = v - x01[0] - x01[1]
    return RSS(torch.cat([x01, x2[None]]), ring)


def reconstruct(x: RSS, decode: bool = True):
    """Open shares (test helper; protocols that reveal account for it)."""
    total = x.shares[0] + x.shares[1] + x.shares[2]
    return x.ring.decode(total) if decode else total


def share_bits(bits, key: prf.Key) -> BinRSS:
    """XOR-share a {0, 1} bit tensor."""
    b = torch.as_tensor(bits).to(torch.uint8)
    b01 = prf.bits_multi(prf.split(key), b.shape, torch.uint8,
                         device=b.device) & 1
    return BinRSS(torch.cat([b01, (b ^ b01[0] ^ b01[1])[None]]))


def reconstruct_bits(x: BinRSS) -> torch.Tensor:
    return x.shares[0] ^ x.shares[1] ^ x.shares[2]


def zeros_like_shares(x: RSS) -> RSS:
    return RSS(torch.zeros_like(x.shares), x.ring)


def public_rss(c, shape, ring: RingSpec | None = None,
               device=None) -> RSS:
    """Deterministic RSS of a public value: x_0 = c, x_1 = x_2 = 0."""
    ring = ring or default_ring()
    c = _as_ring(c, ring, device)
    sh = torch.zeros((PARTIES,) + tuple(shape), dtype=ring.dtype,
                     device=device)
    return RSS(_add_slot0(sh, c), ring)
