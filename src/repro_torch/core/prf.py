"""Bit-exact threefry2x32 with ``jax.random``'s key semantics.

The protocol PRF of the reference (``repro/core/randomness.py::_prf_bits``,
``repro/core/rss.py::share``) is ``jax.random`` with the default
threefry2x32 implementation and ``jax_threefry_partitionable=True``.  Every
share, truncation pad, MSB mask and OT mask comes from it, so the port
reproduces it bit for bit:

* a key is the pair of uint32 words ``(k1, k2)``, held here as a tuple of
  Python ints (keys are scalars: their derivation runs on the host);
* ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)`` of the int32 seed;
* ``fold_in(key, d)`` = ``threefry(key, (0, d))`` and
  ``split(key, n)[i]`` = ``threefry(key, (0, i))`` (partitionable split);
* ``bits(key, shape)`` hashes the per-element 64-bit row-major counter
  ``(hi, lo)`` and returns ``bits1 ^ bits2``; the uint8 draw keeps the low
  8 bits of that word;
* a 64-bit ring word is built as the reference builds it
  (``randomness.py:30``, ``rss.py:174``): the low word is ``bits(k)``, the
  high word ``bits(fold_in(k, 1))`` (:func:`ring_bits`).

Tensor arithmetic is int32 (adds wrap mod 2^32); rotations use masked
logical shifts because ``>>`` on int32 is arithmetic.  ``bits_multi``
draws several keys in one batched evaluation (the three parties' PRF
streams of one protocol step).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .ring import signed

__all__ = ["Key", "PRNGKey", "split", "fold_in", "bits", "bits_multi",
           "ring_bits", "threefry2x32"]

Key = tuple[int, int]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _schedule(k1: int, k2: int):
    """Key injections after each of the 5 groups of 4 rounds: the
    (x0, x1) addends, as uint32 Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    return [(ks[(g + 1) % 3], (ks[(g + 2) % 3] + g + 1) & _M)
            for g in range(5)]


def _rotl_int(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The threefry2x32 block on one counter pair (host ints)."""
    k1, k2 = key
    x0 = (x0 + k1) & _M
    x1 = (x1 + k2) & _M
    for g, (a0, a1) in enumerate(_schedule(k1, k2)):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl_int(x1, r) ^ x0
        x0 = (x0 + a0) & _M
        x1 = (x1 + a1) & _M
    return x0, x1


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return (v << r) | ((v >> (32 - r)) & ((1 << r) - 1))


def _threefry_tensor(keys: Sequence[Key], lo: torch.Tensor) -> torch.Tensor:
    """threefry2x32 of the counters ``(0, lo)`` under each key.
    Returns ``bits1 ^ bits2`` as int32 of shape (len(keys), lo.numel())."""
    # every per-key constant in one table, one host-to-device copy (a copy
    # from pageable memory waits for the stream): the two key words, then
    # each group's two injections
    table = torch.tensor(
        [[signed(v) for v in (k1, k2, *(w for pair in _schedule(k1, k2)
                                         for w in pair))]
         for k1, k2 in keys], dtype=torch.int32, device=lo.device)

    def col(j):
        return table[:, j:j + 1]

    x0 = col(0).expand(len(keys), lo.numel())
    x1 = lo.reshape(1, -1) + col(1)
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + col(2 + 2 * g)
        x1 = x1 + col(3 + 2 * g)
    return x0 ^ x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey`` of a 32-bit seed."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 31):
        raise OverflowError(f"seed {seed} is outside the int32 range")
    return (0, s & _M)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, int(data) & _M)


def split(key: Key, num: int = 2) -> list[Key]:
    return [threefry2x32(key, 0, i) for i in range(num)]


def bits_multi(keys: Sequence[Key], shape, dtype: torch.dtype = torch.int32,
               device=None) -> torch.Tensor:
    """``jnp.stack([jax.random.bits(k, shape, uint32 | uint8) for k in
    keys])`` in one evaluation; uint32 words come back as int32."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= (1 << 31):
        raise ValueError(f"draw of {n} words exceeds the int32 counter")
    if torch.device(device or "cpu").type == "meta":   # shape-only run
        return torch.empty((len(keys),) + shape, dtype=dtype, device="meta")
    lo = torch.arange(n, dtype=torch.int32, device=device)
    out = _threefry_tensor(keys, lo).reshape((len(keys),) + shape)
    if dtype == torch.uint8:
        return (out & 0xFF).to(torch.uint8)
    if dtype != torch.int32:
        raise TypeError(f"bits of dtype {dtype} are not supported")
    return out


def bits(key: Key, shape, dtype: torch.dtype = torch.int32,
         device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32 | uint8)``."""
    return bits_multi([key], shape, dtype, device)[0]


def ring_bits(keys: Sequence[Key], shape, width: int = 32,
              device=None) -> torch.Tensor:
    """Stacked uniform ring words over ``keys``: int32 words at width 32;
    at width 64 int64 words ``bits(k) | bits(fold_in(k, 1)) << 32``, the
    reference's widening of 32-bit draws."""
    lo = bits_multi(keys, shape, device=device)
    if width == 32:
        return lo
    if width != 64:
        raise ValueError(f"ring width {width} is not 32 or 64")
    hi = bits_multi([fold_in(k, 1) for k in keys], shape, device=device)
    return (lo.to(torch.int64) & 0xFFFFFFFF) | (hi.to(torch.int64) << 32)
