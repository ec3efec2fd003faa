"""Ring Z_{2^32} arithmetic and fixed-point encoding on ``torch.int32``.

Port of ``repro/core/ring.py`` (``RingSpec``, ``RING32``).  The reference
stores ring elements as ``uint32``; this torch has no ``uint32`` add, shift
or matmul, so the port stores them as ``int32``: two's-complement wrap is
the same arithmetic mod 2^32, and ``ring_to_numpy`` (weights.py) views the
bits back as ``uint32``.  ``>>`` on ``int32`` is arithmetic, so the port
adds :func:`shr`, the logical shift the reference gets from unsigned types.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RingSpec", "RING32", "default_ring", "shr", "signed32"]

_MASK32 = 0xFFFFFFFF


def signed32(v: int) -> int:
    """A Python int mod 2^32 as the int32 value with the same bits."""
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words: ``(x >> s) & mask``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Static description of the ring Z_{2^bits} (32-bit only in the port).

    frac=12 as in the reference: the exact truncation is wrap-free for
    post-product magnitudes < 2^{l-2-2f} = 64."""

    bits: int = 32
    frac: int = 12

    def __post_init__(self):
        if self.bits != 32:
            raise ValueError(f"the port supports the 32-bit ring only, "
                             f"got {self.bits}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32

    @property
    def nbytes(self) -> int:
        return self.bits // 8

    @property
    def scale(self) -> int:
        return 1 << self.frac

    def wrap(self, x) -> torch.Tensor:
        """Any integer tensor into the ring (mod 2^32, int32 storage)."""
        if isinstance(x, int):
            return torch.tensor(signed32(x), dtype=torch.int32)
        if x.dtype == torch.int64:
            x = ((x & _MASK32) ^ (1 << 31)) - (1 << 31)
        return x.to(torch.int32)

    def to_signed(self, u: torch.Tensor) -> torch.Tensor:
        """Signed reading of a ring element: the storage already is."""
        return u

    def encode(self, x) -> torch.Tensor:
        """float -> ring fixed point; float32 round, half to even as in
        ``jnp.round``."""
        x = torch.as_tensor(x, dtype=torch.float32)
        return torch.round(x * self.scale).to(torch.int32)

    def decode(self, u: torch.Tensor) -> torch.Tensor:
        return u.to(torch.float32) / self.scale

    def msb(self, u: torch.Tensor) -> torch.Tensor:
        """Plaintext most-significant bit (1 iff the signed value < 0)."""
        return shr(u, self.bits - 1).to(torch.uint8)


RING32 = RingSpec(bits=32, frac=12)


def default_ring() -> RingSpec:
    return RING32
