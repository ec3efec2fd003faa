"""Ring Z_{2^l} arithmetic and fixed-point encoding on signed storage.

Port of ``repro/core/ring.py`` (``RingSpec``, ``RING32``, ``RING64``).  The
reference stores ring elements as ``uint32`` / ``uint64``; this torch has
no unsigned add, shift or matmul at those widths, so the port stores them
as ``int32`` / ``int64``: two's-complement wrap is the same arithmetic mod
2^l, and ``ring_to_numpy`` (weights.py) views the bits back as unsigned.
``>>`` on signed storage is arithmetic, so the port adds :func:`shr`, the
logical shift the reference gets from unsigned types, masked for either
width.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RingSpec", "RING32", "RING64", "default_ring", "shr", "signed"]

_MASK32 = 0xFFFFFFFF
_DTYPES = {32: torch.int32, 64: torch.int64}


def signed(v: int, bits: int = 32) -> int:
    """A Python int mod 2^bits as the signed value with the same bits."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 / int64 words: ``(x >> s) & mask``."""
    if s == 0:
        return x
    bits = 64 if x.dtype == torch.int64 else 32
    return (x >> s) & ((1 << (bits - s)) - 1)


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Static description of the ring Z_{2^bits}, bits 32 or 64.

    frac=12 as in the reference: the exact truncation is wrap-free for
    post-product magnitudes < 2^{l-2-2f} = 64.  The CUDA kernels take
    32-bit words only; RING64 runs the plain products (CPU tensors)."""

    bits: int = 32
    frac: int = 12

    def __post_init__(self):
        if self.bits not in _DTYPES:
            raise ValueError(f"the port supports 32- and 64-bit rings, "
                             f"got {self.bits}")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.bits]

    @property
    def float_dtype(self) -> torch.dtype:
        """The encoding's float width: float64 above 32 bits, as the
        reference's ``encode`` / ``decode``."""
        return torch.float64 if self.bits > 32 else torch.float32

    @property
    def nbytes(self) -> int:
        return self.bits // 8

    @property
    def scale(self) -> int:
        return 1 << self.frac

    @property
    def modulus(self) -> int:
        return 1 << self.bits

    def half(self) -> int:
        """2^{l-1}, the signed/unsigned boundary."""
        return 1 << (self.bits - 1)

    def wrap(self, x) -> torch.Tensor:
        """Any integer tensor into the ring (mod 2^bits, signed storage)."""
        if isinstance(x, int):
            return torch.tensor(signed(x, self.bits), dtype=self.dtype)
        if self.bits == 32 and x.dtype == torch.int64:
            x = ((x & _MASK32) ^ (1 << 31)) - (1 << 31)
        return x.to(self.dtype)

    def to_signed(self, u: torch.Tensor) -> torch.Tensor:
        """Signed reading of a ring element: the storage already is."""
        return u

    def encode(self, x) -> torch.Tensor:
        """float -> ring fixed point; rounds half to even as ``jnp.round``,
        in float32 (float64 for RING64)."""
        x = torch.as_tensor(x).to(self.float_dtype)
        return torch.round(x * self.scale).to(self.dtype)

    def encode_int(self, x) -> torch.Tensor:
        """integer -> ring element (no fixed-point scaling)."""
        return self.wrap(torch.as_tensor(x).to(torch.int64))

    def decode(self, u: torch.Tensor) -> torch.Tensor:
        return u.to(self.float_dtype) / self.scale

    def msb(self, u: torch.Tensor) -> torch.Tensor:
        """Plaintext most-significant bit (1 iff the signed value < 0)."""
        return shr(u, self.bits - 1).to(torch.uint8)


RING32 = RingSpec(bits=32, frac=12)
RING64 = RingSpec(bits=64, frac=20)


def default_ring() -> RingSpec:
    return RING32
