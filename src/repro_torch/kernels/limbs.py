"""Balanced int8 limb decomposition of ring words.

Port of ``repro/kernels/limbs.py::balanced_limbs``, bit-exact including the
carry boundary (32767 -> [-1, -128, 1, 0]).  The CUDA kernels of this
package multiply 32-bit words directly; the limbs are kept for the weight
caches (``WeightLimbs`` / ``GroupedWeightLimbs`` and the public
``PublicWeightLimbs`` / ``PublicGroupedLimbs``) that an int8 tensor-core
kernel will read, and give the public weights' adaptive limb count.
"""
from __future__ import annotations

import torch

__all__ = ["N_LIMBS", "balanced_limbs"]

N_LIMBS = 4


def balanced_limbs(x: torch.Tensor) -> torch.Tensor:
    """int32 ring words (...) -> int8 (4, ...) with
    x ≡ Σ limb_p · 2^{8p} (mod 2^32), every limb in [-128, 127]."""
    limbs = []
    cur = x.to(torch.int32)
    for _ in range(N_LIMBS):
        lo = cur & 0xFF
        carry = (lo >= 128).to(torch.int32)
        limbs.append((lo - 256 * carry).to(torch.int8))
        cur = ((cur >> 8) & 0xFFFFFF) + carry   # logical shift
    return torch.stack(limbs)
