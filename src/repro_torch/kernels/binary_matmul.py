"""Binarized products: ring activations times int8 weights, and the
plaintext BNN layer (int8 times int8).  Wrappers and plain versions.

Port of ``repro/kernels/binary_matmul.py`` (``binary_weight_matmul``,
``binary_binary_matmul``) and of their oracles in
``repro/kernels/ref.py``:

* :func:`binary_weight_matmul`: C = A·W mod 2^32, A (M, K) ring words, W
  (K, N) int8 (±1 or {0, 1} in the reference's use; any int8 is exact).
  On a CUDA tensor it launches ``csrc/binary_matmul.cu``'s
  ``bin_weight_matmul`` (replaces the TPU kernel ``_bin_matmul_kernel``).
* :func:`binary_binary_matmul`: C = A·W in int32 with wraparound, A and W
  int8.  On a CUDA tensor it launches ``csrc/binary_matmul.cu``'s
  ``bin_bin_matmul`` (replaces the TPU kernel ``_bb_kernel``).

Either raises on a CUDA tensor the kernel refuses; CPU and ``meta``
tensors run the plain versions (int32 matmuls; torch has no integer
matmul on CUDA).
"""
from __future__ import annotations

import torch

from . import build
from .ring_matmul import _route

__all__ = ["binary_weight_matmul", "binary_weight_matmul_ref",
           "binary_binary_matmul", "binary_binary_matmul_ref"]


def binary_weight_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 (M, K) x int8 (K, N) -> int32, mod 2^32 (the
    int8 weight sign-extends, the bits of the reference's uint32 cast)."""
    return torch.matmul(a, w.to(torch.int32))


def binary_binary_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: int8 (M, K) x int8 (K, N) -> int32."""
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


def binary_weight_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A (int32 ring words) @ W (int8) mod 2^32, (M, K) x (K, N)."""
    return _route("bin_weight_matmul", a, w, torch.int32, torch.int8,
                  binary_weight_matmul_ref)


def binary_binary_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plaintext BNN layer: int8 (M, K) @ int8 (K, N) -> int32."""
    return _route("bin_bin_matmul", a, w, torch.int8, torch.int8,
                  binary_binary_matmul_ref)
