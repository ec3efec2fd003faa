"""Binarized products: ring activations times int8 weights, and the
plaintext BNN layer (int8 times int8).  Wrappers and plain versions.

Port of ``repro/kernels/binary_matmul.py`` (``binary_weight_matmul``,
``binary_binary_matmul``) and of their oracles in
``repro/kernels/ref.py``:

* :func:`binary_weight_matmul`: C = A·W mod 2^32, A (M, K) ring words, W
  (K, N) int8 (±1 or {0, 1} in the reference's use; any int8 is exact).
  On a CUDA tensor it launches ``csrc/binary_matmul.cu``'s
  ``bin_weight_matmul`` (replaces the TPU kernel ``_bin_matmul_kernel``)
  on the route of :func:`~.limbs.limb_mma_plan` at one slot: at K > 16 a
  pass writes W as one K-major 128-padded int8 plane
  (:func:`binary_weight_t_ref` is its plain version; an int8 weight is its
  own single balanced limb) and ``limb_mma.cuh`` multiplies it on the
  int8 tensor cores with L = 1; at K <= 16 the CUDA cores multiply the
  words by the sign-extended weight.
* :func:`binary_binary_matmul`: C = A·W in int32 with wraparound, A and W
  int8.  On a CUDA tensor it launches ``csrc/binary_matmul.cu``'s
  ``bin_bin_matmul`` (replaces the TPU kernel ``_bb_kernel``).

Either raises on a CUDA tensor the kernel refuses; CPU and ``meta``
tensors run the plain versions (int32 matmuls; torch has no integer
matmul on CUDA).
"""
from __future__ import annotations

import torch

from .ring_matmul import _TILE, _launch_limbs, _route, _weight_pass

__all__ = ["binary_weight_matmul", "binary_weight_matmul_ref",
           "binary_weight_t_ref", "binary_weight_t",
           "binary_binary_matmul", "binary_binary_matmul_ref"]


def binary_weight_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 (M, K) x int8 (K, N) -> int32, mod 2^32 (the
    int8 weight sign-extends, the bits of the reference's uint32 cast)."""
    return torch.matmul(a, w.to(torch.int32))


def binary_weight_t_ref(w: torch.Tensor) -> torch.Tensor:
    """Plain version of B6's weight pass: (K, N) int8 -> (Np, Kp) int8,
    w.T zero-padded to multiples of 128 (the one K-major limb plane the
    tensor-core route reads)."""
    k, n = w.shape
    return torch.nn.functional.pad(
        w.T, (0, (-k) % _TILE, 0, (-n) % _TILE)).contiguous()


def binary_weight_t(w: torch.Tensor) -> torch.Tensor:
    """B6's weight pass alone on the card: (K, N) int8 -> (Np, Kp) int8
    (tests and ``chip_smoke.py`` hold it to :func:`binary_weight_t_ref`)."""
    return _weight_pass("bin_weight_matmul", w, torch.int8, 1)[0]


def _launch_bin_weight(a: torch.Tensor, w: torch.Tensor,
                       route: str | None = None) -> torch.Tensor:
    """Launch B6 on the route of the plan (``route`` forces one)."""
    return _launch_limbs("bin_weight_matmul", a, w, torch.int8, 1, route)


def binary_binary_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: int8 (M, K) x int8 (K, N) -> int32."""
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


def binary_weight_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A (int32 ring words) @ W (int8) mod 2^32, (M, K) x (K, N)."""
    if a.device.type == "cuda":
        return _launch_bin_weight(a, w)
    return _route("bin_weight_matmul", a, w, torch.int32, torch.int8,
                  binary_weight_matmul_ref)


def binary_binary_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plaintext BNN layer: int8 (M, K) @ int8 (K, N) -> int32."""
    return _route("bin_bin_matmul", a, w, torch.int8, torch.int8,
                  binary_binary_matmul_ref)
