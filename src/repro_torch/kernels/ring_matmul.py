"""One ring product C = A·B mod 2^32: wrapper and plain version.

Port of ``repro/kernels/ring_matmul.py`` (``ring_matmul``) and of its
oracle ``repro/kernels/ref.py::ring_matmul_ref``.  It is the per-dot
route of the linear protocols (``dot=kernels.ops.rss_matmul_dot``): each
per-party product of a secure layer is one call.

On a CUDA tensor :func:`ring_matmul` launches the hand-written kernel
``csrc/ring_matmul.cu`` (it replaces the TPU kernel
``repro/kernels/ring_matmul.py::_ring_matmul_kernel``) or raises; on a
CPU (or ``meta``) tensor it runs the plain version, an int32 matmul that
wraps mod 2^32.  torch has no integer matmul on CUDA, so the plain version
is CPU-only.
"""
from __future__ import annotations

import torch

from . import build

__all__ = ["ring_matmul", "ring_matmul_ref"]


def ring_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) x (K, N) int32 -> (M, N) int32, mod 2^32."""
    return torch.matmul(a, b)


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                    a_dtype: torch.dtype, b_dtype: torch.dtype) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not multiply")
    for what, t, dt in (("a", a, a_dtype), ("b", b, b_dtype)):
        if t.dtype != dt or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name}: {what} must be a contiguous {dt} "
                             f"tensor on {a.device}")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.Tensor:
    """Launch the 2-D product kernel ``name`` (this module's and
    binary_matmul.py's): (M, K) x (K, N) -> (M, N) int32 words."""
    _check_operands(name, a, b, a_dtype, b_dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.library(name)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
             build.stream_ptr(a.device))
    build.check(name, err)
    build.LAUNCHES[name] += 1
    return out


def _route(name: str, a: torch.Tensor, b: torch.Tensor, a_dtype: torch.dtype,
           b_dtype: torch.dtype, plain) -> torch.Tensor:
    """CUDA tensors launch the kernel at every shape (or raise); CPU and
    meta tensors run the plain version."""
    if a.device.type == "cuda":
        return _launch(name, a, b, a_dtype, b_dtype)
    if a.device.type in ("cpu", "meta"):
        return plain(a, b)
    raise ValueError(f"{name}: unsupported device {a.device}")


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B mod 2^32, (M, K) x (K, N) int32 ring words."""
    return _route("ring_matmul", a, b, torch.int32, torch.int32,
                  ring_matmul_ref)
